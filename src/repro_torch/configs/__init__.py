"""Config registry.  This slice of the port carries olmo-1b, the main
path's configuration; the reference's other configs are pure data and
come with the model families that run them."""
from . import olmo_1b
from .base import ArchConfig, get_config, register

ALL_ARCHS = ("olmo-1b",)

__all__ = ["ArchConfig", "get_config", "register", "ALL_ARCHS"]
