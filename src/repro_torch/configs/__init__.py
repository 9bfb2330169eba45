"""Config registry.  This port carries olmo-1b, the serving path's
configuration, and the paper's two CIFAR-10 networks; the reference's
other configs are pure data and come with the model families that run
them."""
from . import olmo_1b
from .base import ArchConfig, get_config, register
from .cifar_nets import NETWORK_A, NETWORK_B, CnnConfig, CnnLayer

ALL_ARCHS = ("olmo-1b",)

__all__ = ["ArchConfig", "get_config", "register", "ALL_ARCHS",
           "CnnConfig", "CnnLayer", "NETWORK_A", "NETWORK_B"]
