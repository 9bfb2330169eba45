"""Serving: the batched engine (the continuous batcher and paged
scheduler come in later slices)."""
from .engine import Engine, ServeConfig
from .host import host_sync

__all__ = ["Engine", "ServeConfig", "host_sync"]
