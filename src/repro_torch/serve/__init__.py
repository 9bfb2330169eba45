"""Serving: the batched engine and the slot-level continuous batcher
(the paged scheduler comes in a later slice)."""
from .engine import ContinuousBatcher, Engine, ServeConfig
from .host import host_sync

__all__ = ["ContinuousBatcher", "Engine", "ServeConfig", "host_sync"]
