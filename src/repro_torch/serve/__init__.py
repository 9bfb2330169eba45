"""Serving: the batched engine, the slot-level continuous batcher
(the reference baseline) and the block-table paged scheduler."""
from .engine import ContinuousBatcher, Engine, ServeConfig
from .host import host_sync
from .kv import (BlockAllocator, PagedCache, PagedLayout, build_layout,
                 gather_cache, init_paged_cache, paged_cache_specs,
                 scatter_decode, splice_request)
from .scheduler import PagedScheduler

__all__ = [
    "ContinuousBatcher", "Engine", "ServeConfig", "host_sync",
    "BlockAllocator", "PagedCache", "PagedLayout", "build_layout",
    "gather_cache", "init_paged_cache", "paged_cache_specs",
    "scatter_decode", "splice_request",
    "PagedScheduler",
]
