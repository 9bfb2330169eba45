"""Deterministic synthetic data of the port (:mod:`.pipeline`)."""
from .pipeline import (DataConfig, Prefetcher, cifar_batch, lm_batch,
                       make_batch)

__all__ = ["DataConfig", "Prefetcher", "cifar_batch", "lm_batch",
           "make_batch"]
