"""Model zoo of the port: the dense decoder path (layers, attention,
stacked blocks, the serving and training API) and the paper's CIFAR networks
(:mod:`.cnn`).  Other families come later."""
from .model import (DecodeCache, decode_step, forward, init_cache,
                    init_params, loss_fn, prefill, prefill_resume,
                    slice_slot, splice_slot)

__all__ = ["DecodeCache", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "prefill_resume",
           "slice_slot", "splice_slot"]
