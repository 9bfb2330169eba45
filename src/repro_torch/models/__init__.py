"""Model zoo of the port: every architecture of the reference (layers,
attention, MLA and whisper's cross-attention, the Mamba2 SSD mixer
:mod:`.ssm`, the RG-LRU block :mod:`.rglru`, the mixture-of-experts FFN
:mod:`.moe`, stacked blocks, the encoder-decoder and early-fusion
frontend stubs, the serving and training API), analytic parameter counts
(:mod:`.counting`) and the paper's CIFAR networks (:mod:`.cnn`)."""
from .model import (DecodeCache, decode_step, forward, init_cache,
                    init_params, loss_fn, prefill, prefill_resume,
                    slice_slot, splice_slot)

__all__ = ["DecodeCache", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "prefill_resume",
           "slice_slot", "splice_slot"]
