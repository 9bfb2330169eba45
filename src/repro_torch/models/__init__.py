"""Model zoo of the port: the decoder families (layers, attention and
MLA, the Mamba2 SSD mixer :mod:`.ssm`, the RG-LRU block :mod:`.rglru`,
the mixture-of-experts FFN :mod:`.moe`, stacked blocks, the serving and
training API) and the paper's CIFAR networks (:mod:`.cnn`).
Encoder-decoder and frontend models come later."""
from .model import (DecodeCache, decode_step, forward, init_cache,
                    init_params, loss_fn, prefill, prefill_resume,
                    slice_slot, splice_slot)

__all__ = ["DecodeCache", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "prefill_resume",
           "slice_slot", "splice_slot"]
