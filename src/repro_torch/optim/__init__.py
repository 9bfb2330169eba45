"""Training-side pieces of the port: AdamW (:mod:`.adamw`), gradient
compression with error feedback (:mod:`.compression`) and the
quantization- and noise-aware-training pieces (:mod:`.qat`)."""
from .adamw import AdamWConfig, OptState, apply_updates, init_opt_state
from .compression import (CompressionConfig, compress_decompress,
                          init_error_state)
from .qat import calibrate_bn_stats, fake_quant, noise_aware, ste_sign

__all__ = ["AdamWConfig", "OptState", "apply_updates", "init_opt_state",
           "CompressionConfig", "compress_decompress", "init_error_state",
           "calibrate_bn_stats", "fake_quant", "noise_aware", "ste_sign"]
