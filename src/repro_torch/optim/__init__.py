"""Training-side pieces of the port: AdamW (:mod:`.adamw`), gradient
compression with error feedback (:mod:`.compression`) and the
quantization-aware-training activations (:mod:`.qat`)."""
from .adamw import AdamWConfig, OptState, apply_updates, init_opt_state
from .compression import (CompressionConfig, compress_decompress,
                          init_error_state)
from .qat import fake_quant, ste_sign

__all__ = ["AdamWConfig", "OptState", "apply_updates", "init_opt_state",
           "CompressionConfig", "compress_decompress", "init_error_state",
           "fake_quant", "ste_sign"]
