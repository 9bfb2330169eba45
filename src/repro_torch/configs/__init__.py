"""Config registry.  This port carries the dense configs (olmo-1b,
llama3.2-1b, granite-8b, starcoder2-3b), the two recurrent families
(mamba2-130m, recurrentgemma-9b), the MoE + MLA deepseek-v2-lite-16b and
the paper's two CIFAR-10 networks; the reference's encoder-decoder and
frontend configs (whisper, llama4-scout, phi-3-vision) come with the
slices that run them."""
from . import (deepseek_v2_lite_16b, granite_8b, llama3_2_1b, mamba2_130m,
               olmo_1b, recurrentgemma_9b, starcoder2_3b)
from .base import ArchConfig, get_config, register
from .cifar_nets import NETWORK_A, NETWORK_B, CnnConfig, CnnLayer

ALL_ARCHS = ("recurrentgemma-9b", "deepseek-v2-lite-16b", "starcoder2-3b",
             "granite-8b", "llama3.2-1b", "olmo-1b", "mamba2-130m")

__all__ = ["ArchConfig", "get_config", "register", "ALL_ARCHS",
           "CnnConfig", "CnnLayer", "NETWORK_A", "NETWORK_B"]
