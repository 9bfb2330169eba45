"""Config registry: one module per architecture of the reference (the
dense olmo-1b, llama3.2-1b, granite-8b and starcoder2-3b; the recurrent
mamba2-130m and recurrentgemma-9b; the MoE + MLA deepseek-v2-lite-16b;
the encoder-decoder whisper-tiny; the early-fusion phi-3-vision-4.2b and
llama4-scout-17b-a16e, whose modality frontends are stubs as in the
reference) and the paper's two CIFAR-10 networks."""
from . import (deepseek_v2_lite_16b, granite_8b, llama3_2_1b,
               llama4_scout_17b_a16e, mamba2_130m, olmo_1b,
               phi_3_vision_4_2b, recurrentgemma_9b, starcoder2_3b,
               whisper_tiny)
from .base import ArchConfig, get_config, list_archs, register
from .cifar_nets import NETWORK_A, NETWORK_B, CnnConfig, CnnLayer

ALL_ARCHS = ("phi-3-vision-4.2b", "deepseek-v2-lite-16b",
             "llama4-scout-17b-a16e", "recurrentgemma-9b", "starcoder2-3b",
             "granite-8b", "llama3.2-1b", "olmo-1b", "mamba2-130m",
             "whisper-tiny")

__all__ = ["ArchConfig", "get_config", "list_archs", "register",
           "ALL_ARCHS", "CnnConfig", "CnnLayer", "NETWORK_A", "NETWORK_B"]
