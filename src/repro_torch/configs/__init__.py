"""Config registry.  This port carries the dense configs (olmo-1b,
llama3.2-1b, granite-8b, starcoder2-3b), the two recurrent families
(mamba2-130m, recurrentgemma-9b) and the paper's two CIFAR-10 networks;
the reference's MoE, MLA, encoder-decoder and frontend configs come with
the model families that run them."""
from . import (granite_8b, llama3_2_1b, mamba2_130m, olmo_1b,
               recurrentgemma_9b, starcoder2_3b)
from .base import ArchConfig, get_config, register
from .cifar_nets import NETWORK_A, NETWORK_B, CnnConfig, CnnLayer

ALL_ARCHS = ("recurrentgemma-9b", "starcoder2-3b", "granite-8b",
             "llama3.2-1b", "olmo-1b", "mamba2-130m")

__all__ = ["ArchConfig", "get_config", "register", "ALL_ARCHS",
           "CnnConfig", "CnnLayer", "NETWORK_A", "NETWORK_B"]
