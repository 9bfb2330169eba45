"""Core numerics of the paper's in-memory-computing accelerator, in torch:
bit-plane codings, the ADC, the BP/BS MVM and the near-memory datapath.
Each module answers to the ``repro.core`` module of the same name."""
from .bpbs import BpbsConfig, bpbs_matmul_int, bpbs_matmul_planes
from .quant import Coding, int_to_planes, planes_to_int, plane_weights, quantize

__all__ = ["BpbsConfig", "bpbs_matmul_int", "bpbs_matmul_planes", "Coding",
           "int_to_planes", "planes_to_int", "plane_weights", "quantize"]
