"""Hand-written Hopper kernels of the port.

* :mod:`repro_torch.kernels.cima_mvm` — the BP/BS bit-plane MVM with the
  per-bank ADC epilogue and fused near-memory datapath, in CUDA C++
  (``csrc/cima_mvm.cu``), beside its plain torch version.
* :mod:`repro_torch.kernels.flash_attention` — online-softmax attention
  with GQA, causal masking and a sliding window, in CUDA C++
  (``csrc/flash_attention.cu``), beside its plain torch version.

Both sources are compiled by ``nvcc`` into ``build/`` on first use
(:mod:`._build`) and bound with ``ctypes``.

``ops.py`` holds the entry points, ``ref.py`` the oracles.

The reference's ``kernels/_compat.py`` (a shim over the renamed Pallas
TPU ``CompilerParams``) has no counterpart: the port has no Pallas API
to shim."""
from . import ops, ref

__all__ = ["ops", "ref"]
