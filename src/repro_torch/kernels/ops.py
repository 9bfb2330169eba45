"""Public entry points of the port's kernels (``repro.kernels.ops``).

On CUDA tensors they launch the hand-written kernel; on CPU tensors they
run its plain torch version.  There is no interpret mode."""
from __future__ import annotations

from .cima_mvm import cima_mvm, cima_mvm_from_planes
from .flash_attention import flash_attention

__all__ = ["cima_mvm", "cima_mvm_from_planes", "flash_attention"]
