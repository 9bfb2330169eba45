"""``repro_torch.accel`` — the execution-backend API, in torch.

* :mod:`.spec` — :class:`ExecSpec` (backend, B_A/B_X, coding, banking, ADC).
* :mod:`.registry` — named backends behind ``matmul(x, w, spec, ctx)``.
* :mod:`.backends` — ``digital``, ``digital_int``, ``bpbs`` and
  ``kernel`` (the hand-written CUDA kernel).
* :mod:`.policy` — :class:`PrecisionPolicy`: per-path/kind/layer specs.
* :mod:`.context` — :class:`ExecContext`, :func:`override`,
  :func:`trace`, :func:`pad_positions`.
* :mod:`.dispatch` — :func:`matmul`, the single entry point.
* :mod:`.program` — weight-stationary :class:`CimaImage` programs.
"""
from repro_torch.core.datapath import Postreduce

from . import backends as _backends  # registers the built-in backends
from .context import (ExecContext, MvmRecord, Trace, override, pad_positions,
                      trace)
from .dispatch import matmul
from .policy import DIGITAL, PrecisionPolicy
from .program import (CimaImage, CimaProgram, build_program, install_program,
                      strip_program)
from .registry import get_backend, list_backends, register_backend
from .spec import ExecSpec

__all__ = [
    "ExecSpec", "PrecisionPolicy", "DIGITAL", "ExecContext", "MvmRecord", "Trace",
    "Postreduce", "matmul", "override", "trace", "pad_positions",
    "register_backend", "get_backend", "list_backends",
    "CimaImage", "CimaProgram", "build_program", "install_program",
    "strip_program",
]
