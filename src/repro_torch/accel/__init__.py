"""``repro_torch.accel`` — the execution-backend API, in torch.

* :mod:`.spec` — :class:`ExecSpec` (backend, B_A/B_X, coding, banking, ADC).
* :mod:`.registry` — named backends behind ``matmul(x, w, spec, ctx)``.
* :mod:`.backends` — ``digital``, ``digital_int``, ``bpbs``, ``bpbs_ref``
  and ``kernel`` (the hand-written CUDA kernel).
* :mod:`.policy` — :class:`PrecisionPolicy`: per-path/kind/layer specs.
* :mod:`.context` — :class:`ExecContext`, :func:`override`,
  :func:`trace` (with its VDD corner), :func:`vmapped`,
  :func:`adc_noise`, :func:`pad_positions`, and :func:`energy_summary`,
  the chip cost model of a trace.
* :mod:`.dispatch` — :func:`matmul`, the single entry point.
* :mod:`.shard` — mesh execution: a partitioned image (column-parallel
  along M, row-parallel along N with an all-reduce after the ADC
  epilogue) runs as one tile per rank; dispatch engages it when the
  ambient mesh matches the image's compiled partition.
* :mod:`.program` — weight-stationary :class:`CimaImage` programs, the
  first-fit bank allocator (:func:`plan_allocation`) with streaming, and
  :class:`ProgramManager`.
* :func:`sanitize` (from :mod:`repro_torch.analysis.sanitize`) — the
  opt-in runtime checks at the dispatch boundary.
"""
from repro_torch.analysis.sanitize import SanitizeError, sanitize
from repro_torch.core.datapath import Postreduce, fold_batchnorm

from . import backends as _backends  # registers the built-in backends
from .context import (ExecContext, MvmRecord, Trace, adc_noise,
                      energy_summary, override, pad_positions, trace,
                      vmapped)
from .dispatch import matmul
from .policy import DIGITAL, PrecisionPolicy
from .program import (CimaImage, CimaProgram, ImageFootprint, Placement,
                      ProgramManager, build_program, install_program,
                      model_footprint, plan_allocation, strip_program)
from .registry import get_backend, list_backends, register_backend
from .spec import ExecSpec

__all__ = [
    "ExecSpec", "PrecisionPolicy", "DIGITAL", "ExecContext", "MvmRecord",
    "Trace", "Postreduce", "fold_batchnorm",
    "matmul", "override", "trace", "vmapped", "adc_noise", "pad_positions",
    "energy_summary",
    "register_backend", "get_backend", "list_backends",
    "CimaImage", "CimaProgram", "ImageFootprint", "Placement",
    "ProgramManager", "build_program", "install_program",
    "model_footprint", "plan_allocation", "strip_program",
    "sanitize", "SanitizeError",
]
