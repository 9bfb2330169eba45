"""Named execution-backend registry.  Port of ``repro.accel.registry``.

A backend is a callable ``fn(x: f32[..., N], w: f32[N, M], spec, ctx)
-> f32[..., M]`` that owns its numerics end to end (quantize -> compute
-> rescale); :func:`repro_torch.accel.matmul` owns casting, overrides
and trace records.
"""
from __future__ import annotations

from typing import Callable, Optional

BackendFn = Callable[..., object]

# the names repro_torch.accel.backends registers at import
BUILTIN_BACKENDS = ("digital", "digital_int", "bpbs", "bpbs_ref", "kernel")

_BACKENDS: dict[str, BackendFn] = {}


def known_backend(name: str) -> bool:
    return name in _BACKENDS or name in BUILTIN_BACKENDS


def register_backend(name: str, fn: Optional[BackendFn] = None):
    """Register ``fn`` under ``name`` (replacing any earlier one); usable
    as a decorator."""
    def _register(f: BackendFn) -> BackendFn:
        _BACKENDS[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


def get_backend(name: str) -> BackendFn:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown accel backend {name!r}; registered: {list_backends()}"
        ) from None


def list_backends() -> list[str]:
    return sorted(_BACKENDS)
