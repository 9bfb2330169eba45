"""Execution context, scoped overrides, pad positions and the MVM trace.
Port of ``repro.accel.context``.

* :class:`ExecContext` carries per-call state into a backend: a compiled
  weight image and a fused datapath epilogue.
* :func:`override` rewrites every policy-managed spec at dispatch time
  (``with override(backend="bpbs"): ...`` flips a whole model between
  substrates without rebuilding configs).
* :func:`trace` collects one :class:`MvmRecord` per dispatched matmul.

PyTorch runs eagerly, so every call dispatches (and records) anew:
there is no trace-time caveat, and no scan or vmap whose instances a
record would have to be scaled by.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional


@dataclasses.dataclass
class ExecContext:
    """Runtime state threaded into a backend call."""

    # compiled weight image (repro_torch.accel.program.CimaImage): when
    # armed the backend consumes stored bit planes instead of quantizing w
    image: Optional[object] = None
    # fused near-memory datapath epilogue (core.datapath.Postreduce)
    post: Optional[object] = None


# ------------------------------------------------------------- overrides

_OVERRIDE_STACK: list[dict] = []


@contextlib.contextmanager
def override(**spec_kw) -> Iterator[None]:
    """Scoped spec rewrite applied to every policy-managed dispatch.
    Nested overrides compose, inner wins per field.  ``spec=None`` calls
    (digital by design) are never rewritten."""
    from .spec import ExecSpec

    fields = {f.name for f in dataclasses.fields(ExecSpec)}
    unknown = set(spec_kw) - fields
    if unknown:
        raise TypeError(
            f"override(): unknown ExecSpec field(s) {sorted(unknown)}; "
            f"valid: {sorted(fields)}")
    _OVERRIDE_STACK.append(dict(spec_kw))
    try:
        yield
    finally:
        _OVERRIDE_STACK.pop()


def current_override() -> dict:
    """The merged override in effect (inner scopes win)."""
    merged: dict = {}
    for frame in _OVERRIDE_STACK:
        merged.update(frame)
    return merged


# ----------------------------------------------------------------- trace

@dataclasses.dataclass(frozen=True)
class MvmRecord:
    """One dispatched MVM: the resolved spec plus its static shape.
    ``program`` marks dispatches served from a compiled image;
    ``post_ops`` counts the fused datapath ops per output element."""

    tag: str          # the layer path the policy resolved (spec.tag)
    backend: str
    n: int            # contraction dim (input vector length)
    m: int            # output dim
    ba: int
    bx: int
    calls: int        # number of row-vector MVMs (prod of leading dims)
    program: bool = False
    post_ops: int = 0


class Trace(list):
    """The record buffer a :func:`trace` scope yields: the
    :class:`MvmRecord` of every dispatch, in dispatch order."""


_TRACE_STACK: list[Trace] = []


@contextlib.contextmanager
def trace() -> Iterator[Trace]:
    """Collect an :class:`MvmRecord` per dispatched matmul in this scope."""
    buf = Trace()
    _TRACE_STACK.append(buf)
    try:
        yield buf
    finally:
        _TRACE_STACK.pop()


def record(rec: MvmRecord) -> None:
    for buf in _TRACE_STACK:
        buf.append(rec)


def tracing() -> bool:
    return bool(_TRACE_STACK)


# ------------------------------------------------------------ pad positions

_PAD_STACK: list = []


@contextlib.contextmanager
def pad_positions(mask) -> Iterator[None]:
    """Mark which leading positions of the activations are PADDING
    (``mask`` bool, True = real token), for sparsity accounting that must
    not count left-pad zeros as exploitable input sparsity."""
    _PAD_STACK.append(mask)
    try:
        yield
    finally:
        _PAD_STACK.pop()


def current_pad_mask():
    """The innermost ambient pad mask (None outside any scope)."""
    return _PAD_STACK[-1] if _PAD_STACK else None
