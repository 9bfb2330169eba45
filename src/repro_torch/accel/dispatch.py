"""The single matmul entry point every managed projection goes through.
Port of ``repro.accel.dispatch`` (forward only: serving runs under
``torch.inference_mode()``; the straight-through gradient comes with the
training slice).

``matmul`` resolves the effective spec (applying any scoped
:func:`~repro_torch.accel.context.override`), validates a compiled weight
``image`` against it, records one :class:`MvmRecord` and calls the
registered backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .context import ExecContext, MvmRecord, current_override, record, tracing
from .registry import get_backend
from .spec import ExecSpec


def _record_mvm(spec: ExecSpec, x: torch.Tensor, w: torch.Tensor,
                image=None, post=None) -> None:
    if not tracing():
        return
    record(MvmRecord(
        tag=spec.tag, backend=spec.backend,
        n=int(w.shape[0]), m=int(w.shape[1]), ba=spec.ba, bx=spec.bx,
        calls=int(math.prod(x.shape[:-1])),
        program=image is not None,
        post_ops=post.n_ops() if post is not None else 0))


def matmul(x: torch.Tensor, w: torch.Tensor, spec: Optional[ExecSpec] = None,
           ctx: Optional[ExecContext] = None, *, dtype=None, image=None,
           post=None) -> torch.Tensor:
    """``x @ w`` under ``spec``'s execution backend.

    * ``spec=None`` means *digital by design*: a plain GEMM at ``dtype``
      (default ``x.dtype``), exempt from overrides and tracing.
    * A digital spec computes at ``dtype`` and returns that dtype.
    * Any other backend quantizes per its spec, computes in float32 and
      returns float32 — callers cast.
    * ``image``: this projection's compiled
      :class:`~repro_torch.accel.program.CimaImage`; used when it matches
      the resolved spec (bit-for-bit the on-the-fly result, zero weight
      quantize ops), dropped otherwise.
    * ``post``: a :class:`~repro_torch.core.datapath.Postreduce` epilogue
      run fused at the backend; the result is bit-for-bit
      ``post.apply(matmul(x, w, spec))`` wherever the backend composes
      the two, and fused into the kernel where it is per column.
    """
    if spec is None:
        dt = dtype or x.dtype
        y = torch.einsum("...n,nm->...m", x.to(dt), w.to(dt))
        return post.apply(y) if post is not None else y

    ov = current_override()
    if ov:
        spec = dataclasses.replace(spec, **ov)

    from .program import image_matches

    if image is not None and not image_matches(image, spec, w):
        image = None
    _record_mvm(spec, x, w, image, post)
    fn = get_backend(spec.backend)
    ctx = ExecContext() if ctx is None else ctx
    if image is not None:
        ctx = dataclasses.replace(ctx, image=image)
    if post is not None:
        ctx = dataclasses.replace(ctx, post=post)
    if spec.is_digital:
        dt = dtype or x.dtype
        return fn(x.to(dt), w.to(dt), spec, ctx)
    return fn(x.to(torch.float32), w.to(torch.float32), spec, ctx)
