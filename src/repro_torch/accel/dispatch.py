"""The single matmul entry point every managed projection goes through.
Port of ``repro.accel.dispatch``.

``matmul`` resolves the effective spec (applying any scoped
:func:`~repro_torch.accel.context.override`), validates a compiled weight
``image`` against it, records one :class:`MvmRecord` inside a
:func:`~repro_torch.accel.context.trace` scope (with the image's reload
schedule and the measured input sparsity and all-zero planes), takes the
call's ADC-noise generator from an open
:func:`~repro_torch.accel.context.adc_noise` scope and calls the
registered backend.

Non-digital backends get straight-through-estimator (STE) gradients: the
backward pass is that of the plain float GEMM (``dx = g wᵀ``,
``dw = Σ x ⊗ g`` in float32), which is what quantization-aware training
of the paper's CIFAR networks uses.  Those GEMMs follow the process's
TF32 setting, which torch leaves off; the reference holds them to
float32 products.  When autograd records the call, a
``post`` epilogue runs unfused after the STE matmul, under autograd, as
the reference differentiates matmul-then-epilogue; otherwise (serving
under ``inference_mode``, or nothing requires grad) the backend runs it
fused, as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quant import quantize
from repro_torch.core.sparsity import (count_zero_planes, element_mask,
                                       sparsity_fraction)

from .context import (ExecContext, MvmRecord, current_override,
                      current_pad_mask, next_noise_generator, record,
                      streamed_load_seen, tracing)
from .registry import get_backend
from .spec import ExecSpec


def _strip_pad(x: torch.Tensor) -> torch.Tensor:
    """Drop positions an ambient :func:`~repro_torch.accel.context.
    pad_positions` scope marks as padding before measuring sparsity
    (left-pad zeros are no exploitable sparsity); a mask whose shape
    does not prefix-match ``x`` (the unembed's last-token slice) is
    ignored."""
    mask = current_pad_mask()
    if mask is None:
        return x
    if mask.ndim >= x.ndim or tuple(x.shape[:mask.ndim]) != \
            tuple(mask.shape):
        return x
    return x[mask.to(device=x.device, dtype=torch.bool)]


def _measured_sparsity(spec: ExecSpec, x: torch.Tensor) -> Optional[float]:
    """The zero fraction of the input quantized onto the spec's grid: the
    broadcasts the AND-logic controller gates (paper Fig. 6b)."""
    if spec.backend == "digital":
        return None
    qx = quantize(_strip_pad(x), spec.bx, spec.coding,
                  per_row=spec.x_per_row)
    return float(sparsity_fraction(element_mask(qx.q)))


def _measured_planes(spec: ExecSpec, x: torch.Tensor) \
        -> tuple[Optional[int], Optional[int]]:
    """``(planes_skipped, planes_total)``: all-zero (bank, input-plane)
    serial steps at the spec's banking.  Pad positions stay in: the skip
    predicate sees the padded batch."""
    if spec.backend == "digital" or not spec.skip_zero_planes:
        return None, None
    qx = quantize(x, spec.bx, spec.coding, per_row=spec.x_per_row)
    return count_zero_planes(qx.q, spec.bpbs())


def _record_mvm(spec: ExecSpec, x: torch.Tensor, w: torch.Tensor,
                image=None, post=None) -> None:
    """One :class:`MvmRecord` into every open trace.  Outside a trace it
    does nothing: the measurements read counts back to the host, and the
    serving path must not pay for them."""
    if not tracing():
        return
    streamed = image is not None and not image.resident
    overlap = streamed and image.overlap
    # the first streamed load of a pass has no compute to hide behind;
    # checked against the innermost trace before this record lands
    prologue = 1 if (overlap and not streamed_load_seen()) else 0
    skipped, total = _measured_planes(spec, x)
    record(MvmRecord(
        tag=spec.tag, backend=spec.backend,
        n=int(w.shape[0]), m=int(w.shape[1]), ba=spec.ba, bx=spec.bx,
        calls=int(math.prod(x.shape[:-1])),
        program=image is not None,
        loads=1 if streamed else 0,
        load_segments=image.segments if streamed else 0,
        stream_overlap=overlap,
        load_prologue=prologue,
        devices=image.devices if image is not None else 1,
        partition=(image.partition or "") if image is not None else "",
        data_shards=(max(image.data_shards, 1) if image is not None
                     else 1),
        post_ops=post.n_ops() if post is not None else 0,
        sparsity=_measured_sparsity(spec, x),
        planes_skipped=skipped,
        planes_total=total))


class _StraightThrough(torch.autograd.Function):
    """The backend's forward on the float32 operands; the backward of the
    plain float GEMM (the reference's ``custom_vjp`` ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, fn, spec, ectx):
        ctx.save_for_backward(x, w)
        return fn(x, w, spec, ectx)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("...m,nm->...n", g, w)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("...n,...m->nm", x, g)
        return dx, dw, None, None, None


def _records_grad(*ts) -> bool:
    """Does autograd record an op on these operands?"""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in ts)


def matmul(x: torch.Tensor, w: torch.Tensor, spec: Optional[ExecSpec] = None,
           ctx: Optional[ExecContext] = None, *, dtype=None, image=None,
           post=None) -> torch.Tensor:
    """``x @ w`` under ``spec``'s execution backend.

    * ``spec=None`` means *digital by design*: a plain GEMM at ``dtype``
      (default ``x.dtype``), exempt from overrides and tracing.
    * A digital spec computes at ``dtype`` and returns that dtype; it
      takes no STE (autograd differentiates the GEMM itself).
    * Any other backend quantizes per its spec, computes in float32 with
      STE gradients and returns float32 — callers cast.
    * ``image``: this projection's compiled
      :class:`~repro_torch.accel.program.CimaImage`; used when it matches
      the resolved spec (bit-for-bit the on-the-fly result, zero weight
      quantize ops), dropped otherwise.
    * ``post``: a :class:`~repro_torch.core.datapath.Postreduce` epilogue
      run fused at the backend; the result is bit-for-bit
      ``post.apply(matmul(x, w, spec))`` wherever the backend composes
      the two, and fused into the kernel where it is per column.  When
      autograd records the call, the backend runs without it and
      ``post.apply`` follows under autograd (STE through the matmul, the
      true gradient through the epilogue and its registers).
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
    if ctx is None:
        ctx = ExecContext(generator=next_noise_generator(x.device))
    if image is not None:
        ctx = dataclasses.replace(ctx, image=image)
    if spec.is_digital:
        dt = dtype or x.dtype
        if post is not None:
            ctx = dataclasses.replace(ctx, post=post)
        return fn(x.to(dt), w.to(dt), spec, ctx)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    regs = (post.scale, post.bias) if post is not None else ()
    if _records_grad(xf, wf, *regs):
        y = _StraightThrough.apply(xf, wf, fn, spec,
                                   dataclasses.replace(ctx, post=None))
        return post.apply(y, spec.bx, spec.ba) if post is not None else y
    if post is not None:
        ctx = dataclasses.replace(ctx, post=post)
    return fn(xf, wf, spec, ctx)
