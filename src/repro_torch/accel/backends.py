"""Built-in execution backends.  Port of ``repro.accel.backends``.

Every quantizing backend shares one operand-quantization discipline
(:func:`quantize_input` / :func:`weight_grid` / :func:`rescale`), so
``digital_int`` is the bit-true reference for ``bpbs`` and ``kernel`` by
construction.  When ``ctx.image`` carries a compiled
:class:`~repro_torch.accel.program.CimaImage`, the weight side comes from
the stored planes/grid and no per-call weight quantization runs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bpbs import (bpbs_matmul_planes,
                                   bpbs_matmul_planes_reference,
                                   weight_planes)
from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import ops as kernel_ops

from .context import ExecContext
from .registry import register_backend
from .spec import ExecSpec


def quantize_input(x: torch.Tensor, spec: ExecSpec) -> QTensor:
    """Quantize the dynamic input onto the spec's grid (int8 values);
    ``spec.x_per_row`` keeps one scale per input row."""
    qx = quantize(x, spec.bx, spec.coding, per_row=spec.x_per_row)
    return dataclasses.replace(qx, q=qx.q.to(torch.int8))


def _quantize_weight(w: torch.Tensor, spec: ExecSpec) -> QTensor:
    return quantize(w, spec.ba, spec.coding,
                    axis=1 if spec.per_channel else None)


def weight_grid(w: torch.Tensor, spec: ExecSpec, ctx: ExecContext) -> QTensor:
    """The weight operand on the spec's integer grid (the image's stored
    int16 grid when armed, else quantized per call)."""
    img = ctx.image
    if img is not None:
        return QTensor(img.wq.to(torch.float32), img.scale, spec.ba,
                       spec.coding)
    return _quantize_weight(w, spec)


def weight_planes_for(w: torch.Tensor, spec: ExecSpec, ctx: ExecContext
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ws [N, B_A, M], scale)`` for the plane-consuming backends."""
    img = ctx.image
    if img is not None:
        return img.ws.to(torch.float32), img.scale
    qw = _quantize_weight(w, spec)
    return weight_planes(qw.q, spec.bpbs()).permute(0, 2, 1), qw.scale


def rescale(y_int: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor, spec: ExecSpec) -> torch.Tensor:
    sw = w_scale if not spec.per_channel else w_scale.reshape(1, -1)
    return y_int * x_scale * sw


def apply_post(y: torch.Tensor, post, spec: ExecSpec) -> torch.Tensor:
    """Run a fused Postreduce on a backend's rescaled output (no-op for
    None), so the fused path is the same function composition as
    matmul-then-postreduce."""
    if post is None:
        return y
    return post.apply(y, spec.bx, spec.ba)


@register_backend("digital")
def digital(x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """Plain float GEMM — the "not in-memory computing" baseline."""
    return apply_post(torch.einsum("...n,nm->...m", x, w), ctx.post, spec)


@register_backend("digital_int")
def digital_int(x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """Bit-true integer compute at (B_A, B_X) — the paper's "ideal"."""
    qx = quantize_input(x, spec)
    qw = weight_grid(w, spec, ctx)
    y_int = torch.einsum("...n,nm->...m", qx.q.to(torch.float32),
                         qw.q.to(torch.float32))
    return apply_post(rescale(y_int, qx.scale, qw.scale, spec), ctx.post,
                      spec)


@register_backend("bpbs")
def bpbs(x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """Mixed-signal BP/BS pipeline, fast GEMM-identity path; ADC noise
    from ``ctx.generator``."""
    qx = quantize_input(x, spec)
    ws, w_scale = weight_planes_for(w, spec, ctx)
    y_int = bpbs_matmul_planes(qx.q, ws, spec.bpbs(), ctx.generator)
    return apply_post(rescale(y_int, qx.scale, w_scale, spec), ctx.post,
                      spec)


@register_backend("bpbs_ref")
def bpbs_ref(x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """Cell-by-cell charge-share physics (slow; validation only)."""
    qx = quantize_input(x, spec)
    ws, w_scale = weight_planes_for(w, spec, ctx)
    y_int = bpbs_matmul_planes_reference(qx.q, ws, spec.bpbs())
    return apply_post(rescale(y_int, qx.scale, w_scale, spec), ctx.post,
                      spec)


def _kernel_fusable(post, m: int) -> bool:
    """Can this epilogue run inside the kernel?  The datapath registers
    are per COLUMN, so only scalar / per-column scale and bias fuse; a
    tensor-valued bias (a residual stream on the bias port) applies after
    the kernel instead."""
    def per_col(a):
        return a is None or (a.ndim <= 1 and a.numel() in (1, m))

    return per_col(post.scale) and per_col(post.bias)


@register_backend("kernel")
def kernel(x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """The hand-written CUDA kernel (its plain version on CPU tensors).
    A per-column ``ctx.post`` fuses into the kernel's datapath epilogue:
    the quantization rescale folds into the scale registers and the
    output leaves the kernel already post-reduced.  Like the reference's
    Pallas backend it takes no noise: at ``adc_sigma_lsb > 0`` it warns
    and runs noiseless (noisy runs take ``bpbs``)."""
    qx = quantize_input(x, spec)
    img = ctx.image
    if img is not None:
        ws_planes, w_scale = img.ws, img.scale
    else:
        qw = _quantize_weight(w, spec)
        ws_planes, w_scale = None, qw.scale

    post = ctx.post
    m = int(w.shape[-1])
    if post is not None and _kernel_fusable(post, m):
        sw = w_scale.reshape(-1) if spec.per_channel else w_scale
        escale = qx.scale * sw
        if post.scale is not None:
            escale = escale * post.scale
        fused = dict(escale=escale, pbias=post.bias, act=post.act,
                     by_bits=post.resolve_bits(spec.bx, spec.ba))
        if img is not None:
            return kernel_ops.cima_mvm_from_planes(qx.q, ws_planes,
                                                   spec.bpbs(), **fused)
        return kernel_ops.cima_mvm(qx.q, qw.q, spec.bpbs(), **fused)

    if img is not None:
        y_int = kernel_ops.cima_mvm_from_planes(qx.q, ws_planes, spec.bpbs())
    else:
        y_int = kernel_ops.cima_mvm(qx.q, qw.q, spec.bpbs())
    return apply_post(rescale(y_int, qx.scale, w_scale, spec), post, spec)
