"""Quantization-aware training pieces.  Port of ``repro.optim.qat``, so
far only :func:`ste_sign` (``fake_quant``, ``noise_aware`` and
``calibrate_bn_stats`` come with the training slice)."""
from __future__ import annotations

import torch


class _SteSign(torch.autograd.Function):
    """sign(x) in {-1, +1} (0 maps to +1, unlike ``torch.sign``); the
    backward pass is the identity clipped to |x| <= 1 (the standard BNN
    straight-through estimator)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Forward sign(x) in {-1, +1}; backward identity clipped to |x| <= 1."""
    return _SteSign.apply(x)
