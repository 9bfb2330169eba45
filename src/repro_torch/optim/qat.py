"""Quantization-aware training pieces.  Port of ``repro.optim.qat``.

The accelerator matmul has its own straight-through estimator
(:mod:`repro_torch.accel.dispatch`); these cover the activation
nonlinearities of the paper's CIFAR networks: :func:`ste_sign`, the
binarizing sign of the ABN path, and :func:`fake_quant`.  The reference's
noise-robustness recipe (``noise_aware``, ``calibrate_bn_stats``) comes
with the port's ADC-noise slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import Coding, quantize


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


def fake_quant(x: torch.Tensor, bits: int,
               axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric (XNOR-grid) fake quantization with an identity gradient:
    the forward value is the dequantized grid value, quantized from
    ``x.detach()``."""
    y = quantize(x.detach(), bits, Coding.XNOR, axis=axis).dequant
    return x + (y - x).detach()
