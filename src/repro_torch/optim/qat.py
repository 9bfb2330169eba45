"""Quantization- and noise-aware-training pieces.  Port of
``repro.optim.qat``.

The accelerator matmul has its own straight-through estimator
(:mod:`repro_torch.accel.dispatch`); these cover the activation
nonlinearities of the paper's CIFAR networks (:func:`ste_sign`, the
binarizing sign of the ABN path, and :func:`fake_quant`) and the
noise-robustness recipe for the 0.85 V corner:

* :func:`noise_aware` — a scope that runs any forward or loss under the
  noisy chip model (an ``adc_sigma_lsb`` override and a live
  ``adc_noise`` scope): noise-aware QAT.
* :func:`calibrate_bn_stats` — re-estimate the BN running statistics
  under ADC noise, so the folded datapath registers center the noisy
  pre-activation distribution.

The kernel backend draws no noise (as the reference's Pallas backend),
so noisy forwards name ``bpbs``, the reference's CIFAR policy backend.
"""
from __future__ import annotations

import contextlib
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


# ----------------------------------------------------- noise robustness

@contextlib.contextmanager
def noise_aware(seed: int, sigma_lsb: float):
    """Run the enclosed computation under the noisy chip model: every
    managed matmul resolves with ``adc_sigma_lsb=sigma_lsb`` and draws its
    ADC noise from the :func:`~repro_torch.accel.adc_noise` scope of
    ``seed`` (one generator per dispatch).  Wrap a loss forward in it for
    noise-aware QAT at the 0.85 V corner
    (``repro_torch.core.adc.SIGMA_LSB_CORNER``)."""
    from repro_torch import accel

    with accel.override(adc_sigma_lsb=float(sigma_lsb)), \
            accel.adc_noise(seed):
        yield


@torch.no_grad()
def calibrate_bn_stats(params, batches, net, seed: int, sigma_lsb: float,
                       backend: str = "bpbs"):
    """Noise-calibration pass: re-estimate the BN running statistics under
    the noisy chip model.

    Inference folds ``bn_mean``/``bn_var`` into the near-memory
    datapath's scale and bias registers, so statistics estimated on a
    noiseless forward mis-center the noisy pre-activations at the 0.85 V
    corner.  This runs one train-mode forward per batch on ``backend``
    under :func:`noise_aware` (batch ``i`` seeded ``fold_seed(seed, i)``),
    collects each layer's batch statistics as training does, and
    replaces the running statistics with their plain mean.  Returns the
    updated ``params``; everything else in them is the caller's."""
    from repro_torch.accel.context import fold_seed
    from repro_torch.models.cnn import cnn_forward

    sums, n = None, 0
    for i, batch in enumerate(batches):
        with noise_aware(fold_seed(seed, i), sigma_lsb):
            _, stats = cnn_forward(params, batch["images"], net,
                                   backend=backend, train=True)
        sums = stats if sums is None else [
            (a + mu, b + var) for (a, b), (mu, var) in zip(sums, stats)]
        n += 1
    if not n:
        return params
    return {"layers": [{**p, "bn_mean": mu / n, "bn_var": var / n}
                       for p, (mu, var) in zip(params["layers"], sums)]}
