"""SQNR analysis of the mixed-signal BP/BS compute (paper Fig. 7).  Port
of ``repro.core.sqnr``.

The per-bank ADC resolves at most ``2^adc_bits`` of the column's ``N+1``
levels, so for ``N > 255`` the computation deviates from bit-true integer
compute.  Fig. 7 sweeps B_A for several B_X under XNOR and AND codings,
here empirically with uniformly distributed operands (as in the paper's
Fig. 10 multi-bit measurement).  Operands are drawn from an explicit
``torch.Generator`` on its own device (:func:`sweep_fig7` makes one on
the card unless the caller passes one or another device);
:func:`measure_sqnr` also takes given operands, so a caller can feed the
same numbers to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .bpbs import BpbsConfig, bpbs_matmul_int
from .quant import Coding, int_range


def sqnr_db(y_ref: torch.Tensor, y_hat: torch.Tensor) -> torch.Tensor:
    """10 log10( signal power / quantization-noise power )."""
    sig = torch.mean(torch.square(y_ref))
    err = torch.mean(torch.square(y_ref - y_hat))
    return 10.0 * torch.log10(sig / torch.clamp(err, min=1e-30))


def random_operands(gen: torch.Generator, batch: int, n: int, m: int,
                    ba: int, bx: int, coding: Coding,
                    sparsity: float = 0.0):
    """Uniformly distributed integer operands on the coding grids
    (float32 ``x [batch, n]``, ``w [n, m]``, on ``gen``'s device); 1-b
    XNOR has no zero."""
    coding = Coding(coding)
    lo_x, hi_x = int_range(bx, coding)
    lo_w, hi_w = int_range(ba, coding)

    def draw(lo, hi, shape, even):
        if even:
            return 2 * torch.randint(lo // 2, hi // 2 + 1, shape,
                                     generator=gen, device=gen.device)
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=gen.device)

    xnor = coding == Coding.XNOR
    x = draw(lo_x, hi_x, (batch, n), xnor and bx > 1)
    w = draw(lo_w, hi_w, (n, m), xnor and ba > 1)
    if xnor and bx == 1:
        x = torch.where(x == 0, 1, x)
    if xnor and ba == 1:
        w = torch.where(w == 0, 1, w)
    if sparsity > 0:
        keep = torch.bernoulli(torch.full((batch, n), 1.0 - sparsity,
                                          device=gen.device), generator=gen)
        x = x * keep.to(x.dtype)
    return x.to(torch.float32), w.to(torch.float32)


def measure_sqnr(gen: Optional[torch.Generator], n: int, ba: int, bx: int,
                 coding: Coding, batch: int = 64, m: int = 64,
                 sparsity: float = 0.0, adc_bits: int = 8,
                 adaptive_range: bool = False, operands=None) -> float:
    """Empirical SQNR (dB) of BP/BS+ADC compute against bit-true integer
    compute, on ``operands`` (``(x, w)``) or on operands drawn from
    ``gen``."""
    x, w = (operands if operands is not None else
            random_operands(gen, batch, n, m, ba, bx, coding, sparsity))
    cfg = BpbsConfig(ba=ba, bx=bx, coding=coding, adc_bits=adc_bits,
                     adaptive_range=adaptive_range)
    y_hat = bpbs_matmul_int(x, w, cfg)
    y_ref = x @ w
    return float(sqnr_db(y_ref, y_hat))


@dataclasses.dataclass
class SqnrPoint:
    coding: str
    n: int
    ba: int
    bx: int
    sparsity: float
    sqnr_db: float


def sweep_fig7(gen: Optional[torch.Generator] = None, n_values=(255, 2304),
               ba_values=(1, 2, 3, 4, 5, 6), bx_values=(1, 2, 4),
               codings=(Coding.XNOR, Coding.AND),
               sparsity: float = 0.0,
               device="cuda") -> list[SqnrPoint]:
    """The Fig. 7 sweep, every point drawn from ``gen`` in turn (by
    default a generator on ``device`` seeded with 0)."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for coding in codings:
        for n in n_values:
            for bx in bx_values:
                for ba in ba_values:
                    # accel-lint: allow[JAX02] one seeded operand stream
                    s = measure_sqnr(gen, n, ba, bx, coding,
                                     sparsity=sparsity)
                    out.append(SqnrPoint(Coding(coding).value, n, ba, bx,
                                         sparsity, s))
    return out
