"""Paper Fig. 10: CIMA-column transfer functions and the multi-bit
compute match.  Port of ``benchmarks/fig10_transfer.py``.

Top panels: sweep the number of input bits set to '1' with all matrix
bits at '1' — the ADC code and the ABN threshold transition must be
linear in the popcount (these rows equal the reference's).  Bottom
panels: multi-bit compute with uniformly distributed operands (from a
``torch.Generator`` on ``device``) must track bit-true values."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.adc import abn_binarize, adc_convert
from repro_torch.core.bpbs import BpbsConfig, bpbs_matmul_int
from repro_torch.core.quant import Coding
from repro_torch.core.sqnr import random_operands, sqnr_db

from .common import emit, time_call


def run(device="cuda"):
    n = 2304
    # --- ADC transfer: matrix bits all '1', sweep input popcount
    p = torch.arange(0, n + 1, 64, dtype=torch.float32, device=device)
    codes = adc_convert(p, float(n))
    pn, cn = p.cpu().numpy(), codes.cpu().numpy()
    lin = np.polyfit(pn, cn, 1)
    resid = np.max(np.abs(np.polyval(lin, pn) - cn))
    assert resid <= 1.0, "ADC transfer must be linear to within 1 code"
    emit("fig10_adc_transfer", 0.0,
         f"slope={lin[0]:.4f};max_dev_codes={resid:.2f}")

    # --- ABN transition threshold sweeps linearly with the DAC code
    sweep = torch.arange(0.0, n + 1, device=device)
    trans = []
    for code in (8, 16, 32, 48, 56):
        out = abn_binarize(sweep, float(code), float(n))
        trans.append(int(torch.argmax((out > 0).to(torch.int32))))
    diffs = np.diff(trans)
    assert np.all(diffs > 0)
    lin2 = np.polyfit([8, 16, 32, 48, 56], trans, 1)
    emit("fig10_abn_transfer", 0.0,
         f"transitions={trans};slope_p_per_code={lin2[0]:.1f}")

    # --- multi-bit compute vs bit-true (uniform operands, as measured)
    for (ba, bx) in ((1, 1), (2, 2), (4, 4)):
        gen = torch.Generator(device=device).manual_seed(3)
        x, w = random_operands(gen, 32, n, 64, ba, bx, Coding.XNOR)
        cfg = BpbsConfig(ba=ba, bx=bx)
        y = bpbs_matmul_int(x, w, cfg)
        exact = x @ w
        s = float(sqnr_db(exact, y))
        corr = float(torch.corrcoef(torch.stack([exact.ravel(),
                                                 y.ravel()]))[0, 1])
        assert corr > 0.99, "chip compute must track bit-true values"
        us = time_call(lambda x=x, w=w, cfg=cfg: bpbs_matmul_int(x, w, cfg),
                       device)
        emit(f"fig10_multibit_Ba{ba}_Bx{bx}", us,
             f"sqnr_db={s:.1f};corr={corr:.4f}")
