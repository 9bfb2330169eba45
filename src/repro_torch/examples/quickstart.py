"""Quickstart: the paper's accelerator in five minutes.  Port of the
reference's ``examples/quickstart.py``.

Shows the core result of the paper (§3, Fig. 7/10): the mixed-signal
BP/BS MVM with an 8-b ADC at the charge-share boundary
  * emulates integer compute EXACTLY when the column range fits the ADC,
  * degrades gracefully (known SQNR) at full N = 2304,
  * recovers exactness through the Sparsity Controller's adaptive range,
and prints the chip's measured energy model for the same operation.
The operands are the reference's, drawn from the same numpy seed.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import accel
from repro_torch.core import BpbsConfig, Coding, bpbs_matmul_int
from repro_torch.core import energy as E


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    print("=== 1. exact integer emulation (N <= 255, paper §3) ===")
    x = t(2 * rng.integers(-4, 5, (4, 255)))
    w = t(2 * rng.integers(-4, 5, (255, 16)))
    y = bpbs_matmul_int(x, w, BpbsConfig(ba=4, bx=4, coding=Coding.XNOR))
    print("   max |chip - integer| =", float((y - x @ w).abs().max()))

    print("=== 2. full-array N = 2304: ADC quantization, known SQNR ===")
    x = t(2 * rng.integers(-4, 5, (4, 2304)))
    w = t(2 * rng.integers(-4, 5, (2304, 16)))
    y = bpbs_matmul_int(x, w, BpbsConfig(ba=4, bx=4))
    ref = x @ w
    sqnr = 10 * torch.log10(torch.mean(ref ** 2)
                            / torch.mean((ref - y) ** 2))
    print(f"   SQNR = {float(sqnr):.1f} dB (paper Fig. 7 band)")

    print("=== 3. sparsity control restores exactness (paper §2/§3) ===")
    xs = np.zeros((4, 2304), np.float32)
    idx = rng.choice(2304, 200, replace=False)
    xs[:, idx] = 2 * rng.integers(-4, 5, (4, 200))
    xs = t(xs)
    y = bpbs_matmul_int(xs, w, BpbsConfig(ba=4, bx=4, adaptive_range=True))
    print("   max |chip - integer| =", float((y - xs @ w).abs().max()),
          "(200 non-zeros of 2304)")

    print("=== 4. float API with STE gradients (repro_torch.accel) ===")
    xf = t(rng.normal(size=(8, 512)))
    wf = t(rng.normal(size=(512, 64)))
    # bank-gate at 255 rows: each bank's range fits the ADC -> the only
    # remaining error is the 6-b operand quantization itself
    spec = accel.ExecSpec(backend="bpbs", ba=6, bx=6, bank_n=255)
    with accel.trace() as records:
        yf = accel.matmul(xf, wf, spec)
    with accel.override(backend="digital_int"):
        y_int = accel.matmul(xf, wf, spec)     # same spec, ideal substrate
    rel = float(torch.linalg.norm(yf - xf @ wf) / torch.linalg.norm(xf @ wf))
    chip_vs_ideal = float(torch.linalg.norm(yf - y_int)
                          / torch.linalg.norm(y_int))
    wg = wf.clone().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(accel.matmul(xf, wg, spec) ** 2),
                               wg)
    print(f"   backends registered: {accel.list_backends()}")
    print(f"   rel err vs float = {rel:.3f} (= 6-b quantization); "
          f"chip vs bit-true ideal = {chip_vs_ideal:.2e}; grad finite = "
          f"{bool(torch.isfinite(g).all())}")
    es = accel.energy_summary(records, vdd=1.2)
    print(f"   traced {len(records)} MVM(s): chip-model cost "
          f"{es['total_pj']/1e3:.1f} nJ, {es['total_cycles']} cycles")

    print("=== 5. what the chip would spend on this MVM ===")
    shape = E.MvmShape(n=2304, m=64, ba=4, bx=4)
    e = E.mvm_energy_pj(shape, vdd=1.2, sparsity=0.5)
    print(f"   energy = {e['total']/1e3:.1f} nJ  "
          f"(cima {e['cima']/1e3:.1f}, adc {e['readout']/1e3:.1f}, "
          f"datapath {e['datapath']/1e3:.1f} nJ)")
    print(f"   cycles = {E.mvm_cycles(shape)}  "
          f"utilization = {E.utilization(shape):.2f}")
    print(f"   peak: {E.peak_tops_1b(1.2):.1f} 1b-TOPS, "
          f"{E.peak_tops_per_w_1b(1.2):.0f} 1b-TOPS/W (paper: 4.7, 152)")


if __name__ == "__main__":
    main()
