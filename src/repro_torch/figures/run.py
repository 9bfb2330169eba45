"""The paper's figure checks on one device: Figs. 8, 11, 10 and 7, in
the reference's order.

Prints ``name,us_per_call,derived`` CSV rows; every figure also asserts
the paper's corresponding claim, as the reference's ``benchmarks/run.py``
does.  A failed figure is reported with its traceback and the run exits
1 after the others have run.

Run:  PYTHONPATH=src python -m repro_torch.figures.run [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import fig7_sqnr, fig8_bandwidth, fig10_transfer, fig11_networks

FIGURES = (fig8_bandwidth, fig11_networks, fig10_transfer, fig7_sqnr)


def run_all(device="cuda") -> list[str]:
    """Run every figure on ``device``; returns the names of those that
    failed (their tracebacks go to stderr)."""
    print("name,us_per_call,derived", flush=True)
    failures = []
    for mod in FIGURES:
        try:
            mod.run(device)
        except Exception:
            failures.append(mod.__name__)
            traceback.print_exc()
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failures = run_all(args.device)
    if failures:
        print(f"FIGURE FAILURES: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
