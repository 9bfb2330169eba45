"""``python -m repro_torch.analysis src/repro_torch`` — the accel linter
for the torch port.

Exit status 0 when no findings survive suppressions and the baseline,
1 otherwise.  ``--explain CODE`` prints the invariant a rule encodes and
how to fix violations.
"""
from __future__ import annotations

import argparse
import sys

from .findings import RULES, explain
from .runner import (DEFAULT_BASELINE, filter_baseline, lint_paths,
                     load_baseline, write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="accel-aware static linter for the torch port")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to lint")
    ap.add_argument("--explain", metavar="CODE",
                    help="print the invariant behind a rule code and exit")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="known-findings file (default: "
                         "%(default)s; missing file = empty)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current findings into the baseline "
                         "file instead of failing")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog one line per code")
    args = ap.parse_args(argv)

    if args.explain:
        print(explain(args.explain))
        return 0
    if args.list_rules:
        for code in sorted(RULES):
            print(f"{code}  {RULES[code].title}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: python -m repro_torch.analysis "
                 "src/repro_torch)")

    findings = lint_paths(args.paths)
    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0
    findings = filter_baseline(findings, load_baseline(args.baseline))
    for f in findings:
        print(f.render())
    n = len(findings)
    if n:
        print(f"\n{n} finding(s).  `python -m repro_torch.analysis "
              f"--explain CODE` explains a rule; suppress a vetted "
              f"exception with `# accel-lint: allow[CODE] reason`.")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
