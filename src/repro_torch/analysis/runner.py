"""File walking, suppression application, and the findings baseline.
Port of ``repro.analysis.runner``."""
from __future__ import annotations

import ast
import json
import os
from typing import Iterable, Optional

from .findings import Finding, apply_suppressions, scan_suppressions
from .rules import run_rules

# the port's own baseline; the reference keeps .accel-lint-baseline.json
DEFAULT_BASELINE = ".accel-lint-torch-baseline.json"

_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", ".pytest_cache",
              "build", "dist", ".eggs"}


def iter_python_files(paths: Iterable[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def _is_src(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return not any(p in ("tests", "benchmarks") for p in parts)


def lint_source(source: str, path: str,
                src_scope: Optional[bool] = None) -> list[Finding]:
    """Lint one module given as text.  ``src_scope`` defaults from the
    path (``tests/``/``benchmarks/`` get the relaxed rule set)."""
    if src_scope is None:
        src_scope = _is_src(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("LNT00", path, e.lineno or 1, 0,
                        f"could not parse: {e.msg}")]
    sups, bad = scan_suppressions(source, path)
    findings = run_rules(tree, path, src_scope=src_scope)
    return sorted(apply_suppressions(findings, sups) + bad,
                  key=lambda f: (f.path, f.line, f.code))


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    out: list[Finding] = []
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            out.append(Finding("LNT00", path, 1, 0, f"unreadable: {e}"))
            continue
        out.extend(lint_source(source, path))
    return out


# ------------------------------------------------------------------ baseline

def load_baseline(path: str) -> set:
    """Fingerprints of known findings that don't fail the gate (a missing
    file is an empty baseline)."""
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return set(data.get("findings", []))


def write_baseline(path: str, findings: list[Finding]) -> None:
    data = {"comment": "accel-lint known findings of the torch port; keep "
                       "this empty — fix or suppress inline with a reason "
                       "instead",
            "findings": sorted(f.fingerprint() for f in findings)}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")


def filter_baseline(findings: list[Finding], baseline: set
                    ) -> list[Finding]:
    return [f for f in findings if f.fingerprint() not in baseline]
