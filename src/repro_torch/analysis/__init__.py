"""``repro_torch.analysis`` — the port's mechanical invariant enforcement.
Port of ``repro.analysis``.

Two halves:

* a static, call-graph-aware linter (``python -m repro_torch.analysis
  src/repro_torch``) whose rules encode the repo's prose invariants in
  torch's form — host-sync discipline on the decode hot path and in
  captured graphs, one seeded generator per random consumer,
  record-outside-the-rank-body, frozen specs, the single dispatch entry
  point (see :data:`repro_torch.analysis.findings.RULES`);
* an opt-in runtime sanitizer scope (:func:`repro_torch.analysis.
  sanitize.sanitize`, re-exported as ``accel.sanitize``) that checks the
  same contract dynamically: NaN/Inf at dispatch boundaries and host
  syncs, ADC saturation and B_y overflow counters, BlockAllocator leak
  audits, VDD-corner validity.

The lint half is pure stdlib (ast); the sanitizer imports torch and
numpy only, so every hook site in :mod:`repro_torch.core` /
:mod:`repro_torch.accel` / :mod:`repro_torch.serve` can import this
package without cycles.
"""
from .findings import Finding, RULES, explain
from .runner import lint_paths, lint_source
from .sanitize import SanitizeError, Sanitizer, SanitizerStats, active, \
    sanitize

__all__ = [
    "Finding", "RULES", "explain", "lint_paths", "lint_source",
    "SanitizeError", "Sanitizer", "SanitizerStats", "active", "sanitize",
]
