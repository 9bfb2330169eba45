"""PrecisionPolicy: layer-granular execution specs.

Port of ``repro.accel.policy``.  The paper demonstrates the same macro running 1-b and 4-b networks; real
deployments mix substrates *within* a model (first/last layers at higher
precision, FFN at 1-b, unembed digital — cf. the analog/digital SRAM-CIM
per-layer benchmarking of Houshmand et al., 2023).  A
``PrecisionPolicy`` expresses that heterogeneity as an ordered rule
table resolved per projection.

Rule patterns (all strings, keeping the policy hashable inside frozen
arch configs):

* ``"path:<glob>"``  — fnmatch against the projection path, e.g.
  ``"path:mlp.down"``, ``"path:attn.*"``, ``"path:unembed"``.
* ``"kind:<name>"``  — the block kind: ``attn``, ``mlp``, ``moe``,
  ``ssm``, ``rec``, ``conv``, ``fc``, ``unembed``.
* ``"layer:<i>"`` / ``"layer:<a>-<b>"`` — layer index or inclusive
  range.  Index rules resolve only where the index is static (CNN
  layers, unrolled prefix/suffix blocks); scanned transformer stacks are
  addressed by path/kind, which is what keeps one compiled layer body.
* ``"*"``            — everything.

Precedence: path > kind > layer > ``*`` > ``default``; within a class,
the first listed rule wins.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional

from .spec import ExecSpec

DIGITAL = ExecSpec(backend="digital")


def _match_rank(pattern: str, path: str, kind: str,
                layer: Optional[int]) -> Optional[int]:
    """Specificity rank of a match (lower wins), or None if no match."""
    if pattern == "*":
        return 3
    scheme, _, arg = pattern.partition(":")
    if scheme == "path":
        return 0 if path and fnmatch.fnmatchcase(path, arg) else None
    if scheme == "kind":
        return 1 if kind and kind == arg else None
    if scheme == "layer":
        lo, _, hi = arg.partition("-")
        try:
            lo_i = int(lo)
            hi_i = int(hi) if hi else lo_i
        except ValueError:
            raise ValueError(
                f"bad policy pattern {pattern!r}; layer rules are "
                "'layer:<i>' or 'layer:<a>-<b>'") from None
        if layer is None:
            return None
        return 2 if lo_i <= layer <= hi_i else None
    raise ValueError(
        f"bad policy pattern {pattern!r}; expected 'path:', 'kind:', "
        "'layer:' or '*'")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """An ordered ``(pattern, ExecSpec)`` table plus a default spec.

    The default default is pure digital, so an unconfigured model is the
    float baseline.
    """

    rules: tuple = ()                   # tuple[(pattern: str, ExecSpec)]
    default: ExecSpec = DIGITAL

    def __post_init__(self):
        object.__setattr__(
            self, "rules", tuple((str(p), s) for p, s in self.rules))
        for pattern, spec in self.rules:
            _match_rank(pattern, "x", "x", 0)   # validate pattern grammar
            if not isinstance(spec, ExecSpec):
                raise TypeError(f"rule {pattern!r}: spec must be ExecSpec")

    @classmethod
    def uniform(cls, spec: ExecSpec) -> "PrecisionPolicy":
        """Every managed projection runs under ``spec``."""
        return cls(default=spec)

    def resolve(self, path: str = "", kind: str = "",
                layer: Optional[int] = None) -> ExecSpec:
        """The spec governing one projection, tagged with its path."""
        best: Optional[ExecSpec] = None
        best_rank = 99
        for pattern, spec in self.rules:
            rank = _match_rank(pattern, path, kind, layer)
            if rank is not None and rank < best_rank:
                best, best_rank = spec, rank
        spec = best if best is not None else self.default
        return dataclasses.replace(spec, tag=path or kind)

    def resolver(self, kind: str):
        """A per-block resolve shorthand: ``sp = policy.resolver("attn")``
        then ``sp("attn.q")`` — the pattern every model module uses."""
        return lambda path, layer=None: self.resolve(path, kind=kind,
                                                     layer=layer)

    def with_rule(self, pattern: str, spec: ExecSpec) -> "PrecisionPolicy":
        """A copy with ``(pattern, spec)`` prepended (highest priority in
        its specificity class)."""
        return dataclasses.replace(
            self, rules=((pattern, spec),) + tuple(self.rules))
