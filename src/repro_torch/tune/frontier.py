"""Pareto frontier and config selection over priced design points.
Port of ``repro.tune.frontier``.

The paper's Fig. 10/11 story is exactly a frontier: energy/image vs
fps vs accuracy as precision and operating point move.  Here each priced
point is a dict carrying at least an energy metric (minimize), a
throughput metric (maximize) and optionally a quality score (maximize;
``None`` disables the axis for the whole set — mixing scored and
unscored points is rejected rather than silently mis-ranked).

Selection is throughput-greedy under a quality floor: the serving
deployment wants the fastest point that is not measurably worse than the
baseline's quality — the standard iso-accuracy reading of a
precision/energy trade-off curve.
"""
from __future__ import annotations

from typing import Optional, Sequence


def _axes(points: Sequence[dict], maximize, minimize, quality_key):
    """Per-point objective tuples (all maximized: minimized axes negate)."""
    has_q = [p.get(quality_key) is not None for p in points]
    if any(has_q) and not all(has_q):
        missing = [i for i, h in enumerate(has_q) if not h]
        raise ValueError(
            f"points {missing} carry no {quality_key!r} while others do; "
            "score all candidates with one quality model or none")
    use_q = all(has_q) and bool(points)
    out = []
    for p in points:
        ax = [p[k] for k in maximize] + [-p[k] for k in minimize]
        if use_q:
            ax.append(p[quality_key])
        out.append(tuple(ax))
    return out


def pareto_frontier(points: Sequence[dict],
                    maximize: Sequence[str] = ("tokens_per_s",),
                    minimize: Sequence[str] = ("uj_per_token",),
                    quality_key: str = "quality") -> list:
    """Indices of the non-dominated points (ascending).

    A point dominates another when it is >= on every axis and > on at
    least one.  Duplicate objective tuples all survive (neither
    dominates), so equivalent configs stay visible in the report.
    """
    ax = _axes(points, maximize, minimize, quality_key)
    keep = []
    for i, a in enumerate(ax):
        dominated = any(
            all(bj >= aj for aj, bj in zip(a, b))
            and any(bj > aj for aj, bj in zip(a, b))
            for j, b in enumerate(ax) if j != i)
        if not dominated:
            keep.append(i)
    return keep


def select_best(points: Sequence[dict],
                objective: str = "tokens_per_mcycle",
                quality_key: str = "quality",
                quality_floor: Optional[float] = None,
                chip_budget: Optional[int] = None) -> int:
    """Index of the highest-``objective`` point meeting the constraints.

    ``quality_floor`` drops points scoring below it (ignored for
    unscored sets); ``chip_budget`` drops points whose ``total_chips``
    exceeds it (points with unbounded capacity never pass a finite
    budget).  Raises if nothing qualifies — an empty feasible set is a
    configuration error the caller should see, not a silent fallback.
    """
    feasible = []
    for i, p in enumerate(points):
        q = p.get(quality_key)
        if quality_floor is not None and q is not None and q < quality_floor:
            continue
        if chip_budget is not None:
            chips = p.get("total_chips")
            if chips is None or chips > chip_budget:
                continue
        feasible.append(i)
    if not feasible:
        raise ValueError(
            f"no candidate meets quality_floor={quality_floor} / "
            f"chip_budget={chip_budget} out of {len(points)} points")
    return max(feasible, key=lambda i: points[i][objective])
