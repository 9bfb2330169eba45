"""The serving design space: one :class:`Candidate` per configuration the
auto-tuner prices.  Port of ``repro.tune.space``.

A candidate bundles every knob the chip cost model reacts to — the VDD
corner, per-layer precisions (a full :class:`~repro_torch.accel.policy.
PrecisionPolicy`), the per-device bank budget, the 2D ``data x model``
serve-mesh shape, double-buffered streaming, the sparsity controller's
plane skip, and the fused near-memory epilogue — in one frozen value the
repricer (:mod:`repro_torch.tune.reprice`) can evaluate WITHOUT re-executing
the network.  :func:`lm_space` enumerates the default grid (a
lumos-style analytical sweep: every point is priced, none is run).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Sequence

from repro_torch.accel import ExecSpec, PrecisionPolicy
from repro_torch.core.energy import validate_vdd


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the serving design space.

    ``capacity_chips`` is the PER-DEVICE standing-allocation budget
    (590kb CIMA macros), exactly as :func:`~repro_torch.accel.program.
    plan_allocation` consumes it; ``None`` = unbounded.  The mesh shape
    is ``data_shards x model_shards`` (DESIGN.md §13): the model axis
    cuts images per :func:`~repro_torch.accel.program.partition_for`, the data
    axis replicates them and multiplies served batch rows.
    """

    policy: PrecisionPolicy
    vdd: float = 0.85
    capacity_chips: Optional[int] = None
    model_shards: int = 1
    data_shards: int = 1
    double_buffer: bool = True
    skip_zero_planes: bool = True
    fuse_datapath: bool = True
    label: str = ""

    def __post_init__(self):
        validate_vdd(self.vdd)
        if self.model_shards < 1 or self.data_shards < 1:
            raise ValueError(
                f"mesh shards must be >= 1, got "
                f"{self.data_shards}x{self.model_shards}")
        if self.capacity_chips is not None and self.capacity_chips < 1:
            raise ValueError(
                f"capacity_chips must be positive or None, "
                f"got {self.capacity_chips}")

    @property
    def devices(self) -> int:
        return self.model_shards * self.data_shards

    @property
    def total_chips(self) -> Optional[int]:
        """System-wide bank budget: per-device capacity x mesh size
        (None = unbounded).  What a fixed hardware budget constrains."""
        if self.capacity_chips is None:
            return None
        return self.capacity_chips * self.devices

    def describe(self) -> dict:
        """JSON-able description (for BENCH_tune.json / logs)."""
        return {
            "label": self.label,
            "vdd": self.vdd,
            "policy": _describe_policy(self.policy),
            "capacity_chips": self.capacity_chips,
            "mesh": f"{self.data_shards}x{self.model_shards}",
            "double_buffer": self.double_buffer,
            "skip_zero_planes": self.skip_zero_planes,
            "fuse_datapath": self.fuse_datapath,
        }


def _describe_policy(policy: PrecisionPolicy) -> dict:
    def spec(s: ExecSpec) -> str:
        return f"{s.backend}:ba{s.ba}bx{s.bx}"

    return {"default": spec(policy.default),
            "rules": [[p, spec(s)] for p, s in policy.rules]}


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """An enumerable set of candidates (plus the baseline they compare
    against)."""

    candidates: tuple
    default: Candidate

    def __len__(self) -> int:
        return len(self.candidates)

    def __iter__(self) -> Iterator[Candidate]:
        return iter(self.candidates)


def precision_policies(base: PrecisionPolicy,
                       precisions: Sequence[tuple],
                       mixed_kinds: Sequence[str] = ()) -> list:
    """Per-layer precision variants of ``base``:

    * one *uniform* policy per ``(ba, bx)`` in ``precisions`` (every
      managed projection moves together — the paper's whole-network 1-b
      and 4-b deployments), and
    * one *mixed* policy per ``(kind, (ba, bx))`` pair: the base
      precision everywhere except ``kind:<k>`` (Houshmand-style
      per-layer heterogeneity — e.g. 1-b FFN under a 4-b backbone).

    Backends/coding/banking are inherited from the base specs; only the
    bit widths move.
    """
    out = []
    for ba, bx in precisions:
        out.append(("u%db%db" % (ba, bx),
                    _rescale_policy(base, ba, bx)))
    for kind in mixed_kinds:
        for ba, bx in precisions:
            if (ba, bx) == (base.default.ba, base.default.bx):
                continue
            spec = base.default.with_(ba=ba, bx=bx)
            out.append((f"{kind}{ba}b{bx}b",
                        base.with_rule(f"kind:{kind}", spec)))
    return out


def _rescale_policy(base: PrecisionPolicy, ba: int, bx: int
                    ) -> PrecisionPolicy:
    return PrecisionPolicy(
        rules=tuple((p, s.with_(ba=ba, bx=bx)) for p, s in base.rules),
        default=base.default.with_(ba=ba, bx=bx))


def lm_space(default: Candidate,
             precisions: Sequence[tuple] = ((1, 1), (2, 2), (4, 4), (8, 8)),
             mixed_kinds: Sequence[str] = ("attn", "mlp"),
             vdds: Sequence[float] = (1.2, 0.85),
             capacities: Sequence[Optional[int]] = (2, 4, 8),
             meshes: Sequence[tuple] = ((1, 1), (1, 2), (1, 4), (2, 2),
                                        (1, 8), (2, 4)),
             double_buffer: Sequence[bool] = (True, False),
             skip_zero_planes: Sequence[bool] = (True,),
             fuse_datapath: Sequence[bool] = (True, False),
             max_total_chips: Optional[int] = None) -> DesignSpace:
    """The default LM serving grid around ``default`` (its policy seeds
    the precision variants).  Mesh tuples are ``(data, model)``.

    ``max_total_chips`` constrains the SYSTEM bank budget
    (``capacity_chips x data x model``): a tuner allowed to conjure
    arbitrarily many macros would trivially "win" by buying hardware, so
    a fixed budget makes mesh shape vs per-device capacity a real
    trade-off.  Candidates with unbounded capacity are excluded when a
    budget is set.
    """
    policies = precision_policies(default.policy, precisions, mixed_kinds)
    cands = []
    for ((plabel, policy), vdd, cap, (dsh, msh), db, skip, fused) in \
            itertools.product(policies, vdds, capacities, meshes,
                              double_buffer, skip_zero_planes,
                              fuse_datapath):
        if max_total_chips is not None:
            if cap is None or cap * dsh * msh > max_total_chips:
                continue
        cands.append(Candidate(
            policy=policy, vdd=vdd, capacity_chips=cap,
            model_shards=msh, data_shards=dsh, double_buffer=db,
            skip_zero_planes=skip, fuse_datapath=fused,
            label=f"{plabel}/v{vdd}/c{cap}/{dsh}x{msh}"
                  f"{'' if db else '/sync'}{'' if skip else '/noskip'}"
                  f"{'' if fused else '/unfused'}"))
    return DesignSpace(candidates=tuple(cands), default=default)
