"""The auto-tuner: trace once, reprice the whole design space, pick the
serving config.  Port of ``repro.tune.tuner``.

:func:`tune` runs the LM loop: compile the baseline program, trace ONE
eager decode step (the single network execution the tuner ever performs),
then hand the captured records to :class:`~repro_torch.tune.reprice.
TraceCostModel` and sweep every :class:`~repro_torch.tune.space.Candidate`
analytically.  The result carries the Pareto frontier (energy/token vs
throughput vs quality — the paper's Fig. 10/11 axes at serving scale) and
a :class:`TunedConfig` that :class:`repro_torch.serve.engine.ServeConfig`
consumes directly (``ServeConfig.from_tuned``).

:func:`tune_cifar` is the same selection loop over the paper's CIFAR
topologies, priced through the closed-form :func:`repro_torch.core.energy.
network_cost` (no trace needed — the topology IS the record stream) with
the paper's measured accuracies as the default quality table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import accel
from repro_torch.core import energy as E
from repro_torch.tree import leaves

from .frontier import pareto_frontier, select_best
from .quality import NullQuality
from .reprice import TraceCostModel
from .space import Candidate, DesignSpace, lm_space


def _fold_skip(policy, skip: bool):
    """Stamp a candidate's plane-skip flag into every spec of ``policy``
    (what the execution path actually reads)."""
    return dataclasses.replace(
        policy,
        rules=tuple((p, s.with_(skip_zero_planes=skip))
                    for p, s in policy.rules),
        default=policy.default.with_(skip_zero_planes=skip))


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """The tuner's output: every knob a serving deployment needs, in the
    vocabulary the rest of the stack already speaks.

    ``apply_model(cfg)`` returns the arch config to run the model under
    (policy + fused datapath); ``serve_config(...)`` builds the
    :class:`~repro_torch.serve.engine.ServeConfig` (capacity, mesh, double
    buffering) via ``ServeConfig.from_tuned``.  ``predicted`` carries the
    repriced metrics the choice was made on, so a deployment can check
    reality against the model.
    """

    policy: object                     # PrecisionPolicy
    vdd: float = 0.85
    capacity_chips: Optional[int] = None
    model_shards: int = 1
    data_shards: int = 1
    double_buffer: bool = True
    skip_zero_planes: bool = True
    fuse_datapath: bool = True
    label: str = ""
    predicted: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_candidate(cls, cand: Candidate, predicted: dict
                       ) -> "TunedConfig":
        return cls(policy=cand.policy, vdd=cand.vdd,
                   capacity_chips=cand.capacity_chips,
                   model_shards=cand.model_shards,
                   data_shards=cand.data_shards,
                   double_buffer=cand.double_buffer,
                   skip_zero_planes=cand.skip_zero_planes,
                   fuse_datapath=cand.fuse_datapath,
                   label=cand.label, predicted=dict(predicted))

    def candidate(self) -> Candidate:
        return Candidate(policy=self.policy, vdd=self.vdd,
                         capacity_chips=self.capacity_chips,
                         model_shards=self.model_shards,
                         data_shards=self.data_shards,
                         double_buffer=self.double_buffer,
                         skip_zero_planes=self.skip_zero_planes,
                         fuse_datapath=self.fuse_datapath,
                         label=self.label)

    def apply_model(self, cfg):
        """``cfg`` rewritten to this config's policy / plane-skip /
        datapath fusion (the model-side knobs)."""
        return dataclasses.replace(
            cfg, policy=_fold_skip(self.policy, self.skip_zero_planes),
            fuse_datapath=self.fuse_datapath)

    def serve_config(self, **kw):
        """A :class:`~repro_torch.serve.engine.ServeConfig` for this
        choice (extra keywords pass through, e.g. ``max_seq``)."""
        from repro_torch.serve.engine import ServeConfig

        return ServeConfig.from_tuned(self, **kw)


@dataclasses.dataclass
class TuneResult:
    """Everything a tuning run decided, plus the evidence.

    ``points[0]`` is always the baseline; ``frontier`` indexes into
    ``points``; ``network_executions`` counts actual network runs (the
    trace) — the invariant the tests pin is that it stays 1 no matter
    how many candidates were priced.
    """

    points: list
    frontier: list
    best_index: int
    best: TunedConfig
    network_executions: int
    candidates_priced: int
    quality_model: str = "none"
    objective: str = "tokens_per_mcycle"

    @property
    def default_point(self) -> dict:
        return self.points[0]

    @property
    def best_point(self) -> dict:
        return self.points[self.best_index]

    def speedup(self, metric: Optional[str] = None) -> float:
        m = metric or self.objective
        return self.best_point[m] / self.default_point[m]

    def to_json(self, top: int = 0) -> dict:
        """JSON-able report (``top`` > 0 additionally lists the top-N
        points by the objective, for compact artifacts)."""
        strip = lambda p: {k: v for k, v in p.items() if k != "summary"}
        out = {
            "objective": self.objective,
            "quality_model": self.quality_model,
            "network_executions": self.network_executions,
            "candidates_priced": self.candidates_priced,
            "default": strip(self.default_point),
            "chosen": strip(self.best_point),
            "speedup": self.speedup(),
            "frontier": [strip(self.points[i]) for i in self.frontier],
        }
        if top:
            order = sorted(range(len(self.points)),
                           key=lambda i: self.points[i][self.objective],
                           reverse=True)
            out["top"] = [strip(self.points[i]) for i in order[:top]]
        return out


def decode_tokens(seed: int, batch: int, vocab: int, device):
    """The traced decode step's tokens: ``batch`` ids in ``[1, vocab)``
    from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(1, vocab, (batch,), generator=gen, device=device)


def tune(params, cfg, default: Candidate, space: Optional[DesignSpace] = None,
         batch: int = 4, quality=None, quality_tol: float = 0.5,
         objective: str = "tokens_per_mcycle",
         chip_budget: Optional[int] = None, seed: int = 0) -> TuneResult:
    """Pick the serving config for ``params``/``cfg`` around ``default``.

    Executes the network exactly once: one batched decode step under the
    baseline's compiled program, on the device ``params`` lie on, inside
    ``accel.trace`` (the port runs eagerly, so the records carry measured
    sparsity/plane-skip data, as the reference's eager trace does); its
    tokens come from :func:`decode_tokens`.  Everything after is
    arithmetic: ``space`` (default :func:`~repro_torch.tune.space.
    lm_space` around ``default``) is swept through
    :class:`~repro_torch.tune.reprice.
    TraceCostModel`, scored by ``quality`` (default: no quality axis),
    and the winner is the highest-``objective`` point within
    ``quality_tol`` of the baseline's score (and ``chip_budget`` total
    macros, when given).

    The baseline's repriced cost is verified against
    ``energy_summary(trace)`` on the spot — if the identity rewrite ever
    drifts from the real cost model, tuning aborts rather than rank
    candidates on a broken ruler.
    """
    from repro_torch.models import decode_step, init_cache

    quality = quality or NullQuality()
    device = leaves(params)[0].device
    base_cfg = TunedConfig.from_candidate(default, {}).apply_model(cfg)
    program = accel.build_program(
        params, base_cfg, capacity_chips=default.capacity_chips,
        model_shards=default.model_shards, data_shards=1,
        double_buffer=default.double_buffer)
    installed = accel.install_program(params, program, base_cfg)
    cache = init_cache(base_cfg, batch, 16, device=device)
    tok = decode_tokens(seed, batch, base_cfg.vocab, device)
    with accel.trace(vdd=default.vdd) as records, torch.inference_mode():
        decode_step(installed, tok, cache, base_cfg)      # the ONE run
    network_executions = 1

    cm = TraceCostModel(
        records=records,
        footprints=accel.model_footprint(params, base_cfg),
        tokens_per_step=batch, baseline=default)

    default_point = cm.reprice(default)
    check = accel.energy_summary(records)    # corner from the Trace
    if default_point["summary"] != check:
        raise RuntimeError(
            "repriced baseline diverged from energy_summary(trace) — "
            "the identity-rewrite invariant broke; refusing to rank "
            f"candidates on a drifted cost model:\n"
            f"  repriced: {default_point['summary']}\n"
            f"  traced:   {check}")

    if space is None:
        space = lm_space(default, max_total_chips=chip_budget)
    points = [default_point]
    points.extend(cm.reprice(cand) for cand in space)
    for p, cand in zip(points, [default] + list(space)):
        p["label"] = cand.label or "default"
        p["quality"] = quality.score(cand, cm)
    floor = None
    if points[0]["quality"] is not None:
        floor = points[0]["quality"] - quality_tol
    front = pareto_frontier(points)
    best_i = select_best(points, objective=objective,
                         quality_key="quality", quality_floor=floor,
                         chip_budget=chip_budget)
    chosen = ([default] + list(space))[best_i]
    return TuneResult(
        points=points, frontier=front, best_index=best_i,
        best=TunedConfig.from_candidate(chosen, points[best_i]),
        network_executions=network_executions,
        candidates_priced=len(points),
        quality_model=quality.describe(), objective=objective)


# --------------------------------------------------------------- CIFAR

#: Measured task accuracies from the paper (Fig. 11): Network A is the
#: 4-b/4-b ADC-path deployment, Network B the 1-b/1-b ABN (BNN) path.
PAPER_CIFAR_ACCURACY = {("adc", 4, 4): 92.4, ("abn", 1, 1): 89.3}


@dataclasses.dataclass(frozen=True)
class CifarCandidate:
    """One analytic design point for a fixed CIFAR topology.

    ``sparsity`` is the uniform input-sparsity assumption of
    :func:`~repro_torch.core.energy.network_cost` (0.5 for the ReLU/ADC
    path, 0 for the zero-free binary ABN path); ``overhead_*`` the
    calibrated non-CIMU per-image work (the paper's measured Network-B
    throughput implies ~150k host cycles/image)."""

    ba: int
    bx: int
    vdd: float = 0.85
    readout: str = "adc"
    sparsity: float = 0.5
    overhead_cycles: float = 0.0
    overhead_energy_pj: float = 0.0
    label: str = ""

    def __post_init__(self):
        E.validate_vdd(self.vdd)

    def describe(self) -> dict:
        return {"label": self.label, "ba": self.ba, "bx": self.bx,
                "vdd": self.vdd, "readout": self.readout,
                "sparsity": self.sparsity}


def cifar_space(precisions: Sequence[tuple] = ((1, 1), (2, 2), (4, 4),
                                               (8, 8)),
                vdds: Sequence[float] = (1.2, 0.85),
                overhead_cycles_abn: float = 149500.0) -> list:
    """The Fig. 10/11 grid: every precision at both corners on the ADC
    path, plus the 1-b ABN (BNN) points.  ABN candidates carry zero
    input sparsity (binary XNOR activations have no zeros to gate) and
    the calibrated host-overhead cycles that dominate the BNN path."""
    out = []
    for vdd in vdds:
        for ba, bx in precisions:
            out.append(CifarCandidate(
                ba=ba, bx=bx, vdd=vdd, readout="adc", sparsity=0.5,
                label=f"adc{ba}b{bx}b/v{vdd}"))
        out.append(CifarCandidate(
            ba=1, bx=1, vdd=vdd, readout="abn", sparsity=0.0,
            overhead_cycles=overhead_cycles_abn,
            label=f"abn1b1b/v{vdd}"))
    return out


def tune_cifar(layers: Sequence, default: Optional[CifarCandidate] = None,
               candidates: Optional[Sequence[CifarCandidate]] = None,
               quality=None, quality_tol: float = 3.5,
               objective: str = "fps") -> TuneResult:
    """Frontier + selection over a CIFAR topology, priced in closed form.

    ``quality`` may be a quality model (``score(cand)``), a dict keyed
    ``(readout, ba, bx)``, or None for the paper's measured table
    (:data:`PAPER_CIFAR_ACCURACY` — points without a measurement score
    the table's minimum minus the tolerance, i.e. feasible only if
    nothing measured qualifies).  Default selection: the highest-fps
    point within ``quality_tol`` accuracy points of the baseline.
    """
    default = default or CifarCandidate(ba=4, bx=4, label="default")
    cands = list(candidates if candidates is not None else cifar_space())

    table = quality if isinstance(quality, dict) else (
        PAPER_CIFAR_ACCURACY if quality is None else None)
    fallback = (min(table.values()) - quality_tol) if table else None

    def score(c: CifarCandidate):
        if table is not None:
            return table.get((c.readout, c.ba, c.bx), fallback)
        return quality.score(c)

    def price(c: CifarCandidate) -> dict:
        cost = E.network_cost(
            layers, c.ba, c.bx, vdd=c.vdd, sparsity=c.sparsity,
            readout=c.readout, overhead_cycles=c.overhead_cycles,
            overhead_energy_pj=c.overhead_energy_pj)
        return {"candidate": c.describe(),
                "label": c.label or "default",
                "energy_uj": cost["energy_uj"],
                "cycles": cost["cycles"], "fps": cost["fps"],
                "quality": score(c)}

    points = [price(c) for c in [default] + cands]
    floor = None
    if points[0]["quality"] is not None:
        floor = points[0]["quality"] - quality_tol
    front = pareto_frontier(points, maximize=("fps",),
                            minimize=("energy_uj",))
    best_i = select_best(points, objective=objective,
                         quality_floor=floor)
    chosen = ([default] + cands)[best_i]
    best = TunedConfig(policy=None, vdd=chosen.vdd,
                       label=chosen.label or "default",
                       predicted=dict(points[best_i]))
    return TuneResult(points=points, frontier=front, best_index=best_i,
                      best=best, network_executions=0,
                      candidates_priced=len(points),
                      quality_model=("paper-table" if table is not None
                                     else quality.describe()),
                      objective=objective)
