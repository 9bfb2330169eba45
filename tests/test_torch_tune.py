"""The port's design-space auto-tuner (``repro_torch.tune``) against the
JAX package's ``repro.tune``.

Two parts, on reduced olmo-1b (the reference's ``init_params`` converted
key for key) on ``bpbs`` at batch 2, on the CPU:

* the reference's ``tests/test_tune.py``, test by test, on the port:
  trace-once, the exactness suite (the repriced baseline equals
  ``energy_summary(trace)`` float for float; repriced capacity, mesh,
  double-buffer and corner candidates equal a real re-trace), the
  allocator against ``build_program``, the frontier and selection, the
  quality axes, the tuned config driving ``Engine``, ``tune_cifar``;
* parity with the reference on the same numpy parameters and tokens:
  the traced decode step's records field for field (the port's layers
  gathered per tag as the reference's scan records them), every
  candidate of
  ``lm_space(default, max_total_chips=16)`` repriced float for float
  from shared records (the reference's ``pallas`` named ``kernel``, as
  ``test_torch_energy.py`` maps it) with the same pick,
  ``plan_allocation``/``build_program`` placements, ``tune(...).to_json``
  against the reference's ``tune`` on the port's trace (the port's token
  draw replaced by the reference's tokens), SQNR
  scores within rtol 1e-6 (and 1e-5 dB) on the reference's operands
  (two float32 means summed in another order), ``tune_cifar`` and
  ``CifarQuality``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accel as jaccel
from repro import tune as jtune
from repro.configs import get_config as jget
from repro.configs.cifar_nets import NETWORK_B as J_NET_B
from repro.core import energy as JE
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models.cnn import init_cnn as jinit_cnn
from repro.tune.space import _rescale_policy as j_rescale
from repro_torch import accel, tune
from repro_torch.configs import NETWORK_B as T_NET_B
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core import energy as E
from repro_torch.models import decode_step, init_cache
from repro_torch.tune import quality as tquality
from repro_torch.tune import tuner as ttuner
from repro_torch.tune.space import _rescale_policy

BATCH = 2
PORT_BACKEND = {"digital_int": "digital_int", "bpbs": "bpbs",
                "bpbs_ref": "bpbs_ref", "pallas": "kernel",
                "digital": "digital"}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    """(jax cfg, port cfg, jax params, port params) at reduced size."""
    jc = jget("olmo-1b").reduced().with_accel("bpbs", ba=4, bx=4)
    tc = tget("olmo-1b").reduced().with_accel("bpbs", ba=4, bx=4)
    pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return jc, tc, pj, pt


@pytest.fixture(scope="module")
def lm(both):
    return both[1], both[3]


def _ref_tokens(vocab: int, batch: int = BATCH, seed: int = 0) -> np.ndarray:
    """The reference tuner's decode tokens."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (batch,),
                                         1, vocab, jnp.int32))


def _trace_one_step(cfg, params, cand: tune.Candidate, batch: int = BATCH):
    """Ground truth: rebuild the program at ``cand`` and trace one decode
    step (same token per data replica, like the repricer models)."""
    base = tune.TunedConfig.from_candidate(cand, {}).apply_model(cfg)
    prog = accel.build_program(
        params, base, capacity_chips=cand.capacity_chips,
        model_shards=cand.model_shards, data_shards=cand.data_shards,
        double_buffer=cand.double_buffer)
    installed = accel.install_program(params, prog, base)
    tok = torch.from_numpy(np.concatenate(
        [_ref_tokens(base.vocab, batch)] * cand.data_shards)).long()
    cache = init_cache(base, batch * cand.data_shards, 16, device="cpu")
    with accel.trace(vdd=cand.vdd) as records, torch.inference_mode():
        decode_step(installed, tok, cache, base)
    return records


def _jtrace_one_step(cfg, params, cand, batch: int = BATCH):
    """The reference test's ``_trace_one_step``."""
    base = jtune.TunedConfig.from_candidate(cand, {}).apply_model(cfg)
    prog = jaccel.build_program(
        params, base, capacity_chips=cand.capacity_chips,
        model_shards=cand.model_shards, data_shards=cand.data_shards,
        double_buffer=cand.double_buffer)
    installed = jaccel.install_program(params, prog, base)
    tok = jnp.concatenate([jnp.asarray(_ref_tokens(base.vocab, batch))]
                          * cand.data_shards)
    cache = jinit_cache(base, batch * cand.data_shards, 16)
    with jaccel.trace(vdd=cand.vdd) as records:
        jdecode(installed, tok, cache, base)
    return records


@pytest.fixture(scope="module")
def traced(lm):
    cfg, params = lm
    default = tune.Candidate(policy=cfg.policy, capacity_chips=4)
    records = _trace_one_step(cfg, params, default)
    cm = tune.TraceCostModel(
        records=records,
        footprints=accel.model_footprint(params, cfg),
        tokens_per_step=BATCH, baseline=default)
    return cm, records, default


@pytest.fixture(scope="module")
def jtraced(both):
    jc, _, pj, _ = both
    default = jtune.Candidate(policy=jc.policy, capacity_chips=4)
    records = _jtrace_one_step(jc, pj, default)
    cm = jtune.TraceCostModel(
        records=records, footprints=jaccel.model_footprint(pj, jc),
        tokens_per_step=BATCH, baseline=default)
    return cm, records, default


# ------------------------------------------------------------ trace-once

def test_sweep_traces_network_exactly_once(lm, monkeypatch):
    """>= 500 design points priced, ``accel.trace`` entered once."""
    import repro_torch.accel.context as C

    cfg, params = lm
    calls = {"n": 0}
    real = C.trace

    def counting(vdd=None):
        calls["n"] += 1
        return real(vdd=vdd)

    monkeypatch.setattr(C, "trace", counting)
    monkeypatch.setattr(accel, "trace", counting)
    res = tune.tune(params, cfg,
                    tune.Candidate(policy=cfg.policy, capacity_chips=4),
                    batch=BATCH, chip_budget=16)
    assert res.candidates_priced >= 500
    assert calls["n"] == 1
    assert res.network_executions == 1
    assert res.points[0]["label"] == "default"
    assert res.best_index in range(len(res.points))
    assert res.best_point["tokens_per_mcycle"] \
        > res.default_point["tokens_per_mcycle"]


# ------------------------------------------------------------- exactness

def test_reprice_default_is_exact(traced):
    """Identity rewrite: the baseline's repriced summary == the real
    energy_summary of the trace, every key, float for float."""
    cm, records, default = traced
    repriced = cm.reprice(default)
    truth = accel.energy_summary(records)
    assert repriced["summary"] == truth
    assert truth["vdd"] == 0.85


@pytest.mark.parametrize("kw", [
    dict(capacity_chips=8),
    dict(capacity_chips=2),
    dict(capacity_chips=2, double_buffer=False),
    dict(capacity_chips=2, model_shards=4),
    dict(capacity_chips=2, model_shards=2, data_shards=2),
    dict(capacity_chips=4, vdd=1.2),
])
def test_reprice_matches_real_retrace(lm, traced, kw):
    """Repriced candidate == energy_summary of the network actually
    rebuilt and re-traced at that design point (a partitioned image runs
    whole on one device, its records carry the partition)."""
    cfg, params = lm
    cm, _, _ = traced
    cand = tune.Candidate(policy=cfg.policy, **kw)
    predicted = cm.reprice(cand)["summary"]
    truth = accel.energy_summary(_trace_one_step(cfg, params, cand))
    assert predicted == truth


def test_reprice_matches_retrace_at_new_ba(lm, traced):
    """B_A moves tile geometry: every allocator-driven term matches an
    8-b/4-b re-trace exactly; the totals, which fold in measured input
    sparsity of re-quantized deeper layers, within 0.1%."""
    cfg, params = lm
    cm, _, _ = traced
    policy = _rescale_policy(cfg.policy, 8, 4)
    cand = tune.Candidate(policy=policy, capacity_chips=4)
    predicted = cm.reprice(cand)["summary"]
    truth = accel.energy_summary(_trace_one_step(cfg, params, cand))
    for k in ("load_pj", "load_cycles", "load_cycles_hidden",
              "load_cycles_exposed", "post_pj", "vdd"):
        assert predicted[k] == truth[k], k
    assert predicted["total_pj"] == pytest.approx(truth["total_pj"],
                                                  rel=1e-3)
    assert predicted["total_cycles"] == pytest.approx(
        truth["total_cycles"], rel=1e-3)


def test_reprice_input_precision_direction(traced):
    """1-b input serial steps cost fewer cycles and less energy than the
    4-b baseline."""
    cm, _, default = traced
    lo = cm.reprice(tune.Candidate(
        policy=_rescale_policy(default.policy, 1, 1), capacity_chips=4))
    hi = cm.reprice(default)
    assert lo["pj_per_step"] < hi["pj_per_step"]
    assert lo["cycles_per_step"] < hi["cycles_per_step"]


def test_baseline_must_trace_at_data_shards_one(traced):
    cm, records, _ = traced
    with pytest.raises(ValueError, match="data_shards=1"):
        tune.TraceCostModel(
            records=records, footprints=cm.footprints,
            tokens_per_step=BATCH,
            baseline=tune.Candidate(policy=cm.baseline.policy,
                                    data_shards=2))


# ------------------------------------------------- allocator factoring

@pytest.mark.parametrize("capacity,shards", [
    (None, 1), (2, 1), (4, 1), (8, 1), (2, 4), (4, 2),
])
def test_plan_allocation_matches_build_program(lm, capacity, shards):
    """One allocator: the tuner's plan and the compiled program agree on
    residency, partition, devices and per-device segment counts."""
    cfg, params = lm
    plan = accel.plan_allocation(
        accel.model_footprint(params, cfg), cfg.policy,
        capacity_chips=capacity, model_shards=shards)
    prog = accel.build_program(params, cfg, capacity_chips=capacity,
                               model_shards=shards)
    assert set(plan) == set(prog.images)
    for path, pl in plan.items():
        img = prog.images[path]
        assert pl.resident == img.resident, path
        assert pl.partition == img.partition, path
        assert pl.devices == img.devices, path
        assert pl.tiles == img.tiles, path
        assert pl.segments == img.segments, path
        assert pl.footprint.copies == img.copies, path


def test_duplicate_tags_rejected(traced):
    cm, records, default = traced
    fp = cm.footprints[0]
    with pytest.raises(ValueError, match="unique"):
        tune.TraceCostModel(records=records,
                            footprints=list(cm.footprints) + [fp],
                            tokens_per_step=BATCH, baseline=default)


# ------------------------------------------------------- corner plumbing

def test_trace_vdd_threads_into_summary():
    x = torch.ones((2, 64))
    w = torch.ones((64, 8))
    spec = accel.ExecSpec(backend="bpbs", ba=4, bx=4, tag="t")
    with accel.trace(vdd=1.2) as records:
        accel.matmul(x, w, spec)
    es = accel.energy_summary(records)
    assert es["vdd"] == 1.2
    assert accel.energy_summary(records, vdd=0.85)["vdd"] == 0.85
    assert es["total_pj"] != accel.energy_summary(records,
                                                  vdd=0.85)["total_pj"]


def test_invalid_vdd_rejected_everywhere():
    with pytest.raises(ValueError, match="supply corner"):
        with accel.trace(vdd=1.0):
            pass
    with accel.trace() as records:
        accel.matmul(torch.ones((1, 8)), torch.ones((8, 4)),
                     accel.ExecSpec(backend="bpbs", tag="t"))
    with pytest.raises(ValueError, match="supply corner"):
        accel.energy_summary(records, vdd=0.9)
    with pytest.raises(ValueError, match="supply corner"):
        tune.Candidate(policy=accel.PrecisionPolicy(), vdd=1.0)
    with pytest.raises(ValueError, match="supply corner"):
        tune.CifarCandidate(ba=4, bx=4, vdd=0.7)


# ------------------------------------------------------------- frontier

def test_pareto_frontier_non_domination():
    pts = [
        {"tokens_per_s": 10.0, "uj_per_token": 1.0, "quality": 0.9},
        {"tokens_per_s": 20.0, "uj_per_token": 2.0, "quality": 0.9},
        {"tokens_per_s": 5.0, "uj_per_token": 2.0, "quality": 0.9},
        {"tokens_per_s": 20.0, "uj_per_token": 2.0, "quality": 0.5},
        {"tokens_per_s": 1.0, "uj_per_token": 0.1, "quality": 0.1},
    ]
    assert tune.pareto_frontier(pts) == [0, 1, 4]


def test_frontier_rejects_mixed_quality():
    pts = [{"tokens_per_s": 1.0, "uj_per_token": 1.0, "quality": 0.9},
           {"tokens_per_s": 2.0, "uj_per_token": 1.0, "quality": None}]
    with pytest.raises(ValueError, match="quality"):
        tune.pareto_frontier(pts)


def test_select_best_quality_floor_and_budget():
    pts = [
        {"tokens_per_mcycle": 10.0, "quality": 0.9, "total_chips": 4},
        {"tokens_per_mcycle": 50.0, "quality": 0.2, "total_chips": 4},
        {"tokens_per_mcycle": 30.0, "quality": 0.9, "total_chips": 4},
        {"tokens_per_mcycle": 40.0, "quality": 0.9, "total_chips": 64},
        {"tokens_per_mcycle": 45.0, "quality": 0.9, "total_chips": None},
    ]
    assert tune.select_best(pts, quality_floor=0.8, chip_budget=16) == 2
    assert tune.select_best(pts, quality_floor=0.8) == 4
    assert tune.select_best(pts) == 1
    with pytest.raises(ValueError, match="no candidate"):
        tune.select_best(pts, quality_floor=0.99)


def test_lm_space_size_and_budget():
    default = tune.Candidate(
        policy=accel.PrecisionPolicy(
            default=accel.ExecSpec(backend="bpbs", ba=4, bx=4)))
    space = tune.lm_space(default)
    assert len(space) >= 500
    budgeted = tune.lm_space(default, max_total_chips=16)
    assert 500 <= len(budgeted) < len(space)
    assert all(c.total_chips is not None and c.total_chips <= 16
               for c in budgeted)


# --------------------------------------------------------- quality axis

def test_sqnr_quality_monotone_and_cached(traced):
    cm, _, default = traced
    q = tune.SqnrQuality(device="cpu")
    lo = q.score(tune.Candidate(policy=_rescale_policy(default.policy, 1, 1)),
                 cm)
    hi = q.score(default, cm)
    assert lo < hi
    n_cached = len(q._cache)
    assert q.score(default, cm) == hi
    assert len(q._cache) == n_cached


# ------------------------------------------------ serving integration

def test_tuned_config_drives_engine(lm):
    """The tuner's output plugs straight into Engine: apply_model +
    ServeConfig.from_tuned, then a real generate call."""
    from repro_torch.serve.engine import Engine

    cfg, params = lm
    default = tune.Candidate(policy=cfg.policy, capacity_chips=4)
    space = tune.lm_space(
        default, precisions=((4, 4),), mixed_kinds=(), vdds=(0.85,),
        capacities=(2, 8), meshes=((1, 1),), double_buffer=(True,),
        fuse_datapath=(True,))
    res = tune.tune(params, cfg, default, space=space, batch=BATCH)
    tuned = res.best
    assert isinstance(tuned, tune.TunedConfig)
    assert tuned.predicted["tokens_per_mcycle"] \
        == res.best_point["tokens_per_mcycle"]

    cfg2 = tuned.apply_model(cfg)
    scfg = tuned.serve_config(max_seq=32, max_new_tokens=4)
    assert scfg.cima_chips == tuned.capacity_chips
    assert scfg.stream_double_buffer == tuned.double_buffer
    eng = Engine(params, cfg2, scfg, device="cpu")
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(1, cfg.vocab, (2, 4)))
    out = eng.generate(prompts)
    assert out.shape == (2, 4)


def test_serve_config_from_tuned_mesh_validation():
    """The reference's mesh-shape refusals: without a mesh and with a
    mesh of another shape; a mesh of the tuned shape gives a config that
    carries it (and the tuned data axis's ShardPolicy); explicit
    keywords override the tuned values on the 1x1 path."""
    from repro_torch.distributed.sharding import ShardPolicy
    from repro_torch.launch.mesh import ServeMesh
    from repro_torch.serve.engine import ServeConfig

    tuned = tune.TunedConfig(policy=accel.PrecisionPolicy(),
                             capacity_chips=2, data_shards=2,
                             model_shards=2)
    with pytest.raises(ValueError, match="mesh"):
        ServeConfig.from_tuned(tuned)
    with pytest.raises(ValueError, match="priced at 2x2"):
        ServeConfig.from_tuned(tuned, mesh=ServeMesh(data=1, model=4))
    mesh = ServeMesh(data=2, model=2)
    scfg = ServeConfig.from_tuned(tuned, mesh=mesh, max_seq=64)
    assert scfg.mesh is mesh and scfg.cima_chips == 2
    assert scfg.shard_policy == ShardPolicy(data_shards=2)
    flat = tune.TunedConfig(policy=accel.PrecisionPolicy(),
                            capacity_chips=2, double_buffer=False)
    scfg = ServeConfig.from_tuned(flat, max_seq=64)
    assert scfg.cima_chips == 2 and not scfg.stream_double_buffer
    assert ServeConfig.from_tuned(flat, cima_chips=8).cima_chips == 8


# ----------------------------------------------------------------- CIFAR

def test_tune_cifar_agrees_with_network_cost_headlines():
    """Network A 105.2 uJ / 23 fps (4b/4b ADC @ 0.85 V), Network B 5.31
    uJ / 176 fps (1b ABN) through the same network_cost."""
    res_a = tune.tune_cifar(E.NETWORK_A)
    by_label = {p["label"]: p for p in res_a.points}
    a = by_label["adc4b4b/v0.85"]
    exact = E.network_cost(E.NETWORK_A, 4, 4, vdd=0.85, sparsity=0.5)
    assert a["energy_uj"] == exact["energy_uj"]
    assert a["fps"] == exact["fps"]
    assert abs(a["energy_uj"] - 105.2) / 105.2 < 0.10
    assert abs(a["fps"] - 23.0) / 23.0 < 0.10
    assert a["quality"] == tune.PAPER_CIFAR_ACCURACY[("adc", 4, 4)]

    res_b = tune.tune_cifar(E.NETWORK_B)
    b = {p["label"]: p for p in res_b.points}["abn1b1b/v0.85"]
    exact_b = E.network_cost(E.NETWORK_B, 1, 1, vdd=0.85, sparsity=0.0,
                             readout="abn", overhead_cycles=149500)
    assert b["fps"] == exact_b["fps"]
    assert abs(b["fps"] - 176.0) / 176.0 < 0.05
    assert b["quality"] == tune.PAPER_CIFAR_ACCURACY[("abn", 1, 1)]


def test_tune_cifar_selection_respects_quality_floor():
    res = tune.tune_cifar(E.NETWORK_A)
    assert res.best_point["fps"] >= res.default_point["fps"]
    floor = res.default_point["quality"] - 3.5
    assert res.best_point["quality"] >= floor
    tight = tune.tune_cifar(E.NETWORK_A, quality_tol=1.0)
    assert tight.best_point["quality"] >= tight.default_point["quality"] - 1.0
    assert tight.best_point["candidate"]["readout"] == "adc"


def _cifar_inputs():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (8,)).astype(np.int32)
    return images, labels


def test_cifar_quality_exact_eval():
    """The exact-accuracy axis runs the port's CNN under the candidate
    policy and caches per policy signature."""
    from repro_torch.models.cnn import init_cnn

    net = T_NET_B.reduced()
    params = init_cnn(0, net, device="cpu")
    images, labels = _cifar_inputs()
    q = tune.CifarQuality(params=params, net=net,
                          images=torch.from_numpy(images),
                          labels=torch.from_numpy(labels).long())
    acc = q.score(tune.CifarCandidate(ba=1, bx=1, readout="abn"))
    assert 0.0 <= acc <= 1.0
    assert q.score(tune.CifarCandidate(ba=1, bx=1, readout="abn")) == acc
    assert len(q._cache) == 1


# ------------------------------------------------ parity with repro.tune

def _port_record(r):
    """A reference MvmRecord as the port's (backend named as the port
    names it)."""
    fields = {f.name: getattr(r, f.name)
              for f in dataclasses.fields(accel.MvmRecord)}
    fields["backend"] = PORT_BACKEND[fields["backend"]]
    return accel.MvmRecord(**fields)


def _port_point(p):
    """A reference point with its summary's backend names mapped."""
    p = dict(p)
    s = dict(p["summary"])
    s["by_tag"] = {PORT_BACKEND.get(k, k): dict(
        row, backend=PORT_BACKEND[row["backend"]])
        for k, row in s["by_tag"].items()}
    p["summary"] = s
    return p


def test_record_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(accel.MvmRecord)] == \
        [f.name for f in dataclasses.fields(jaccel.MvmRecord)]


def _as_scanned(records):
    """The port's per-layer records of one decode step as the reference's
    ``lax.scan`` body records them: one record per tag (in first-seen
    order) with ``calls``, ``loads``, ``load_prologue`` and ``copies``
    summed over the layers, and no measured sparsity or plane skips where
    the layers were stacked (the scan body sees tracers)."""
    groups: dict = {}
    for r in records:
        groups.setdefault(r.tag, []).append(r)
    out = []
    for rs in groups.values():
        r = rs[0]
        if len(rs) > 1:
            r = dataclasses.replace(
                r, calls=sum(x.calls for x in rs),
                loads=sum(x.loads for x in rs),
                load_prologue=sum(x.load_prologue for x in rs),
                copies=sum(x.copies for x in rs), sparsity=None,
                planes_skipped=None, planes_total=None)
        out.append(r)
    return out


def test_traced_decode_step_records_equal_reference(traced, jtraced):
    """One decode step traced in each package on the same parameters and
    tokens.  The port runs its layers one by one and measures every
    dispatch (29 records); the reference scans the stacked layers (8
    records, the scanned ones unmeasured).  Gathered per tag as the scan
    records them, the port's records equal the reference's field for
    field, and the unembed's measured sparsity and plane skips are
    equal."""
    _, trec, _ = traced
    _, jrec, _ = jtraced
    assert len(trec) == 4 * 7 + 1 and len(jrec) == 7 + 1
    assert _as_scanned(trec) == [_port_record(r) for r in jrec]
    assert trec[-1] == _port_record(jrec[-1])
    assert trec[-1].sparsity is not None
    assert all(r.sparsity is not None and r.planes_total for r in trec)
    assert trec.vdd == jrec.vdd


def test_reprice_every_candidate_equals_reference(traced, jtraced):
    """The default and every candidate of ``lm_space(default,
    max_total_chips=16)`` repriced from the same records in both
    packages: equal points, float for float; the same pick."""
    tcm, _, tdef = traced
    jcm, jrec, jdef = jtraced
    shared = tune.TraceCostModel(
        records=[_port_record(r) for r in jrec], footprints=tcm.footprints,
        tokens_per_step=BATCH, baseline=tdef)
    assert [dataclasses.astuple(f) for f in shared.footprints] == \
        [dataclasses.astuple(f) for f in jcm.footprints]
    tspace = tune.lm_space(tdef, max_total_chips=16)
    jspace = jtune.lm_space(jdef, max_total_chips=16)
    assert [c.label for c in tspace] == [c.label for c in jspace]
    tpts = [shared.reprice(c) for c in [tdef] + list(tspace)]
    jpts = [jcm.reprice(c) for c in [jdef] + list(jspace)]
    assert len(tpts) == 961
    for tp, jp in zip(tpts, jpts):
        assert tp == _port_point(jp), tp["candidate"]["label"]
    for p, c in zip(tpts, [tdef] + list(tspace)):
        p["total_chips"] = c.total_chips
    assert tune.select_best(tpts, chip_budget=16) == \
        jtune.select_best(jpts, chip_budget=16)


@pytest.mark.parametrize("capacity,shards", [
    (None, 1), (2, 1), (4, 1), (8, 1), (2, 4), (4, 2),
])
def test_placements_equal_reference(both, capacity, shards):
    """``plan_allocation`` and ``build_program``'s placements and summary
    equal the reference's at the same (capacity, shards)."""
    jc, tc, pj, pt = both
    tplan = accel.plan_allocation(accel.model_footprint(pt, tc), tc.policy,
                                  capacity_chips=capacity,
                                  model_shards=shards, data_shards=2)
    jplan = jaccel.plan_allocation(jaccel.model_footprint(pj, jc),
                                   jc.policy, capacity_chips=capacity,
                                   model_shards=shards, data_shards=2)
    key = lambda pl: (pl.footprint.path, pl.partition, pl.devices,  # noqa
                      pl.tiles, pl.segments, pl.resident, pl.overlap,
                      pl.data_shards)
    assert [key(p) for p in tplan.values()] == \
        [key(p) for p in jplan.values()]
    tp = accel.build_program(pt, tc, capacity_chips=capacity,
                             model_shards=shards, data_shards=2)
    jp = jaccel.build_program(pj, jc, capacity_chips=capacity,
                              model_shards=shards, data_shards=2)
    assert tp.summary() == jp.summary()
    for k, ti in tp.images.items():
        ji = jp.images[k]
        assert (ti.tiles, ti.segments, ti.resident, ti.overlap, ti.copies,
                ti.partition, ti.devices, ti.data_shards) == \
            (ji.tiles, ji.segments, ji.resident, ji.overlap, ji.copies,
             ji.partition, ji.devices, ji.data_shards), k


def test_tune_to_json_equals_reference(both, monkeypatch):
    """The reference's ``tune`` run on the port's traced decode step (its
    trace scope handing back the port's records) gives the port's
    ``tune(...).to_json(top=5)`` float for float over the 961 points: the
    port's allocator, repricing, frontier and selection are the
    reference's.  The port's token draw is replaced by the reference's
    tokens."""
    import contextlib

    import repro.models as jmodels

    jc, tc, pj, pt = both
    monkeypatch.setattr(ttuner, "decode_tokens",
                        lambda seed, batch, vocab, device: torch.from_numpy(
                            _ref_tokens(vocab, batch, seed)).long())
    real, seen = accel.trace, []

    @contextlib.contextmanager
    def keep(vdd=None):
        with real(vdd=vdd) as records:
            seen.append(records)
            yield records

    monkeypatch.setattr(accel, "trace", keep)
    tres = tune.tune(pt, tc, tune.Candidate(policy=tc.policy,
                                            capacity_chips=4),
                     batch=BATCH, chip_budget=16)
    (trec,) = seen

    @contextlib.contextmanager
    def replay(vdd=None):
        records = jaccel.Trace(vdd=vdd)
        records.extend(jaccel.MvmRecord(**{
            f.name: getattr(r, f.name)
            for f in dataclasses.fields(jaccel.MvmRecord)}) for r in trec)
        yield records

    monkeypatch.setattr(jaccel, "trace", replay)
    monkeypatch.setattr(jmodels, "decode_step", lambda *a, **k: None)
    jres = jtune.tune(pj, jc, jtune.Candidate(policy=jc.policy,
                                              capacity_chips=4),
                      batch=BATCH, chip_budget=16)
    assert tres.candidates_priced == jres.candidates_priced == 961
    assert tres.best_index == jres.best_index
    assert tres.best.label == jres.best.label
    assert tres.to_json(top=5) == jres.to_json(top=5)


def _ref_sqnr_operands(seed, batch, n, m, device):
    """The reference SqnrQuality's operands, as torch tensors."""
    kx, kw = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (batch, n), jnp.float32)
    w = jax.random.normal(kw, (n, m), jnp.float32) * n ** -0.5
    return (torch.from_numpy(np.array(x)).to(device),
            torch.from_numpy(np.array(w)).to(device))


def test_sqnr_scores_match_reference(traced, jtraced, monkeypatch):
    """SQNR scores of the uniform precisions within rtol 1e-6 of the
    reference's, on the reference's operands, and within 1e-5 dB where
    the score is near 0 dB: the 1-bit XNOR scales are float32 means
    summed in another order (one ulp), which moves the 2.1 dB of the
    1-bit point by 2e-6 dB."""
    tcm, _, tdef = traced
    jcm, _, jdef = jtraced
    monkeypatch.setattr(tquality, "sqnr_operands", _ref_sqnr_operands)
    tq, jq = tune.SqnrQuality(device="cpu"), jtune.SqnrQuality()
    for ba, bx in ((1, 1), (2, 2), (4, 4), (8, 8)):
        ts = tq.score(tune.Candidate(policy=_rescale_policy(tdef.policy,
                                                            ba, bx)), tcm)
        js = jq.score(jtune.Candidate(policy=j_rescale(jdef.policy, ba,
                                                       bx)), jcm)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-5)
    assert len(tq._cache) == len(jq._cache)


@pytest.mark.parametrize("net", ["a", "b"])
def test_tune_cifar_equals_reference(net):
    tl, jl = ((E.NETWORK_A, JE.NETWORK_A) if net == "a"
              else (E.NETWORK_B, JE.NETWORK_B))
    for tol in (3.5, 1.0):
        t = tune.tune_cifar(tl, quality_tol=tol)
        j = jtune.tune_cifar(jl, quality_tol=tol)
        assert t.to_json(top=5) == j.to_json(top=5)
        assert t.best.label == j.best.label


def test_cifar_quality_equals_reference():
    """``CifarQuality`` accuracies equal on the reference's parameters and
    the same images, at three precisions."""
    jn = J_NET_B.reduced()
    pj = jinit_cnn(jax.random.PRNGKey(0), jn)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    images, labels = _cifar_inputs()
    tq = tune.CifarQuality(params=pt, net=T_NET_B.reduced(),
                           images=torch.from_numpy(images),
                           labels=torch.from_numpy(labels).long())
    jq = jtune.CifarQuality(params=pj, net=jn, images=jnp.asarray(images),
                            labels=jnp.asarray(labels))
    for ba, bx in ((1, 1), (2, 2), (4, 4)):
        assert tq.score(tune.CifarCandidate(ba=ba, bx=bx)) == \
            jq.score(jtune.CifarCandidate(ba=ba, bx=bx))
