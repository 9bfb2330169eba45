"""Serving on a mesh: the port's ``Engine``, ``ContinuousBatcher`` and
``PagedScheduler`` on spawned ``gloo`` groups against the port unsharded
and the JAX package.

Reduced olmo-1b (the reference's ``init_params`` converted key for key)
at 1 x 2, 1 x 4 and 2 x 2 (data x model), reduced mamba2-130m at 2 x 2,
reduced starcoder2-3b (4 heads, 1 kv head; its window cut to 16 on
both packages' configs so that 8 prompt and 12 new positions wrap the
ring cache) at 1 x 2 and 2 x 2, on ``bpbs`` (no noise) with ``bank_n = 16``,
so every per-device row count is whole banks and sharded is bitwise
unsharded.  Attention runs on each rank's own heads: olmo's in the
reference's ``"kv"`` mode (its cache holds ``kv / model`` heads),
starcoder2's in ``"g"`` (q local, the one kv head whole).  One group of
4 CPU ranks (``tests/torch_mesh.py::serve_all``) runs everything: greedy
``generate`` (traced), prefill logits on ``bpbs`` and under
``digital_int``, the kernel route's tokens (its plain version here), the
slot batcher's and the paged scheduler's streams on ragged requests over
4 slots, the kv heads of each cache, one decode step's records and
collectives, and ``ServeConfig.from_tuned`` on the 2 x 2 mesh.  Held:
every rank's tokens equal; logits bitwise and streams token for token
equal to the port unsharded; the trace's per-tag records, calls and
loads equal the unsharded trace's; the caches' heads and a decode step's
collectives as reckoned here from the mode; olmo's and starcoder2's
against the reference unsharded, greedy tokens equal and
``digital_int`` logits within 1e-4 (float ops in another order, as the
port's other model tests hold them).

Attention on the rank's query rows or head dims (the reference's
``"sq"`` and ``"d"`` modes): reduced llama3.2-1b with 9 q / 3 kv heads
and reduced whisper-tiny with 3 heads, each at 2 (decoder) layers (both
packages' configs through
``dataclasses.replace``, the reference's weights converted), whose kv
heads and GQA group a 1 x 2 mesh does not divide, on the same group's
rank pairs (``torch_mesh.py::serve_sqd``).  An 8-token prefill is
``"sq"``, a 7-token one and every decode step ``"d"``; each rank's
dense, slot, paged and cross caches hold 16 of the 32 head dims.
Held: ``"sq"`` prefill logits bitwise unsharded (the rows are free dims
of every product, and the CPU's matmuls give them the same bits at
either row count); ``"d"`` logits on ``digital`` (the prefill and a
decode step) within rtol = atol = 1e-5 of the port unsharded and of the
reference unsharded (each score is summed over the ranks in another
order); greedy ``bpbs`` tokens of both prefills equal on every rank and
to the port's unsharded tokens, the 7-token run's also to the
reference's (run in a process of its own meanwhile), a first
divergence allowed only where the unsharded top-2 logit gap is below
NEAR_TIE; the slot batcher's and the paged scheduler's streams equal
each request's solo ``generate`` on the mesh (the paged scheduler's
also in 4-token prefill chunks: a resumed chunk is "sq" on the "d"
cache, whose head dims it gathers); a decode step's
collectives as reckoned from its records (one score sum and one output
gather an attention call); ``split_sdpa`` on the dense and the chunked
path against ``sdpa`` whole.

The mixers on the rank's share (``models.mixer_split``): reduced
mamba2-130m (its SSD mixer on 4 of 8 heads a rank) and reduced
deepseek-v2-lite at 2 layers (MLA on 2 of 4 q heads a rank, dropless at
capacity factor 64), on ``digital_int`` with the port's seeded weights,
on the same group's 1 x 2 rank pairs (``torch_mesh.py::serve_streams``).
Held: the slot batcher's and the paged scheduler's streams equal each
request's solo ``generate`` on the mesh.
"""
import dataclasses
import warnings
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import jax
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.distributed.sharding import ShardPolicy as JPolicy
from repro.models import init_params as jinit
from repro.models import decode_step as jdecode
from repro.models import prefill as jprefill
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServe
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import ShardPolicy
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models import init_params as tinit
from repro_torch.serve import PagedScheduler, ServeConfig
from repro_torch.tune import TunedConfig

SPEC = dict(ba=4, bx=4, bank_n=16)
SERVE = dict(max_seq=32, max_new_tokens=6, kv_block_size=8, decode_block=4)
# starcoder2: 8 prompt + 12 new positions wrap its ring cache of 16
SERVE_BY = {"starcoder2-3b": dict(max_new_tokens=12)}
WINDOW = 16
MESHES = {"olmo-1b": list(tm.MESHES), "mamba2-130m": [(2, 2)],
          "starcoder2-3b": [(1, 2), (2, 2)]}
CASES = [(m, name) for name, ms in MESHES.items() for m in ms]
TOL = dict(rtol=1e-4, atol=1e-4)


# the configs also held to the reference unsharded
REFERENCE = ("olmo-1b", "starcoder2-3b")
# "sq" / "d" configs: kv heads and GQA group odd, so 1 x 2 splits the
# query rows of an even prefill and the head dims of everything else
SQD = {"llama3.2-1b": dict(n_layers=2, n_heads=9, n_kv_heads=3),
       "whisper-tiny": dict(n_layers=2, n_heads=3, n_kv_heads=3)}
SQD_CASES = [((1, 2), name) for name in SQD]
SQD_TOL = dict(rtol=1e-5, atol=1e-5)
# a greedy token may turn where the unsharded top-2 logits are this close
NEAR_TIE = 1e-3
# split mixers (SSD heads, MLA heads) served by the slot batcher and the
# paged scheduler on 1 x 2: config changes on the reduced config
STREAMS = {"mamba2-130m": {},
           "deepseek-v2-lite-16b": dict(n_layers=2, moe_capacity_factor=64.0)}
STREAM_CASES = [((1, 2), name) for name in STREAMS]


def _reduced(get, name: str):
    cfg = get(name).reduced()
    if name == "starcoder2-3b":
        cfg = dataclasses.replace(cfg, attn_window=WINDOW)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """Each config's reference params converted key for key."""
    configs, jax_configs = {}, {}
    for name in MESHES:
        jc = _reduced(jget, name)
        pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
        jax_configs[name] = (jc, pj)
        configs[name] = (
            _reduced(tget, name).with_accel("bpbs", **SPEC),
            params_from_jax(jax.tree.map(np.asarray, pj), "cpu"))
    sqd = {}
    for name, heads in SQD.items():
        jc = dataclasses.replace(jget(name).reduced(), **heads)
        pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
        jax_configs[name] = (jc, pj)
        digital = dataclasses.replace(tget(name).reduced(), **heads)
        sqd[name] = dict(cfg=digital.with_accel("bpbs", **SPEC),
                         digital=digital,
                         params=params_from_jax(jax.tree.map(np.asarray, pj),
                                                "cpu"))
    streams = {}
    for name, changes in STREAMS.items():
        cfg = dataclasses.replace(tget(name).reduced(), **changes)
        cfg = cfg.with_accel("digital_int", **SPEC)
        streams[name] = (cfg, tinit(cfg, 0, device="cpu", max_seq=64))
    vocab = jax_configs["olmo-1b"][0].vocab
    r = np.random.default_rng(0)
    prompts = r.integers(0, vocab, (4, 8))
    requests = [(r.integers(0, vocab, (n,)), m)
                for n, m in zip((5, 9, 3, 12, 7), (4, 6, 2, 5, 3))]
    return dict(jax_configs=jax_configs, configs=configs, prompts=prompts,
                requests=requests, sqd=sqd, streams=streams)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The 4-rank group's results and the port's unsharded ones."""
    args = dict(configs=setup["configs"], meshes=MESHES,
                prompts=setup["prompts"], requests=setup["requests"],
                serve=SERVE, serve_by=SERVE_BY, n_slots=4,
                tuned_config="olmo-1b", sqd=setup["sqd"],
                streams=setup["streams"])
    wait = tm.start("serve", 4, tmp_path_factory.mktemp("serve"), args,
                    timeout=600)
    # the reference's runs of the "sq" / "d" configs, in a process of
    # their own meanwhile (its jit compiles take the longest)
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        sqd_reference = pool.submit(
            _sqd_reference,
            {name: (jc, jax.tree.map(np.asarray, pj)) for name, (jc, pj)
             in setup["jax_configs"].items() if name in SQD},
            setup["prompts"])
        torch.set_num_threads(2)
        flat = {name: tm.serve_all(params, cfg, ServeConfig(**_serve(name)),
                                   setup["prompts"], setup["requests"], 4)
                for name, (cfg, params) in setup["configs"].items()}
        for name, c in setup["sqd"].items():
            flat[name] = tm.serve_sqd(c["params"], c["cfg"], c["digital"],
                                      ServeConfig(**SERVE), setup["prompts"],
                                      setup["requests"], 4)
        flat["reference"] = dict(_reference(setup), **sqd_reference.result())
    return wait(), flat


def _serve(name: str) -> dict:
    return {**SERVE, **SERVE_BY.get(name, {})}


def _reference(setup) -> dict:
    """The reference unsharded on the same converted weights, for each
    config of REFERENCE: greedy ``bpbs`` tokens, and ``digital_int``
    prefill logits under the serving quantization scope."""
    prompts = jax.numpy.asarray(setup["prompts"], jax.numpy.int32)
    out = {}
    for name in REFERENCE:
        jc, pj = setup["jax_configs"][name]
        tokens = np.asarray(JEngine(pj, jc.with_accel("bpbs", **SPEC),
                                    JServe(**_serve(name))).generate(prompts))
        with jaccel.override(x_per_row=True):
            logits = np.asarray(jprefill(
                pj, prompts, jc.with_accel("digital_int", **SPEC),
                SERVE["max_seq"])[0])
        out[name] = dict(tokens=tokens, logits_digital_int=logits)
    return out


def _sqd_reference(configs: dict, prompts) -> dict:
    """The reference unsharded for each ``"sq"`` / ``"d"`` config
    (``configs``: name to (config, params as numpy)) on the odd-length
    prompts (a ``"d"`` prefill on the mesh): greedy ``bpbs`` tokens, and
    ``digital`` logits of the prefill and of one decode step after it."""
    odd = jax.numpy.asarray(prompts, jax.numpy.int32)[:, :-1]
    out = {}
    for name, (jc, pj) in configs.items():
        tokens = JEngine(pj, jc.with_accel("bpbs", **SPEC),
                         JServe(**SERVE)).generate(odd)
        logits, cache = jprefill(pj, odd, jc, SERVE["max_seq"])
        step = jdecode(pj, jax.numpy.argmax(logits, -1), cache, jc)[0]
        out[name] = dict(tokens={"d": np.asarray(tokens)},
                         digital={"d": np.asarray(logits),
                                  "decode": np.asarray(step)})
    return out


def _ids(cases):
    return [f"{d}x{m}-{name}" for (d, m), name in cases]


def _held(ranks, case) -> list:
    """The results of the ranks that ran ``case`` (the ranks of its
    mesh), in mesh order."""
    (data, model), _ = case
    held = [r[case] for r in ranks if case in r]
    assert len(held) == data * model
    return held


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_generate_tokens_equal_unsharded(runs, case):
    ranks, flat = runs
    name = case[1]
    got, *rest = _held(ranks, case)
    for r in rest:
        np.testing.assert_array_equal(r["tokens"], got["tokens"])
    np.testing.assert_array_equal(got["tokens"], flat[name]["tokens"])
    np.testing.assert_array_equal(got["tokens_kernel"],
                                  flat[name]["tokens_kernel"])


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_prefill_logits_bitwise_unsharded(runs, case):
    ranks, flat = runs
    got = _held(ranks, case)[0]
    for key in ("logits", "logits_digital_int"):
        assert torch.equal(got[key], flat[case[1]][key]), key


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_batcher_and_paged_streams_equal_unsharded(runs, case):
    ranks, flat = runs
    name = case[1]
    for r in _held(ranks, case):
        assert r["batcher"] == flat[name]["batcher"]
        assert r["paged"] == flat[name]["paged"]


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_trace_records_are_logical(runs, case):
    """One record per projection call with the full n, m: the sharded
    trace's records, calls and loads per tag equal the unsharded
    trace's, every partitioned record names the mesh's model axis."""
    ranks, flat = runs
    (data, model), name = case
    got = _held(ranks, case)[0]
    assert got["trace"] == flat[name]["trace"]
    parts = {p for _, p, _ in got["partitions"]}
    assert parts == {"col", "row"}
    assert all(d == model for _, p, d in got["partitions"] if p)
    # each rank holds its tile: a model-th of the planes (scales aside)
    assert got["image_bytes"] < flat[name]["image_bytes"] / model * 1.05


def _mode(cfg, model: int) -> str:
    """The reference's ``_attn_tp_mode`` priority for the two modes that
    run head-local (repro/models/attention.py:49-52)."""
    if cfg.n_kv_heads % model == 0:
        return "kv"
    return "g" if (cfg.n_heads // cfg.n_kv_heads) % model == 0 else "none"


HEAD_CASES = [c for c in CASES if c[1] != "mamba2-130m"]


@pytest.mark.parametrize("case", HEAD_CASES, ids=_ids(HEAD_CASES))
def test_caches_hold_the_ranks_kv_heads(setup, runs, case):
    """Each rank's dense, slot and paged caches hold kv / model heads in
    mode "kv" and every kv head in mode "g"."""
    ranks, flat = runs
    (data, model), name = case
    cfg = setup["configs"][name][0]
    mode = _mode(cfg, model)
    assert mode == {"olmo-1b": "kv", "starcoder2-3b": "g"}[name]
    want = cfg.n_kv_heads // model if mode == "kv" else cfg.n_kv_heads
    for r in _held(ranks, case):
        assert r["heads"] == dict(dense={want}, slot={want}, paged={want})
    assert flat[name]["heads"]["dense"] == {cfg.n_kv_heads}


@pytest.mark.parametrize("case", HEAD_CASES, ids=_ids(HEAD_CASES))
def test_decode_step_collectives_are_head_local(setup, runs, case):
    """A decode step's model-axis collectives, reckoned from its traced
    projections: a column tile gathers its output but for the head-local
    ones (q, k and v in mode "kv", q in "g"), a row tile all-reduces its
    sum, and each attention layer's ``wo`` reduces one per-row scale
    with ``max``; nothing over "data" (the decode runs on the shard's
    rows)."""
    ranks, _ = runs
    (_, model), name = case
    local = {"kv": ("attn.q", "attn.k", "attn.v"),
             "g": ("attn.q",)}[_mode(setup["configs"][name][0], model)]
    for r in _held(ranks, case):
        got = r["decode"]
        want = tm.reckoned_collectives(got["records"], local)
        assert Counter(got["collectives"]) == want
        n_attn = sum(tag == "attn.o" for tag, _ in got["records"])
        assert n_attn == setup["configs"][name][0].n_layers
        assert want["all-reduce", "model", "max"] == n_attn


def test_tokens_and_logits_match_reference(runs):
    """The sharded port against the reference unsharded on the same
    converted weights: greedy bpbs tokens equal, digital_int prefill
    logits within 1e-4; olmo-1b in mode "kv", starcoder2-3b in mode "g"
    through its wrapped ring."""
    ranks, flat = runs
    for name in REFERENCE:
        want = flat["reference"][name]
        for shape in MESHES[name]:
            got = _held(ranks, (shape, name))[0]
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_allclose(got["logits_digital_int"].numpy(),
                                       want["logits_digital_int"], **TOL)


def test_from_tuned_serves_on_its_mesh(runs):
    ranks, flat = runs
    for r in ranks:
        tokens, policy = r["tuned"]
        np.testing.assert_array_equal(tokens, flat["olmo-1b"]["tokens"])
        assert policy == ShardPolicy(data_shards=2)


def test_from_tuned_mesh_shape_errors_match_reference():
    tuned = TunedConfig(policy=None, capacity_chips=2, data_shards=2,
                        model_shards=4, label="u4b4b/v1.2/c2/2x4")
    for data, model in ((1, 8), (2, 2)):
        amesh = jax.sharding.AbstractMesh((data, model), ("data", "model"))
        with pytest.raises(ValueError) as je:
            JServe.from_tuned(tuned, mesh=amesh)
        with pytest.raises(ValueError) as te:
            ServeConfig.from_tuned(tuned, mesh=ServeMesh(data=data,
                                                         model=model))
        assert str(te.value) == str(je.value)
    scfg = ServeConfig.from_tuned(tuned, mesh=ServeMesh(data=2, model=4))
    assert scfg.shard_policy == ShardPolicy(data_shards=2)
    assert scfg.cima_chips == 2 and scfg.mesh.shape == {"data": 2,
                                                        "model": 4}


def test_data_shards_errors_match_reference():
    amesh = jax.sharding.AbstractMesh((1, 2), ("data", "model"))
    for jmesh, tmesh in ((None, None), (amesh, ServeMesh(1, 2))):
        with pytest.raises(ValueError) as je:
            JServe(shard_policy=JPolicy(data_shards=2), mesh=jmesh)
        with pytest.raises(ValueError) as te:
            ServeConfig(shard_policy=ShardPolicy(data_shards=2), mesh=tmesh)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="x_per_row=False"):
        ServeConfig(mesh=ServeMesh(data=2, model=1), x_per_row=False)


def test_paged_warns_on_slots_the_data_axis_does_not_divide(setup):
    cfg, params = setup["configs"]["olmo-1b"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        PagedScheduler(params, cfg, ServeConfig(mesh=ServeMesh(2, 1),
                                                **SERVE), 3, device="cpu")
    # the reference's message
    assert [str(w.message) for w in caught] == [
        "n_slots=3 is not divisible by the mesh 'data' axis (2): slot "
        "state and positions replicate instead of sharding — size the "
        "slot pool as a multiple of data for the intended capacity"]


# ------------------------------------------------- "sq" and "d" splits

def _sqd_ids(cases):
    return [name for _, name in cases]


def _greedy_equal(got, want, gaps, what: str) -> None:
    """Greedy tokens [B, T] equal, but that a row may turn first at a
    step whose unsharded top-2 logit gap is below NEAR_TIE (the rest of
    that row is not compared)."""
    for row in range(got.shape[0]):
        turned = np.flatnonzero(got[row] != want[row])
        if turned.size:
            t = int(turned[0])
            assert gaps[row, t] < NEAR_TIE, (
                f"{what}: row {row} turns at step {t} where the unsharded "
                f"top-2 gap is {gaps[row, t]}")


def _sqd_modes(cfg) -> dict:
    want = {"prefill_even": "sq", "prefill_odd": "d", "decode": "d"}
    if cfg.is_encdec:
        want.update({f"cross_{k}": v for k, v in want.items()},
                    encoder="sq")
    return want


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_modes_and_cache_dims(setup, runs, case):
    """On 1 x 2 the reference's rule gives an 8-row prefill "sq" and a
    7-row one and a decode step "d" (whisper's cross-attention alike,
    its 8-frame encoder "sq"); every cache of a rank holds all kv heads
    and half the head dims, the unsharded port's the whole head."""
    ranks, flat = runs
    name = case[1]
    cfg = setup["sqd"][name]["cfg"]
    want = {(cfg.n_kv_heads, cfg.hd // 2)}
    kinds = ["dense", "slot"] + (
        ["cross_dense", "cross_slot", "cross_prefill"] if cfg.is_encdec
        else ["paged"])
    for r in _held(ranks, case):
        assert r["modes"] == _sqd_modes(cfg)
        assert r["dims"] == {k: want for k in kinds}
    assert set(flat[name]["modes"].values()) == {"whole"}
    assert all(d == {(cfg.n_kv_heads, cfg.hd)}
               for d in flat[name]["dims"].values())


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_sq_prefill_logits_bitwise_unsharded(runs, case):
    ranks, flat = runs
    want = flat[case[1]]
    for r in _held(ranks, case):
        assert torch.equal(r["logits"]["sq"], want["logits"]["sq"])
        assert torch.equal(r["digital"]["sq"], want["digital"]["sq"])


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_d_logits_match_unsharded_and_reference(runs, case):
    """``digital`` logits of the 7-token ("d") prefill and of the decode
    step after it: within 1e-5 of the port unsharded and of the
    reference unsharded."""
    ranks, flat = runs
    name = case[1]
    for r in _held(ranks, case):
        for key in ("d", "decode"):
            got = r["digital"][key].numpy()
            np.testing.assert_allclose(got, flat[name]["digital"][key],
                                       **SQD_TOL)
            np.testing.assert_allclose(
                got, flat["reference"][name]["digital"][key], **SQD_TOL)


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_greedy_tokens_match_unsharded_and_reference(runs, case):
    """Greedy ``bpbs`` tokens of the "sq" and the "d" prefill's run:
    equal on every rank and to the port unsharded; the "d" run's also to
    the reference unsharded (each under the near-tie rule)."""
    ranks, flat = runs
    name = case[1]
    held = _held(ranks, case)
    for kind in ("sq", "d"):
        got = held[0]["tokens"][kind]
        for r in held[1:]:
            np.testing.assert_array_equal(r["tokens"][kind], got)
        gaps = flat[name]["gaps"][kind]
        _greedy_equal(got, flat[name]["tokens"][kind], gaps,
                      f"{name} {kind} vs unsharded")
    _greedy_equal(held[0]["tokens"]["d"], flat["reference"][name]["tokens"]
                  ["d"], flat[name]["gaps"]["d"], f"{name} d vs reference")


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_batcher_and_paged_streams_equal_solo(runs, case):
    ranks, _ = runs
    for r in _held(ranks, case):
        assert r["batcher"] == r["solo"]
        if "paged" in r:
            assert r["paged"] == r["solo"]
            assert r["paged_chunked"] == r["solo"]


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_sqd_decode_step_collectives_are_reckoned(setup, runs, case):
    """A "d" decode step's collectives: the projections' as off the
    split (every column tile gathered, every row tile summed, no
    ``max``), and for each self- and cross-attention call one score sum
    (one chunk: 32 cache slots, whisper's 8 frames) and one gather of
    its output."""
    ranks, _ = runs
    cfg = setup["sqd"][case[1]]["cfg"]
    split = {"attn.o": ("d", SERVE["max_seq"]),
             "cross.o": ("d", cfg.frontend_seq)}
    for r in _held(ranks, case):
        got = r["decode"]
        assert Counter(got["collectives"]) == tm.reckoned_collectives(
            got["records"], split=split)
        calls = sum(tag in split for tag, _ in got["records"])
        assert calls == cfg.n_layers * (2 if cfg.is_encdec else 1)


@pytest.mark.parametrize("case", SQD_CASES, ids=_sqd_ids(SQD_CASES))
def test_split_sdpa_dense_and_chunked_match_whole(runs, case):
    """``split_sdpa`` over 40 keys (dense) and 1,100 (chunked, three
    score sums): "sq" bitwise ``sdpa`` whole, "d" within 1e-5."""
    ranks, _ = runs
    for r in _held(ranks, case):
        for (mode, keys), (whole, got) in r["split_sdpa"].items():
            if mode == "sq":
                assert torch.equal(got, whole), keys
            else:
                np.testing.assert_allclose(got.numpy(), whole.numpy(),
                                           **SQD_TOL)


# ------------------------------------------------------- split mixers

@pytest.mark.parametrize("case", STREAM_CASES, ids=_sqd_ids(STREAM_CASES))
def test_split_mixer_streams_equal_solo(runs, case):
    """On 1 x 2 mamba2's SSD mixer runs on each rank's heads (its state
    holding them) and deepseek's MLA on each rank's q heads; the slot
    batcher's and the paged scheduler's streams equal each request's
    solo ``generate`` on the mesh."""
    ranks, _ = runs
    kind = {"mamba2-130m": "ssd", "deepseek-v2-lite-16b": "mla"}[case[1]]
    for k, r in enumerate(_held(ranks, case)):
        mode, lo, hi, local = r["modes"][kind]
        assert (mode, local) == ("heads", True) and lo == k * (hi - lo)
        assert r["batcher"] == r["solo"]
        assert r["paged"] == r["solo"]
