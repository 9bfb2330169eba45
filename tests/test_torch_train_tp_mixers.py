"""Tensor-parallel training of the SSD mixer and the RG-LRU block: the
port's ``"2d"`` train step on a ``data x model`` mesh of spawned
``gloo`` ranks for mamba2-130m and recurrentgemma-9b, each rank computing
its share of every mixer, its tiles of every projection and its
vocabulary block, against the port unsharded and the JAX package's
single-device step.

Reduced configs, parameters from the reference's ``init_params``
converted key for key, 8 x 8 tokens a step from a numpy seed, B_A = B_X
= 4:

* mamba2 (8 heads of 32): ``"heads"``, 4 heads a rank on 1 x 2 and 2 x 2;
  ``in_proj``'s 584 columns a column tile, ``out_proj`` in the column
  form (its 128 rows a rank are part of a 2,304-row bank);
* mamba2 at ``d_model`` 48 (3 heads of 32) and vocabulary 511: ``"p"``,
  16 head dims a rank on 1 x 2; ``in_proj``'s 259 columns and the
  511-row table, which 2 does not divide, used whole (``"whole"``);
* recurrentgemma, one (rec, rec, attn) unit with a 4-token window, on
  1 x 2: the LRU width 64 of 128 a rank, MQA attention in ``"g"``, the
  untied head a vocabulary column tile; on ``bpbs`` at ``bank_n`` 16
  (``rec.out``, ``attn.o`` and ``mlp.down`` Megatron row tiles) and on
  ``digital_int``.

One group of 4 CPU ranks (``tests/torch_mesh.py::task_train_tp``) runs
the 1 x 2 cases on ranks 0-1 and the 2 x 2 one on all four; the
reference runs in this process meanwhile.  Held:

* step 1: each rank's logits on its rows bitwise the unsharded rows on
  every case (both SSD modes keep the unsharded norm's order; the
  RG-LRU's gates multiply the gathered conv output by the rank's
  columns, which here sum in the unsharded order too); the loss and
  the aux metric within rtol 1e-6; every rank's gradient, its own copy
  of each replicated leaf included (the SSD and LRU 1-D leaves and conv
  weights, whose gradients each rank computes only in part), as
  ``test_torch_train_tp.py`` holds it;
* three steps' losses within 5e-3 relative of the port unsharded and of
  the reference's single-device ``build_train_step`` (at ``bank_n`` 16
  the ADC is exact, so the port's bpbs steps equal its digital_int
  steps bit for bit and the reference's digital_int step stands for
  both), and after them each replicated leaf equal on the model ranks;
* the forms each rank's step reports: the SSD mode or the LRU's
  ``"width"``, every projection's tile, the ``"whole"`` leaves;
* on a ``RecordingMesh`` (kernel backend, meta tensors) a rank's kernel
  plane operations are the unsharded step's ÷ m in ``"heads"`` and for
  recurrentgemma, and the count reckoned from the recorded forms for
  ``"p"``; its dots are the unsharded ÷ m for recurrentgemma, and for
  SSD the count reckoned from the forms less C·Bᵀ, which has no head
  and so runs whole on every rank (3 × 2·B·chunks·Q²·N a layer: the
  product and its two gradients);
* ``tensor_parallel`` admits both configs on 1 x 2 and on the production
  16 x 16 mesh (mamba2-130m there in ``"p"`` with ``in_proj`` and the
  table whole) and refuses MLA, MoE and encoder-decoder configs and a
  model axis that splits neither SSD's heads nor its head dim.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro.configs import get_config as jget
from repro.data import pipeline as jdata
from repro.models import init_params as jinit
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as jinit_state
from repro.train.step import build_train_step as jbuild_step
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.mesh import RecordingMesh
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit
from repro_torch.models import loss_fn as tloss
from repro_torch.optim import adamw as tadamw
from repro_torch.roofline.hlo_stats import StepCounter
from repro_torch.train.state import init_train_state as tinit_state
from repro_torch.train.step import build_train_step as tbuild_step
from repro_torch.train.step import tensor_parallel, value_and_grad
from repro_torch.tree import leaves

SPEC = dict(ba=4, bx=4)
LOSS_RTOL = 5e-3
BATCH, SEQ = 8, 8
# model variants: name -> (arch, fields replaced on the reduced config)
MODELS = {"mamba-heads": ("mamba2-130m", {}),
          "mamba-p": ("mamba2-130m", dict(d_model=48, vocab=511)),
          "rg": ("recurrentgemma-9b", dict(attn_window=4))}
# name -> (model, backend, spec fields)
VARIANTS = {"mamba-heads/bpbs": ("mamba-heads", "bpbs", {}),
            "mamba-p/bpbs": ("mamba-p", "bpbs", {}),
            "rg/bpbs/bank16": ("rg", "bpbs", dict(bank_n=16)),
            "rg/digital_int": ("rg", "digital_int", {})}
# (mesh, variant, steps)
CASES = [((1, 2), "mamba-heads/bpbs", 3), ((1, 2), "mamba-p/bpbs", 3),
         ((1, 2), "rg/bpbs/bank16", 3), ((1, 2), "rg/digital_int", 3),
         ((2, 2), "mamba-heads/bpbs", 3)]
# the variants the reference's single-device step runs: bpbs at bank_n
# 16 and B_X = B_A = 4 keeps every bank's count within the ADC's range,
# so its step is digital_int's bit for bit (held on the port), and the
# reference's digital_int step stands for it
REFERENCE = {"mamba-heads/bpbs": "mamba-heads/bpbs",
             "mamba-p/bpbs": "mamba-p/bpbs",
             "rg/bpbs/bank16": "rg/digital_int",
             "rg/digital_int": "rg/digital_int"}


def _cfg(get, variant):
    model, backend, fields = VARIANTS[variant]
    arch, extra = MODELS[model]
    cfg = dataclasses.replace(get(arch).reduced(), **extra)
    return cfg.with_accel(backend, **dict(SPEC, **fields))


def _data(cfg, mod=tdata):
    return mod.DataConfig(seq_len=SEQ, global_batch=BATCH, vocab=cfg.vocab,
                          seed=3)


def _opt(mod=tadamw):
    return mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results; the port unsharded and the reference's
    single-device losses of every variant, computed while they run."""
    params = {}
    for model, (arch, extra) in MODELS.items():
        jc = dataclasses.replace(jget(arch).reduced(), **extra)
        params[model] = jax.jit(lambda k, jc=jc: jinit(jc, k, max_seq=64))(
            jax.random.PRNGKey(0))
    configs = {v: (_cfg(tget, v), params_from_jax(
        jax.tree.map(np.asarray, params[VARIANTS[v][0]]), "cpu"))
        for v in VARIANTS}
    data_of = {v: _data(c) for v, (c, _) in configs.items()}
    args = dict(configs=configs, cases=CASES, data=data_of[
        "mamba-heads/bpbs"], data_of=data_of, opt=_opt())
    wait = tm.start("train_tp", 4, tmp_path_factory.mktemp("train_tp_mix"),
                    args, timeout=300)
    torch.set_num_threads(2)
    flat, jref = {}, {}
    for v, (cfg, pt) in configs.items():
        flat[v] = _unsharded(cfg, pt, 3)
    for v in set(REFERENCE.values()):
        jc = _cfg(jget, v)
        step = jax.jit(jbuild_step(jc, _opt(jadamw)))
        state, data, out = jinit_state(params[VARIANTS[v][0]]), \
            _data(jc, jdata), []
        for s in range(3):
            state, m = step(state, jdata.make_batch(data, s))
            out.append(float(m["loss"]))
        jref[v] = out
    return dict(ranks=wait(), flat=flat, jref=jref)


def _unsharded(cfg, params, steps: int) -> dict:
    batch = tdata.make_batch(_data(cfg), 0, "cpu")
    with torch.no_grad():
        logits = tforward(params, batch["tokens"], cfg)[0]
    (_, m), grads = value_and_grad(lambda p: tloss(p, batch, cfg), params)
    state, step = tinit_state(params), tbuild_step(cfg, _opt())
    losses = []
    for s in range(steps):
        state, mm = step(state, tdata.make_batch(_data(cfg), s, "cpu"))
        losses.append(float(mm["loss"]))
    return dict(logits=logits, grad=grads, loss0=float(m["loss"]),
                aux0=float(m["aux"]), losses=losses)


def _results(runs, case) -> list:
    d, m = case[0]
    return [res[case] for res in runs["ranks"][:d * m]]


def _close(got, want, rtol=1e-5):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_step_one_matches_unsharded(runs, case):
    flat = runs["flat"][case[1]]
    for res in _results(runs, case):
        want = flat["logits"][res["rows"]]
        assert torch.equal(res["logits"], want), res["coords"]
        np.testing.assert_allclose(float(res["loss0"]), flat["loss0"],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(res["aux0"]), flat["aux0"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["steps"][0]["loss"],
                                   flat["losses"][0], rtol=1e-6)
        # every rank's gradient: its model slices gathered, and its own
        # copy of each replicated leaf
        for g, w in zip(leaves(res["grad"]), leaves(flat["grad"])):
            _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_three_steps_match_unsharded_and_reference(runs, case):
    flat = runs["flat"][case[1]]["losses"]
    for res in _results(runs, case):
        got = [s["loss"] for s in res["steps"]]
        assert len(got) == 3
        np.testing.assert_allclose(got, flat, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, runs["jref"][REFERENCE[case[1]]],
                                   rtol=LOSS_RTOL)


def test_bank16_steps_are_digital_int_steps(runs):
    """What lets the reference's digital_int step stand for its bpbs one
    at bank_n 16 (``REFERENCE``)."""
    a, b = runs["flat"]["rg/bpbs/bank16"], runs["flat"]["rg/digital_int"]
    assert a["losses"] == b["losses"] and torch.equal(a["logits"],
                                                      b["logits"])


@pytest.mark.parametrize("case", CASES, ids=str)
def test_replicated_leaves_agree_across_model_ranks(runs, case):
    """After three steps each leaf the model axis does not split holds
    the same values on every model rank of a data row: each rank's copy
    took the whole gradient."""
    results = _results(runs, case)
    specs = results[0]["specs"].params
    for res in results:
        other = next(r for r in results if r["coords"][0]
                     == res["coords"][0] and r is not res)
        mine = res["steps"][-1]["state"].params
        theirs = other["steps"][-1]["state"].params
        for a, b, s in zip(leaves(mine), leaves(theirs),
                           tshd.spec_leaves(mine, specs)):
            if not tshd.splits_on_model(s):
                assert torch.equal(a, b), s


def _expected_forms(variant: str, m: int) -> dict:
    cfg = _cfg(tget, variant)
    model = VARIANTS[variant][0]
    if model.startswith("mamba"):
        d_inner = cfg.ssm_expand * cfg.d_model
        heads = d_inner // cfg.ssm_head_dim
        cols = 2 * d_inner + 2 * cfg.ssm_state + heads
        whole = cols % m != 0
        return {"ssm": "tp/p" if heads % m else "tp/heads",
                "embed": "whole" if cfg.vocab % m else "vocab",
                "ssm.in_proj": {"form": "whole", "tile": [cfg.d_model, cols]}
                if whole else {"form": "col",
                               "tile": [cfg.d_model, cols // m]},
                # rows a rank: part of a 2,304-row bank
                "ssm.out_proj": {"form": "col-form",
                                 "tile": [d_inner, cfg.d_model // m]},
                "unembed": {"form": "whole", "tile": [cfg.d_model,
                                                      cfg.vocab]}
                if cfg.vocab % m else
                {"form": "col", "tile": [cfg.d_model, cfg.vocab // m]}}
    d, w, hd = cfg.d_model, cfg.lru_width, cfg.hd
    row = [w // m, d]
    return {"rec": "tp/width", "attn": "tp/g", "embed": "vocab",
            "rec.in_x": {"form": "col", "tile": [d, w // m]},
            "rec.in_gate": {"form": "col", "tile": [d, w // m]},
            "rec.out": {"form": "row", "tile": row},
            "attn.q": {"form": "col", "tile": [d, cfg.n_heads * hd // m]},
            "attn.k": {"form": "col", "tile": [d, hd // m]},
            "attn.o": {"form": "row", "tile": [cfg.n_heads * hd // m, d]},
            "mlp.gate": {"form": "col", "tile": [d, cfg.d_ff // m]},
            "mlp.down": {"form": "row", "tile": [cfg.d_ff // m, d]},
            "unembed": {"form": "col", "tile": [d, cfg.vocab // m]}}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_step_reports_its_forms(runs, case):
    (d, m), variant = case[0], case[1]
    want = _expected_forms(variant, m)
    for res in _results(runs, case):
        forms = res["forms"]
        for block, form in want.items():
            assert forms[block] == form, (block, variant)
        for step in res["clock"]:
            if d == 1:
                assert step["gather_bytes"] == 0


def _whole_nm(form: dict, m: int) -> int:
    """The unsharded weight's N x M of a recorded projection form."""
    n, mm = form["tile"]
    return n * mm * (1 if form["form"] == "whole" else m)


def _ssd_shared_dots(cfg) -> int:
    """C·Bᵀ's dot flops a step (forward and its two gradients): no head
    dim, so every rank of an SSD split computes it whole."""
    q = cfg.ssm_chunk
    chunks = -(-SEQ // q)
    return 3 * 2 * (BATCH // 2) * chunks * q * q * cfg.ssm_state \
        * cfg.n_layers


@pytest.mark.parametrize("variant", ["mamba-heads/bpbs", "mamba-p/bpbs",
                                     "rg/bpbs/bank16"])
def test_recording_mesh_counts(variant):
    """On meta at m = 2, kernel backend: kernel plane operations and dots
    a rank against the unsharded step's (module docstring).  A
    projection's kernel operations and its straight-through backward's
    dots (dx and dw) scale with its weight's N x M, so the forms reckon
    them; the SSD einsums but C·Bᵀ split with the heads or head dims."""
    m = 2
    cfg = _cfg(tget, variant).with_accel("kernel", **dict(
        SPEC, **VARIANTS[variant][2]))
    state = tinit_state(tinit(cfg, 0, "meta", max_seq=64))
    batch = {"tokens": torch.zeros((BATCH // 2, SEQ), dtype=torch.int64,
                                   device="meta")}
    whole = StepCounter()
    with whole:
        tbuild_step(cfg, _opt())(state, batch)
    mesh = RecordingMesh(data=1, model=m, backend="nccl",
                         device=torch.device("meta"))
    policy = tshd.ShardPolicy("2d")
    specs = tshd.state_specs(state, mesh, policy)
    step = tbuild_step(cfg, _opt(), mesh=mesh, shard_policy=policy,
                       specs=specs)
    rank = StepCounter()
    with rank:
        step(tshd.shard_tree(state, specs, mesh), batch)
    a, b = whole.stats(), rank.stats()
    assert set(b["collectives_by_axis"]) == {"model"}
    assert rank.forms == step.forms
    projections = {k: f for k, f in step.forms.items()
                   if isinstance(f, dict)}
    kinds = cfg.pattern()
    per_block = {"rec": kinds.count("rec"), "attn": kinds.count("attn"),
                 "ssm": kinds.count("ssm"), "unembed": 1,
                 "mlp": sum(k != "ssm" for k in kinds)}
    calls = {k: per_block[k.split(".")[0]] for k in projections}
    tile = sum(calls[k] * f["tile"][0] * f["tile"][1]
               for k, f in projections.items())
    full = sum(calls[k] * _whole_nm(f, m) for k, f in projections.items())
    assert b["kernel_ops"] * full == a["kernel_ops"] * tile > 0
    if step.forms.get("ssm") == "tp/heads" or cfg.lru_width:
        assert a["kernel_ops"] == m * b["kernel_ops"]
    if cfg.lru_width:
        assert a["dot_flops"] == m * b["dot_flops"]
        return
    rows = BATCH // 2 * SEQ
    ste_rank, ste_whole = 4 * rows * tile, 4 * rows * full
    shared = _ssd_shared_dots(cfg)
    assert (a["dot_flops"] - ste_whole - shared) % m == 0
    assert b["dot_flops"] == (a["dot_flops"] - ste_whole - shared) // m \
        + ste_rank + shared


def test_tensor_parallel_admits_the_mixer_configs():
    """The configs ``tensor_parallel`` admits on 1 x 2 and on the
    production mesh (16 x 16), from their full-width specs on meta."""
    policy = tshd.ShardPolicy("2d")
    admitted = {}
    for arch in ("mamba2-130m", "recurrentgemma-9b", "deepseek-v2-lite-16b",
                 "llama4-scout-17b-a16e", "whisper-tiny", "olmo-1b"):
        cfg = tget(arch).with_accel("kernel")
        params = tinit(cfg, 0, "meta", max_seq=64)
        for d, m in ((1, 2), (16, 16)):
            mesh = RecordingMesh(data=d, model=m)
            specs = tshd.param_specs(params, mesh, policy)
            admitted[arch, m] = tensor_parallel(cfg, mesh, policy, specs,
                                                params)
    assert {a for (a, m), ok in admitted.items() if ok and m == 2} == \
        {a for (a, m), ok in admitted.items() if ok and m == 16} == \
        {"mamba2-130m", "recurrentgemma-9b", "olmo-1b"}
    # a model axis of 3 splits neither reduced mamba2's 8 heads nor its
    # 32 head dims
    cfg = tget("mamba2-130m").reduced().with_accel("kernel")
    params = tinit(cfg, 0, "meta")
    mesh = RecordingMesh(data=1, model=3)
    assert not tensor_parallel(cfg, mesh, policy,
                               tshd.param_specs(params, mesh, policy),
                               params)
