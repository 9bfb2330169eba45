"""Tensor-parallel training: the port's ``"2d"`` train step on a ``data x
model`` mesh of spawned ``gloo`` ranks, each rank computing its tiles of
every projection, its heads (or query rows) and its vocabulary block,
against the port unsharded and the JAX package's single-device step.

Reduced olmo-1b (4 heads, 4 kv: mode "kv"), reduced llama3.2-1b (4
heads, 1 kv: "g") and llama3.2-1b at 9 q / 3 kv heads (8 query rows:
"sq"), parameters from the reference's ``init_params`` converted key for
key, 8 x 8 tokens a step from a numpy seed, B_A = B_X = 4.  One group of
4 CPU ranks (``tests/torch_mesh.py::task_train_tp``) runs the 1 x 2
cases on ranks 0-1 and the 2 x 2 ones on all four; the reference runs
in this process meanwhile.  The row-parallel projections (``wo``,
``down``) run as Megatron row tiles where the rank's rows are whole
banks (``bank_n`` 16: 64 of ``wo``'s 128 rows, 128 of ``down``'s 256)
and on ``digital_int`` (no banks), and in the column form at the
default ``bank_n`` (2,304: half a bank) on ``bpbs`` and ``kernel`` and
with an XNOR 1-bit input (a mean no row block reproduces).  One olmo
case takes a per-tensor weight scale (``per_channel=False``): every
tile, the tied head's included, is on the ``max`` over ``"model"`` of
the tiles' amax, the whole weight's grid.  Held:

* step 1: each rank's logits on its rows (its vocabulary blocks
  gathered) bitwise the unsharded rows on every quantizing case, within
  1e-5 on ``digital``; the loss and the aux metric within rtol 1e-6;
  the gradient (the rank's slices gathered, summed over the dp axes)
  as ``test_torch_train_mesh.py::_close`` holds it (1e-5 of each leaf's
  largest magnitude);
* three steps' losses within 5e-3 relative of the port unsharded and of
  the reference's single-device ``build_train_step`` (the XNOR 1-bit
  input case runs one step: its sign grid turns an updated weight's
  float-order difference into another input bit; so does the
  per-tensor case, whose step 1 is what it holds);
* each rank's step reports the forms it ran: attention in the
  reference's mode, ``wo`` and ``down`` as row tiles or in the column
  form as above; on 1 x 2 the step gathers no parameter (the fsdp axis
  is one rank wide), on 2 x 2 one gather a leaf the data axis splits;
* ``reduce`` and ``gather(partial=True)`` give their definitions'
  results and gradients (an all-reduce with an identity backward; a
  gather whose backward sums and keeps the block), the column form the
  unsharded call's bits and the row tile's straight-through gradients
  with no collective in its backward, ``vocab_nll`` equals
  ``torch.logsumexp`` less the target logit (rtol 1e-6) and its
  gradient the softmax less the one-hot;
* on a ``RecordingMesh`` a rank's counted dots and kernel plane
  operations are the unsharded step's ÷ m exactly (every dot and
  kernel call of the step splits), the collectives by op are counted;
* the dense decoders train tensor-parallel (``tp_config``; so do the SSD
  and RG-LRU configs, ``test_torch_train_tp_mixers.py``), the others
  keep the replicated form; ``row_form_ok`` takes banked backends only
  at whole banks.
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
from repro_torch.accel import ExecSpec, matmul
from repro_torch.accel.train_shard import row_form_ok
from repro_torch.configs import ALL_ARCHS
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
from repro_torch.train.step import value_and_grad
from repro_torch.tree import leaves

SPEC = dict(ba=4, bx=4)
LOSS_RTOL = 5e-3
DENSE = ("olmo-1b", "llama3.2-1b", "starcoder2-3b", "granite-8b",
         "phi-3-vision-4.2b")
# model variants: (arch, (heads, kv heads) or None) -> the mode on 1 x 2
MODELS = {"olmo": ("olmo-1b", None), "llama-g": ("llama3.2-1b", None),
          "llama-sq": ("llama3.2-1b", (9, 3))}
MODE = {"olmo": "kv", "llama-g": "g", "llama-sq": "sq"}
# name -> (model, backend, spec fields, wo/down form)
VARIANTS = {
    "olmo/bpbs": ("olmo", "bpbs", {}, "col-form"),
    "olmo/bpbs/bank16": ("olmo", "bpbs", dict(bank_n=16), "row"),
    "olmo/bpbs/tensor": ("olmo", "bpbs", dict(per_channel=False),
                         "col-form"),
    "olmo/kernel": ("olmo", "kernel", {}, "col-form"),
    "olmo/kernel/bank16": ("olmo", "kernel", dict(bank_n=16), "row"),
    "llama-g/digital_int": ("llama-g", "digital_int", dict(bank_n=16),
                            "row"),
    "llama-g/digital_int/xnor1": ("llama-g", "digital_int", dict(bx=1),
                                  "col-form"),
    "llama-sq/bpbs": ("llama-sq", "bpbs", {}, "col-form"),
    "llama-g/digital": ("llama-g", "digital", {}, "row"),
}
# (mesh, variant, steps)
CASES = [((1, 2), "olmo/bpbs", 3), ((1, 2), "olmo/bpbs/bank16", 3),
         ((1, 2), "olmo/bpbs/tensor", 1),
         ((2, 2), "olmo/kernel", 3), ((1, 2), "olmo/kernel/bank16", 3),
         ((1, 2), "llama-g/digital_int", 3),
         ((1, 2), "llama-g/digital_int/xnor1", 1),
         ((2, 2), "llama-sq/bpbs", 3), ((1, 2), "llama-g/digital", 3)]
# the three-step cases: not the XNOR 1-bit input, whose sign grid turns a
# float-order difference of an updated weight into another input bit, nor
# the per-tensor weight scale, whose step 1 is what it adds
THREE_STEP_CASES = [c for c in CASES if c[2] == 3]
# the variants also held to the reference's single-device step
REFERENCE = ("olmo/bpbs", "llama-sq/bpbs", "llama-g/digital_int")


def _cfg(get, variant):
    model, backend, fields, _ = VARIANTS[variant]
    arch, heads = MODELS[model]
    cfg = get(arch).reduced()
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    if backend != "digital":
        cfg = cfg.with_accel(backend, **dict(SPEC, **fields))
    return cfg


def _data(cfg, mod=tdata):
    return mod.DataConfig(seq_len=8, global_batch=8, vocab=cfg.vocab, seed=3)


def _opt(mod=tadamw):
    return mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _col_form_inputs():
    """A column form's operands: x [3, 16] and w [16, 6] from a seed, on
    ``bpbs`` at bank_n 6, so a rank's 8 rows are a bank and a third: the
    row tile would clip partial banks."""
    r = np.random.default_rng(11)
    return (r.normal(size=(3, 16)).astype(np.float32),
            r.normal(size=(16, 6)).astype(np.float32),
            ExecSpec(backend="bpbs", ba=4, bx=4, bank_n=6))


def _ce_inputs():
    r = np.random.default_rng(7)
    return ((r.normal(size=(2, 5, 12)) * 3).astype(np.float32),
            r.integers(0, 12, size=(2, 5)).astype(np.int64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results; the port unsharded and the reference's
    single-device losses of every variant, computed while they run."""
    params = {}
    for model, (arch, heads) in MODELS.items():
        jc = jget(arch).reduced()
        if heads is not None:
            jc = dataclasses.replace(jc, n_heads=heads[0],
                                     n_kv_heads=heads[1])
        params[model] = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
    configs = {v: (_cfg(tget, v), params_from_jax(
        jax.tree.map(np.asarray, params[VARIANTS[v][0]]), "cpu"))
        for v in VARIANTS}
    tc = configs["olmo/bpbs"][0]
    args = dict(configs=configs, cases=CASES, data=_data(tc), opt=_opt(),
                ce=_ce_inputs(), col_form=_col_form_inputs())
    wait = tm.start("train_tp", 4, tmp_path_factory.mktemp("train_tp"),
                    args, timeout=300)
    torch.set_num_threads(2)
    flat, jref = {}, {}
    for v, (cfg, pt) in configs.items():
        flat[v] = _unsharded(cfg, pt, max(c[2] for c in CASES if c[1] == v))
    for v in REFERENCE:
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
    digital = VARIANTS[case[1]][1] == "digital"
    for res in _results(runs, case):
        want = flat["logits"][res["rows"]]
        if digital:
            np.testing.assert_allclose(res["logits"].numpy(), want.numpy(),
                                       rtol=0, atol=1e-5)
        else:
            assert torch.equal(res["logits"], want), res["coords"]
        np.testing.assert_allclose(float(res["loss0"]), flat["loss0"],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(res["aux0"]), flat["aux0"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["steps"][0]["loss"],
                                   flat["losses"][0], rtol=1e-6)
        for g, w in zip(leaves(res["grad"]), leaves(flat["grad"])):
            _close(g, w)


@pytest.mark.parametrize("case", THREE_STEP_CASES, ids=str)
def test_three_steps_match_unsharded_and_reference(runs, case):
    flat = runs["flat"][case[1]]["losses"]
    for res in _results(runs, case):
        got = [s["loss"] for s in res["steps"]]
        assert len(got) == 3
        np.testing.assert_allclose(got, flat, rtol=LOSS_RTOL)
        if case[1] in runs["jref"]:
            np.testing.assert_allclose(got, runs["jref"][case[1]],
                                       rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_step_reports_its_forms_and_gathers_over_data_only(runs, case):
    (d, m), variant = case[0], case[1]
    model, _, _, row = VARIANTS[variant]
    cfg = _cfg(tget, variant)
    n_split = sum(
        any(a == "data" for a in s) for s in tshd.spec_leaves(
            runs["flat"][variant]["grad"],
            tshd.param_specs(runs["flat"][variant]["grad"],
                             RecordingMesh(data=d, model=m))))
    for res in _results(runs, case):
        forms = res["forms"]
        assert forms["attn"] == f"tp/{MODE[model]}"
        assert forms["embed"] == "vocab"
        assert forms["unembed"] == {"form": "col", "tile": [
            cfg.d_model, cfg.vocab // m]}
        for tag, n in (("attn.o", cfg.n_heads * cfg.hd),
                       ("mlp.down", cfg.d_ff)):
            tile = [n // m, cfg.d_model] if row == "row" \
                else [n, cfg.d_model // m]
            assert forms[tag] == {"form": row, "tile": tile}, (tag, variant)
        assert forms["attn.q"] == {"form": "col", "tile": [
            cfg.d_model, cfg.n_heads * cfg.hd // m]}
        assert forms["attn.k"]["form"] == forms["mlp.up"]["form"] == "col"
        for step in res["clock"]:
            if model == "olmo":
                # the column form gathers over "model" in the forward
                # (the grids, the re-layout as gloo runs it, the
                # columns); in "kv" the row tiles gather nothing
                gathers = step["compute_by_op"].get("all-gather/model/None",
                                                    [0])[0]
                assert (gathers > 0) == (row == "col-form"), gathers
            assert step["gather_collectives"] == n_split
            if d == 1:
                assert step["gather_bytes"] == 0


def test_operators_and_vocab_cross_entropy(runs):
    logits, targets = (torch.from_numpy(a) for a in _ce_inputs())
    lg = logits.clone().requires_grad_()
    want = torch.logsumexp(lg, -1) - torch.take_along_dim(
        lg, targets[..., None], -1)[..., 0]
    want.sum().backward()
    for r, res in enumerate(runs["ranks"][:2]):
        ops = res["ops"]
        y, g, n = ops["reduce"]
        assert torch.equal(y, torch.tensor([[1.0, 2.0]]))
        assert torch.equal(g, torch.tensor([[0.0, r + 1.0]])) and n == 1
        y, g, n = ops["gather_partial"]
        assert torch.equal(y, torch.tensor([[0.0, 1.0], [1.0, 1.0]]))
        assert torch.equal(g, torch.tensor([[2.0 * r, 2.0 * r + 1]]) * 3)
        assert n == 2
        # the column form: the unsharded call's bits on every rank; its
        # backward the row tile's on the rank's block, moving nothing
        xs, ws, spec = _col_form_inputs()
        x, w = torch.from_numpy(xs), torch.from_numpy(ws)
        y, dx, dw, fwd, bwd = ops["col_form"]
        assert torch.equal(y, matmul(x, w, spec))
        g = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
            * (r + 1)
        lo = 8 * r
        _close(dx, g @ w[lo:lo + 8].T)
        _close(dw, x[:, lo:lo + 8].T @ g)
        # the grids' two max, the input's gather, the weight's re-layout
        # (on gloo a gather) and the columns' gather
        assert (fwd, bwd) == (5, 0)
        nll, grad = ops["vocab_nll"]
        np.testing.assert_allclose(nll.numpy(), want.detach().numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(),
                                   lg.grad[..., 6 * r:6 * r + 6].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant,m", [("olmo/bpbs", 2), ("olmo/kernel", 4),
                                       ("llama-sq/bpbs", 2),
                                       ("llama-g/digital", 2)])
def test_recording_mesh_counts_split_by_the_model_axis(variant, m):
    """On meta: the unsharded step's dots and kernel operations ÷ m are a
    tensor-parallel rank's, exactly (on ``kernel`` the projections are
    kernel calls, on ``digital`` dots); the collectives are all on
    "model" (data is one rank wide), each kind counted."""
    cfg = _cfg(tget, variant)
    if VARIANTS[variant][1] == "bpbs":
        cfg = cfg.with_accel("kernel", **SPEC)
    state = tinit_state(tinit(cfg, 0, "meta", max_seq=64))
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int64,
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
    assert a["dot_flops"] == m * b["dot_flops"] > 0
    assert a["kernel_ops"] == m * b["kernel_ops"]
    assert (b["kernel_ops"] > 0) == (VARIANTS[variant][1] != "digital")
    assert set(b["collectives_by_axis"]) == {"model"}
    ops = rank.collectives_by_op
    assert ops[("all-reduce", "model", "max")]["count"] >= 1   # the loss
    assert rank.forms == step.forms
    if step.forms["attn.o"]["form"] == "col-form":
        # wo's and down's int8 re-layout, in the forward only
        assert ops[("all-to-all", "model", None)]["count"] == \
            2 * cfg.n_layers


def test_which_configs_train_tensor_parallel():
    # the dense decoders, and the SSD and RG-LRU configs
    # (tests/test_torch_train_tp_mixers.py)
    for arch in ALL_ARCHS:
        assert tshd.tp_config(tget(arch).with_accel("kernel")) == \
            (arch in DENSE + ("mamba2-130m", "recurrentgemma-9b")), arch
    xnor = tget("olmo-1b").with_accel("bpbs", ba=1, bx=1, coding="xnor",
                                      per_channel=False)
    assert not tshd.tp_config(xnor)


def test_row_form_only_at_whole_banks():
    for backend in ("bpbs", "bpbs_ref", "kernel"):
        spec = ExecSpec(backend=backend, bank_n=16)
        assert row_form_ok(spec, 64) and not row_form_ok(spec, 72)
        assert not row_form_ok(ExecSpec(backend=backend), 1024)
    assert row_form_ok(ExecSpec(backend="digital_int"), 72)
    assert row_form_ok(ExecSpec(backend="digital"), 72)
    assert not row_form_ok(ExecSpec(backend="digital_int", bx=1), 64)


def test_train_form_of_each_leaf():
    """The dim each leaf's spec puts on "model" is the one the model code
    tiles in a tensor-parallel step: a column-parallel weight's output
    dim, a row-parallel one's contraction dim, the table's vocabulary
    dim; a norm is used whole."""
    from repro_torch.tree import leaves_with_path

    params = tinit(tget("granite-8b").reduced(), 0, "meta")
    specs = tshd.param_specs(params, RecordingMesh(data=2, model=2))
    on = {path: (tshd.splits_on_model(spec), [
        i - len(spec) for i, a in enumerate(spec) if a == "model"])
        for (path, _), spec in zip(leaves_with_path(params),
                                   tshd.spec_leaves(params, specs))}

    def dim(tail):
        (hit,) = [d for p, d in on.items() if p.endswith(tail)]
        return hit

    assert dim("['embed']['table']") == (True, [-2])
    assert dim("['lm_head']['w']") == (True, [-1])
    assert dim("['wq']['w']") == dim("['gate']['w']") == (True, [-1])
    assert dim("['wo']['w']") == dim("['down']['w']") == (True, [-2])
    assert dim("['ln1']['scale']") == (False, [])
