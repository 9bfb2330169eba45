"""Sharded training: the port's train step, trainer, ``state_specs`` and
``compress_psum`` on a ``data x model`` mesh of spawned ``gloo`` ranks,
against the port unsharded and the JAX package.

Reduced olmo-1b, mamba2-130m and deepseek-v2-lite-16b (the reference's
``init_params`` converted key for key) on ``bpbs`` without noise, 8 x 8
tokens a step from a seed.  One group of 8 CPU ranks (``tests/
torch_mesh.py::task_train``) runs every case on its 1 x 2, 2 x 2 and
2 x 4 meshes (data x model) in modes ``"2d"`` and ``"fsdp"``; the
reference's single-device step runs in this process, its
``compress_psum`` under ``shard_map`` in a subprocess with 4 forced host
devices, both while the ranks run.  deepseek's MoE blocks route, drop
and score the aux loss over the global batch's tokens and, in ``"2d"``,
split the experts over "model" (``models/moe.py``); it also runs one
step at capacity factor 0.5 (drops that a per-rank capacity would place
elsewhere) and one with remat on.  Held:

* ``state_specs`` equals the reference's leaf for leaf, as tuples, on a
  ``jax.sharding.AbstractMesh``;
* ``compress_psum`` over ``("data",)`` and ``("data", "model")`` equals
  the reference's, rtol 1e-6;
* step 1: each rank's logits on its rows bitwise the unsharded rows (the
  per-tensor input scale is the global batch's: without the dp-axis
  reduction every row moves), the loss and the aux metric within rtol
  1e-6, the MoE dispatches' drops bitwise, the gradient summed over the
  dp axes (an expert leaf's blocks from the ranks that compute them)
  within rtol 1e-5 of each leaf's largest magnitude, mu and nu as this
  rank's slices of the unsharded state
  (same rtol) and the parameters as well, each element allowed twice
  the learning rate where AdamW's normalized update of a gradient
  element near zero takes its sign from the summation order (as
  ``tests/test_torch_train.py::_params_close`` holds them); blocks that
  ranks share bitwise equal on every rank;
* over 3 steps, losses within 5e-3 relative of the port unsharded and of
  the reference's single-device ``build_train_step`` (the reference's
  own invariant and tolerance, ``tests/test_distributed.py``);
* compression on a mesh bitwise the unsharded compression of the reduced
  gradient, sliced;
* ``train(mesh=)``: a crash and resume on 2 x 2 lands on the
  uninterrupted final loss bitwise, the 2 x 2 checkpoint (full leaves)
  resumes on 1 x 2 and on one process within 5e-3;
* ``autoshard.gather``'s backward sums over the dp axes and keeps the
  block over "model" in "2d", ``sum_grad``'s sums over "model", each
  with its count of collectives; ``expert_block`` is the E block of the
  expert leaves' ``state_specs``; a reduce-scatter takes its backend's
  form.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro.configs import get_config as jget
from repro.data import pipeline as jdata
from repro.distributed import sharding as jshd
from repro.models import init_params as jinit
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as jinit_state
from repro.train.step import build_train_step as jbuild_step
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.core.quant import Coding, quantize
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.mesh import RecordingMesh, ServeMesh
from repro_torch.models import forward as tforward
from repro_torch.models import moe as tmoe
from repro_torch.models import loss_fn as tloss
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.roofline.hlo_stats import StepCounter
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.state import init_train_state as tinit_state
from repro_torch.train.step import build_train_step as tbuild_step
from repro_torch.train.step import value_and_grad
from repro_torch.train.trainer import TrainerConfig, train
from repro_torch.tree import leaves, leaves_with_path

SPEC = dict(ba=4, bx=4)
SHAPES = [(1, 2), (1, 4), (2, 2), (2, 4)]
MODES = ["2d", "fsdp"]
COMP = tcomp.CompressionConfig(bits=8)
MOE = "deepseek-v2-lite-16b"
# variants of the MoE config: (name, fields replaced)
MOE_TIGHT, MOE_REMAT = MOE + "/capacity0.5", MOE + "/remat"
VARIANTS = {MOE_TIGHT: dict(moe_capacity_factor=0.5),
            MOE_REMAT: dict(remat=True)}
# (mesh, mode, config, steps, compression); the compression case last
CASES = ([(m, mode, "olmo-1b", 3, None) for m in [(1, 2), (2, 2), (2, 4)]
          for mode in MODES]
         + [((2, 2), "fsdp", "mamba2-130m", 3, None)]
         + [(m, mode, MOE, 3, None)
            for m, mode in [((1, 2), "2d"), ((2, 2), "2d"), ((2, 2), "fsdp")]]
         + [((2, 2), "2d", MOE_TIGHT, 1, None),
            ((2, 2), "2d", MOE_REMAT, 1, None),
            ((2, 2), "2d", "olmo-1b", 2, COMP)])
STEP_CASES = [c for c in CASES if c[4] is None]
THREE_STEP_CASES = [c for c in STEP_CASES if c[3] == 3]
MOE_CASES = [c for c in STEP_CASES if c[2].startswith(MOE)]
PSUM_AXES = [("data",), ("data", "model")]
PSUM_BITS = [8, 4]
TRAINER = dict(total=6, crash=4, mode="fsdp")
LOSS_RTOL = 5e-3

_PSUM_SCRIPT = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import compress_psum

d = np.load(sys.argv[1])
g = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("g_")}
e = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("e_")}
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
spec = P(("data", "model"))
out = {}
for axes in (("data",), ("data", "model")):
    for bits in (8, 4):
        def body(g, e, axes=axes, bits=bits):
            one = lambda t: jax.tree.map(lambda a: a[0], t)
            red, err = compress_psum(one(g), one(e), axes, bits)
            return (jax.tree.map(lambda a: a[None], red),
                    jax.tree.map(lambda a: a[None], err))
        red, err = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec), check_rep=False)(g, e)
        for k in red:
            out[f"{'+'.join(axes)}/{bits}/red/{k}"] = np.asarray(red[k])
            out[f"{'+'.join(axes)}/{bits}/err/{k}"] = np.asarray(err[k])
np.savez(sys.argv[2], **out)
"""


def _data(cfg, mod=tdata):
    return mod.DataConfig(seq_len=8, global_batch=8, vocab=cfg.vocab, seed=3)


def _opt(mod=tadamw):
    return mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _psum_inputs() -> list:
    """Per rank of the 2 x 2 mesh: (gradient, error), numpy trees whose
    ranks' amax differ."""
    r = np.random.default_rng(5)
    return [({"a": (r.normal(size=(6, 5)) * (1 + k)).astype(np.float32),
              "b": r.normal(size=(7,)).astype(np.float32)},
             {"a": (0.01 * r.normal(size=(6, 5))).astype(np.float32),
              "b": (0.01 * r.normal(size=(7,))).astype(np.float32)})
            for k in range(4)]


@pytest.fixture(scope="module")
def setup():
    out = {}
    for name in ("olmo-1b", "mamba2-130m", MOE):
        jc = jget(name).reduced().with_accel("bpbs", **SPEC)
        pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
        tc = tget(name).reduced().with_accel("bpbs", **SPEC)
        out[name] = (jc, pj, tc,
                     params_from_jax(jax.tree.map(np.asarray, pj), "cpu"))
    for name, fields in VARIANTS.items():
        jc, pj, tc, pt = out[MOE]
        out[name] = (dataclasses.replace(jc, **fields), pj,
                     dataclasses.replace(tc, **fields), pt)
    return out


def _unsharded(tc, params, steps: int, comp=None) -> dict:
    """The port unsharded: logits and gradient at ``params`` on the first
    batch, then ``steps`` steps' losses and states."""
    data = _data(tc)
    batch = tdata.make_batch(data, 0, "cpu")
    with torch.no_grad(), tm.recorded_dispatch() as dispatches:
        logits = tforward(params, batch["tokens"], tc)[0]
    (_, m), grads = value_and_grad(lambda p: tloss(p, batch, tc), params)
    state = tinit_state(params, comp is not None)
    step = tbuild_step(tc, _opt(), comp)
    out = dict(logits=logits, grad=grads, loss0=float(m["loss"]),
               aux0=float(m["aux"]), dispatches=dispatches, steps=[])
    for s in range(steps):
        state, m = step(state, tdata.make_batch(data, s, "cpu"))
        out["steps"].append(dict(loss=float(m["loss"]), aux=float(m["aux"]),
                                 grad_norm=float(m["grad_norm"]),
                                 state=state))
    return out


def _reference_losses(jc, pj, steps: int) -> list:
    """The reference's single-device ``build_train_step``."""
    step = jax.jit(jbuild_step(jc, _opt(jadamw)))
    state, data, out = jinit_state(pj), _data(jc, jdata), []
    for s in range(steps):
        state, m = step(state, jdata.make_batch(data, s))
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The 8-rank group's results, the reference's (single device and
    ``shard_map``) and the port's unsharded ones."""
    work = tmp_path_factory.mktemp("train_mesh")
    psum = _psum_inputs()
    np.savez(work / "psum.npz",
             **{f"g_{k}": np.stack([g[k] for g, _ in psum]) for k in "ab"},
             **{f"e_{k}": np.stack([e[k] for _, e in psum]) for k in "ab"})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(tm.REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_PSUM_SCRIPT),
         str(work / "psum.npz"), str(work / "psum_ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=tm.REPO)
    tc = setup["olmo-1b"][2]
    args = dict(configs={n: (v[2], v[3]) for n, v in setup.items()},
                cases=CASES, data=_data(tc), opt=_opt(), psum=psum,
                psum_axes=PSUM_AXES, psum_bits=PSUM_BITS,
                trainer=dict(TRAINER, root=str(work / "ckpt"), cfg=tc,
                             data=_data(tc), opt=_opt()))
    try:
        wait = tm.start("train", 8, work / "ranks", args, timeout=600)
        torch.set_num_threads(2)
        flat, jref = {}, {}
        for name, (jc, pj, tcfg, pt) in setup.items():
            steps = max(c[3] for c in CASES if c[2] == name)
            flat[name] = _unsharded(tcfg, pt, steps)
            if steps == 3:
                jref[name] = _reference_losses(jc, pj, 3)
        flat["comp"] = _unsharded(tc, setup["olmo-1b"][3], 2, COMP)
        ranks = wait()
    finally:
        log = ref.communicate(timeout=400)[0]
    assert ref.returncode == 0, log
    return dict(ranks=ranks, flat=flat, jref=jref, work=work,
                psum_ref=dict(np.load(work / "psum_ref.npz")))


# ------------------------------------------------------------ state_specs

def _ref_flat(specs) -> dict:
    return {jax.tree_util.keystr(k): tuple(v.spec)
            for k, v in jax.tree_util.tree_flatten_with_path(specs)[0]}


@pytest.mark.parametrize("errors", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m",
                                  "deepseek-v2-lite-16b"])
def test_state_specs_match_reference(arch, shape, mode, errors):
    jc = jget(arch).reduced()
    shapes = jax.eval_shape(
        lambda: jinit_state(jinit(jc, jax.random.PRNGKey(0), max_seq=64),
                            errors))
    amesh = jax.sharding.AbstractMesh(shape, ("data", "model"))
    want = _ref_flat(jshd.state_specs(shapes, amesh,
                                      jshd.ShardPolicy(mode)))
    state = tinit_state(params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes.params),
        "cpu"), errors)
    specs = tshd.state_specs(state, ServeMesh(*shape),
                             tshd.ShardPolicy(mode))
    got = dict(zip((n for n, _ in leaves_with_path(state)),
                   tshd.spec_leaves(state, specs)))
    assert got == want
    assert (specs.error is None) == (not errors)


# -------------------------------------------------------------- the mesh

def test_mesh_max_and_axis_tuple_collectives(runs):
    """On 2 x 2: max over "data", max and sum over ("data", "model"), a
    gather over the tuple in row-major rank order; each axis's collective
    counted with its bytes."""
    for r, res in enumerate(runs["ranks"][:4]):
        got = res["collectives"]
        m = r % 2
        assert torch.equal(got["max_data"], torch.tensor([[2.0 + m, -m]]))
        assert torch.equal(got["max_both"], torch.tensor([[3.0, 0.0]]))
        assert torch.equal(got["sum_both"], torch.tensor([[6.0, -6.0]]))
        assert torch.equal(got["cat_both"], torch.tensor(
            [[float(k), -float(k)] for k in range(4)]))
        assert got["counted"] == 7 and got["counted_bytes"] == 64


@pytest.mark.parametrize("bits", PSUM_BITS)
@pytest.mark.parametrize("axes", PSUM_AXES)
def test_compress_psum_matches_reference(runs, axes, bits):
    ref = runs["psum_ref"]
    for r, res in enumerate(runs["ranks"][:4]):
        red, err = res[("psum", axes, bits)]
        for k in "ab":
            for got, what in ((red, "red"), (err, "err")):
                want = ref[f"{'+'.join(axes)}/{bits}/{what}/{k}"][r]
                np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())


# --------------------------------------------------------------- the step

def _rank_results(runs, case) -> list:
    (d, m) = case[0]
    return [res[case] for res in runs["ranks"][:d * m]]


def _close(got, want, rtol=1e-5):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _params_close(got, want, lr: float, rtol=1e-5):
    d = np.abs(got.numpy() - want.numpy())
    tol = rtol * np.abs(want.numpy()).max()
    assert d.max() <= tol + 2 * lr, d.max()
    assert (d > tol + 0.01 * lr).sum() <= max(1, d.size // 1000)


def _shared_blocks_equal(results, key):
    """Leaves ranks hold the same block of (replicated leaves, dims no
    axis divides, the axes a leaf is not split over) are bitwise equal
    across those ranks."""
    shape = dict(zip(("data", "model"), key[0]))
    specs = results[0]["specs"]
    state0 = results[0]["steps"][-1]["state"]
    for i, spec in enumerate(tshd.spec_leaves(state0, specs)):
        axes = tshd.sharded_axes(spec)
        blocks: dict = {}
        for res in results:
            coords = dict(zip(("data", "model"), res["coords"]))
            block = tuple(coords[a] for a in axes)
            leaf = leaves(res["steps"][-1]["state"])[i]
            if block in blocks:
                assert torch.equal(leaf, blocks[block]), (key, i, block)
            blocks[block] = leaf
        assert len(blocks) == int(np.prod([shape[a] for a in axes]))


@pytest.mark.parametrize("case", STEP_CASES, ids=str)
def test_step_one_on_mesh_matches_unsharded(runs, case):
    flat = runs["flat"][case[2]]
    results = _rank_results(runs, case)
    lr = 1e-3 * 0.5                       # warmup step 1 of 2
    for res in results:
        rows = res["rows"]
        assert torch.equal(res["logits"], flat["logits"][rows]), \
            f"rank {res['coords']}: logits on rows {rows.tolist()}"
        np.testing.assert_allclose(float(res["loss0"]), flat["loss0"],
                                   rtol=1e-6)
        np.testing.assert_allclose(res["steps"][0]["loss"],
                                   flat["steps"][0]["loss"], rtol=1e-6)
        for got, want in ((float(res["aux0"]), flat["aux0"]),
                          (res["steps"][0]["aux"], flat["steps"][0]["aux"])):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        assert len(res["dispatches"]) == len(flat["dispatches"])
        for (gi, keep), (gi_want, keep_want) in zip(res["dispatches"],
                                                    flat["dispatches"]):
            assert torch.equal(gi, gi_want) and torch.equal(keep, keep_want)
        for (name, g), want in zip(leaves_with_path(res["grad"]),
                                   leaves(flat["grad"])):
            _close(g, want)
        mesh = ServeMesh(*case[0])
        mesh.rank = res["coords"][0] * mesh.model + res["coords"][1]
        got, want = res["steps"][0]["state"], flat["steps"][0]["state"]
        specs = res["specs"]
        for tree, ref, spec_tree, kind in (
                (got.params, want.params, specs.params, "params"),
                (got.opt.mu, want.opt.mu, specs.opt.mu, "mu"),
                (got.opt.nu, want.opt.nu, specs.opt.nu, "nu")):
            for g, w, s in zip(leaves(tree), leaves(ref),
                               tshd.spec_leaves(ref, spec_tree)):
                w = tshd.local_slice(w, s, mesh)
                assert g.shape == w.shape
                if kind == "params":
                    _params_close(g, w, lr)
                else:
                    _close(g, w)
        assert int(got.step) == 1 and int(got.opt.count) == 1
    _shared_blocks_equal(results, case)


@pytest.mark.parametrize("case", THREE_STEP_CASES, ids=str)
def test_three_steps_match_unsharded_and_reference(runs, case):
    flat = [s["loss"] for s in runs["flat"][case[2]]["steps"]]
    ref = runs["jref"][case[2]]
    for res in _rank_results(runs, case):
        got = [s["loss"] for s in res["steps"]]
        np.testing.assert_allclose(got, flat, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            [s["grad_norm"] for s in res["steps"]],
            [s["grad_norm"] for s in runs["flat"][case[2]]["steps"]],
            rtol=LOSS_RTOL)
        assert [s["tokens"] for s in res["steps"]] == [8.0 * 7] * 3


def test_moe_case_routes_every_block_and_the_tight_one_drops(runs):
    """Every MoE case dispatched once a MoE layer over the 64 global
    tokens; at capacity factor 0.5 tokens drop on both data blocks, and
    a per-rank capacity and dispatch (what a rank's own ``moe_ffn``
    would run) would keep another set."""
    n_moe = sum(k == "moe" for k in tget(MOE).reduced().pattern())
    for case in MOE_CASES:
        for res in _rank_results(runs, case):
            assert len(res["dispatches"]) == n_moe, case
            assert all(gi.shape[0] == 64 for gi, _ in res["dispatches"])
    cfg = dataclasses.replace(tget(MOE).reduced(), **VARIANTS[MOE_TIGHT])
    k = cfg.experts_per_tok
    differ = 0
    for gate_idx, keep in runs["flat"][MOE_TIGHT]["dispatches"]:
        dropped = (~keep).nonzero()[:, 0] // k          # token ids
        assert set((dropped // 32).tolist()) == {0, 1}
        local = []
        for block in (gate_idx[:32], gate_idx[32:]):
            order, _, _, kept, _ = tmoe.dispatch(
                block, cfg.n_experts, tmoe.capacity(32, cfg))
            in_tokens = torch.empty_like(kept)
            in_tokens[order] = kept
            local.append(in_tokens)
        differ += int(not torch.equal(torch.cat(local), keep))
    assert differ > 0


@pytest.mark.parametrize("mode,axes,fn", [
    ("2d", ("data",), "gather"), ("2d", ("model",), "gather"),
    ("fsdp", ("data", "model"), "gather"), ("2d", ("model",), "sum_grad")])
def test_gather_backward_follows_what_the_axes_mean(runs, mode, axes, fn):
    """On 2 x 2, rank (d, m) = 2 d + m holds ``[[rank, 1]]`` and scores
    ``(y * w).sum()`` with ``w`` = arange times (rank + 1).  Over the dp
    axes the gradient is the sum of the ranks' ``w`` blocks at this
    rank's block (a reduce-scatter: on gloo an all-reduce), over "model"
    in "2d" this rank's own ``w`` block (no collective); ``sum_grad``
    sums ``w`` over "model"."""
    for r, res in enumerate(runs["ranks"][:4]):
        y, grad, count = res["gather"][(mode, axes, fn)]
        d, m = divmod(r, 2)
        group = {("data",): [m, 2 + m], ("model",): [2 * d, 2 * d + 1],
                 ("data", "model"): [0, 1, 2, 3]}[axes]
        if fn == "sum_grad":
            assert torch.equal(y, torch.tensor([[float(r), 1.0]]))
            want = torch.tensor([[0.0, 1.0]]) * sum(q + 1 for q in group)
            assert torch.equal(grad, want) and count == 1
            continue
        assert torch.equal(y, torch.tensor([[float(q), 1.0]
                                            for q in group]))
        block = group.index(r)
        row = torch.tensor([[2.0 * block, 2.0 * block + 1]])
        summed = mode == "fsdp" or axes == ("data",)
        scale = sum(q + 1 for q in group) if summed else r + 1
        assert torch.equal(grad, row * scale), (mode, axes, r)
        assert count == len(axes) * (2 if summed else 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4), (1, 3)])
def test_expert_block_is_the_state_specs_slice(shape, mode):
    """A rank's experts are the E block of its slice of the expert leaves
    under ``state_specs`` where their E axis is not a dp axis ("2d"),
    else every expert: at E = 8 on 1 x 3 the spec falls back."""
    from repro_torch.models import init_params

    state = tinit_state(init_params(tget(MOE).reduced(), 0, "meta"))
    path = ("stack", "scanned", "u0", "moe", "w_gate")
    leaf = state.params
    for k in path:
        leaf = leaf[k]
    policy = tshd.ShardPolicy(mode)
    for rank in range(shape[0] * shape[1]):
        mesh = ServeMesh(*shape, rank=rank)
        spec = tshd.state_specs(state, mesh, policy).params
        for k in path:
            spec = spec[k]
        axes, lo, n = tshd.expert_block(leaf.shape, mesh, policy)
        if mode == "2d" and shape[1] in (2, 4):
            assert spec[1] == "model" and axes == ("model",)
            ids = tshd.local_slice(torch.arange(8), ("model",), mesh)
            assert list(range(lo, lo + n)) == ids.tolist()
        else:
            assert (axes, lo, n) == ((), 0, 8)


@pytest.mark.parametrize("backend,kind", [("nccl", "reduce-scatter"),
                                          ("gloo", "all-reduce"),
                                          (None, "all-reduce")])
def test_reduce_scatter_takes_its_backends_form(backend, kind):
    """On the recording mesh: nccl's one reduce-scatter an axis, anything
    else an all-reduce and this rank's block; counted as what runs."""
    mesh = RecordingMesh(data=2, model=4, backend=backend,
                         device=torch.device("meta"))
    t = torch.empty((8, 3), device="meta")
    with StepCounter() as c:
        out = mesh.reduce_scatter(t, ("data", "model"), 0)
    assert out.shape == (1, 3)
    hs = c.stats()
    assert hs["collectives"][kind]["count"] == 2
    assert hs["collectives_by_axis"]["data"] == {"count": 1, "bytes": 96}
    assert hs["collectives_by_axis"]["model"] == {"count": 1, "bytes": 48}
    assert mesh.stats == {"collectives": 2, "bytes": 144}


def test_mesh_step_clock_counts_its_collectives(runs):
    """The 2 x 2 fsdp step's phases: the gather and the gradient's
    reduction one collective a sharded leaf and axis, the forward's
    statistics two a quantized input (one an axis) plus the loss's two
    counts, the update's per-leaf norms one an axis."""
    case = ((2, 2), "fsdp", "olmo-1b", 3, None)
    cfg = runs["ranks"][0][case]
    n_leaves = len(leaves(cfg["steps"][0]["state"].params))
    layers = tget("olmo-1b").reduced().n_layers
    for res in _rank_results(runs, case):
        for step in res["clock"]:
            assert step["gather_collectives"] == 2 * n_leaves
            assert step["reduce_collectives"] == 2 * n_leaves
            assert step["compute_collectives"] == 2 * (7 * layers + 1 + 2)
            assert step["update_collectives"] == 2
            assert all(step[f"{p}_ms"] > 0 for p in
                       ("gather", "compute", "reduce", "update"))


def test_compression_on_mesh_equals_unsharded_compression(runs):
    case = CASES[-1]
    mesh = ServeMesh(*case[0])
    for res in _rank_results(runs, case):
        mesh.rank = res["coords"][0] * mesh.model + res["coords"][1]
        grads, err = res["comp_full"]
        want = tcomp.compress_decompress(grads, err, COMP.bits)
        for got_tree, want_tree in zip(res["comp_slices"], want):
            for g, w, s in zip(leaves(got_tree), leaves(want_tree),
                               tshd.spec_leaves(want_tree,
                                                res["specs"].params)):
                assert torch.equal(g, tshd.local_slice(w, s, mesh))
        got = [s["loss"] for s in res["steps"]]
        flat = [s["loss"] for s in runs["flat"]["comp"]["steps"]]
        np.testing.assert_allclose(got, flat, rtol=LOSS_RTOL)
        assert res["steps"][-1]["state"].error is not None


# ------------------------------------------------------------ the trainer

def test_trainer_crash_and_elastic_resume(runs):
    work = runs["work"] / "ckpt"
    t = [res["trainer"] for res in runs["ranks"]]
    ref = t[0]["ref"]
    assert all(r["crashed"] for r in t[:4])
    for r in t[:4]:
        assert r["ref"] == ref
        assert r["resumed"][0]["step"] == TRAINER["crash"]
        assert r["resumed"][-1]["loss"] == ref[-1]["loss"]
    for r in t[:2]:
        res = r["resumed_1x2"]
        assert res[0]["step"] == TRAINER["crash"]
        np.testing.assert_allclose(res[-1]["loss"], ref[-1]["loss"],
                                   rtol=LOSS_RTOL)
    assert not any(t[4:])
    tc = tget("olmo-1b").reduced().with_accel("bpbs", **SPEC)
    tcfg = TrainerConfig(total_steps=TRAINER["total"],
                         ckpt_dir=str(work / "crash_1x1"), ckpt_every=2,
                         log_every=100)
    _, res = train(tc, _data(tc), _opt(), tcfg, log_fn=lambda s: None,
                   device="cpu")
    assert res[0]["step"] == TRAINER["crash"]
    np.testing.assert_allclose(res[-1]["loss"], ref[-1]["loss"],
                               rtol=LOSS_RTOL)
    # the 2 x 2 job's checkpoint holds full leaves under the unsharded
    # manifest
    from repro_torch.models import init_params

    full = tinit_state(init_params(tc, 3, "cpu"))
    path = tckpt.latest_checkpoint(str(work / "crash_1x2"))
    with open(os.path.join(path, "manifest.json")) as f:
        names = json.load(f)["names"]
    assert names == [n for n, _ in leaves_with_path(full)]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, (_, leaf) in enumerate(leaves_with_path(full)):
            assert z[f"a{i}"].shape == tuple(leaf.shape)


def test_restore_under_specs_cuts_this_ranks_slices(tmp_path):
    """``restore(..., sharding_tree=, mesh=)`` of an unsharded save: each
    leaf this rank's slice, the replicated ones whole."""
    tc = tget("olmo-1b").reduced()
    from repro_torch.models import init_params

    state = tinit_state(init_params(tc, 0, "cpu"))
    path = tckpt.save(str(tmp_path), 2, state)
    mesh = ServeMesh(data=2, model=2, rank=3)
    specs = tshd.state_specs(state, mesh, tshd.ShardPolicy("2d"))
    got, step = tckpt.restore(path, state, specs, mesh)
    assert step == 2
    for g, w, s in zip(leaves(got), leaves(state),
                       tshd.spec_leaves(state, specs)):
        assert torch.equal(g, tshd.local_slice(w, s, mesh))
    assert got.params["embed"]["table"].shape == (256, 64)


# ---------------------------------------------------- global statistics

class _Ranks:
    """Two equal row blocks of one tensor seen as two ranks: the
    statistic's reductions over both blocks."""

    def __init__(self, parts, fn):
        self.parts, self.fn, self.size = parts, fn, len(parts)

    def max(self, t):
        return torch.amax(torch.stack([self.fn(p, "max") for p in
                                       self.parts]), 0)

    def sum(self, t):
        return torch.stack([self.fn(p, "sum") for p in self.parts]).sum(0)


@pytest.mark.parametrize("coding,bits", [(Coding.AND, 4), (Coding.XNOR, 4),
                                         (Coding.XNOR, 1)])
def test_quantize_across_blocks_is_the_whole_tensors_grid(coding, bits):
    """A block quantized with its statistic reduced over the blocks lands
    on the whole tensor's grid: bitwise for an amax, within float32
    rounding for the XNOR 1-bit mean.  Without the reduction the blocks'
    scales differ."""
    r = np.random.default_rng(0)
    x = torch.from_numpy((r.normal(size=(8, 32)) * np.arange(1, 9)[:, None])
                         .astype(np.float32))
    parts = [x[:4], x[4:]]

    def stat(p, op):
        a = p.abs()
        return a.amax() if op == "max" else a.sum()

    whole = quantize(x, bits, coding)
    across = _Ranks(parts, stat)
    assert not torch.equal(quantize(parts[0], bits, coding).scale,
                           whole.scale)
    for k, p in enumerate(parts):
        q = quantize(p, bits, coding, across=across)
        assert torch.equal(q.q, whole.q[4 * k:4 * k + 4])
        if coding == Coding.XNOR and bits == 1:
            np.testing.assert_allclose(float(q.scale), float(whole.scale),
                                       rtol=1e-6)
        else:
            assert torch.equal(q.scale, whole.scale)


# -------------------------------------------------------------- refusals

def test_sharded_arguments_without_their_mesh_refuse(tmp_path):
    tc = tget("olmo-1b").reduced()
    tcfg = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mesh"):
        train(tc, _data(tc), _opt(), tcfg, state_shardings=(),
              device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tcomp.compress_psum({"a": torch.ones(2)}, {"a": torch.zeros(2)},
                            ("data",))
    with pytest.raises(ValueError, match="mesh"):
        tckpt.restore(str(tmp_path), {}, sharding_tree={})
