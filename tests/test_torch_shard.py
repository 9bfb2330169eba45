"""The port's mesh-sharded matmul (``repro_torch.accel.shard``) against the
port unsharded and the JAX package, on spawned ``gloo`` groups.

One group of 4 CPU ranks (``tests/torch_mesh.py``) runs every case at
the 1 x 2, 1 x 4 and 2 x 2 (data x model) meshes: x [8, 256], w [256, 64]
from a seed, ``mlp.gate`` (column tiles) and ``mlp.down`` (row tiles) on
``digital_int``, ``bpbs`` (no noise), ``bpbs_ref`` and ``kernel`` (its
plain version on these CPU tensors), with and without a fused
``Postreduce`` (per-column scale and bias, relu, B_y saturation), on a
whole image sliced per rank and on each rank's compiled tile.  Held:

* at whole-bank per-device rows (``bank_n = 256 // model``), bitwise to
  the port unsharded; a row tile's fused epilogue on ``kernel`` runs
  after the all-reduce, so there it is bitwise to the port's unfused
  ``post.apply(matmul(...))`` and within rtol 1e-6 of the unsharded fused
  kernel (the fused scale register multiplies once: the FMA trap);
* the same cases against the reference's unsharded ``accel.matmul`` on
  the same numpy inputs (``pallas`` in interpret mode for ``kernel``):
  bitwise without ``post``, rtol 1e-6 with it;
* at the default ``bank_n`` (each rank one short bank that digitizes its
  own column sums, not the unsharded result), against the reference's
  own ``sharded_program_matmul`` run in a subprocess with
  ``--xla_force_host_platform_device_count=4``, bitwise without
  ``post``.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro import accel as jaccel
from repro.core.datapath import Postreduce as JPost
from repro_torch import accel as taccel
from repro_torch.accel.program import _compile_image, tile_bounds
from repro_torch.core.datapath import Postreduce

BACKENDS = ["digital_int", "bpbs", "bpbs_ref", "kernel"]
TAGS = {"col": "mlp.gate", "row": "mlp.down"}
JAX_NAME = {"kernel": "pallas"}
ARGS = dict(seed=0, x_shape=(8, 256), w_shape=(256, 64))
DEFAULT_BANK = 2304
FUSED_TOL = dict(rtol=1e-6, atol=1e-6)
# (mesh, tag, reference backend, with post) held to the reference's
# sharded_program_matmul at the default bank_n
REF_SHARDED = ([(m, "mlp.down", "bpbs", False) for m in tm.MESHES]
               + [((1, 2), "mlp.down", "pallas", False),
                  ((1, 2), "mlp.down", "bpbs", True),
                  ((2, 2), "mlp.gate", "bpbs", False)])

_REF_SCRIPT = """
import json
import sys
import jax.numpy as jnp
import numpy as np
from repro import accel
from repro.accel.program import _compile_image, partition_for
from repro.accel.shard import sharded_program_matmul
from repro.core.datapath import Postreduce
from repro.launch.mesh import make_serve_mesh

d = np.load(sys.argv[1])
x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
post = Postreduce(scale=jnp.asarray(d["scale"]), bias=jnp.asarray(d["bias"]),
                  act="relu", saturate=True)
out = {}
for (data, model), tag, backend, with_post in json.loads(str(d["cases"])):
    mesh = make_serve_mesh(data, model)
    spec = accel.ExecSpec(backend=backend, ba=4, bx=4, tag=tag)
    img = _compile_image(w, spec, "p", shards=model,
                         partition=partition_for(tag, *w.shape, model))
    y = sharded_program_matmul(x, spec, img, mesh,
                               post=post if with_post else None)
    out[f"{data}x{model}/{tag}/{backend}/{int(with_post)}"] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""


def _cases():
    return [(tag, be, bank, post, tiled) for tag in TAGS.values()
            for be in BACKENDS for bank in ("whole", DEFAULT_BANK)
            for post in (False, True) for tiled in (False, True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank group's results, with the reference's sharded runs
    made meanwhile in a JAX subprocess."""
    work = tmp_path_factory.mktemp("shard")
    x, w, regs = tm._operands(ARGS)
    np.savez(work / "ops.npz", x=x, w=w, **regs,
             cases=json.dumps(REF_SHARDED))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(tm.REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
         str(work / "ops.npz"), str(work / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=tm.REPO)
    try:
        ranks = tm.spawn("shard", 4, work / "ranks",
                         dict(ARGS, cases=_cases()))
        unsharded = _reference_unsharded(x, w, regs)
    finally:
        log = ref.communicate(timeout=400)[0]
    assert ref.returncode == 0, log
    return ranks, dict(np.load(work / "ref.npz")), (x, w, regs), unsharded


def _reference_unsharded(x, w, regs) -> dict:
    """The reference's unsharded ``accel.matmul`` of every whole-bank
    case, keyed (tag, port backend, bank_n, with post)."""
    import jax.numpy as jnp

    post = JPost(scale=jnp.asarray(regs["scale"]),
                 bias=jnp.asarray(regs["bias"]), act="relu", saturate=True)
    out = {}
    for tag in TAGS.values():
        for backend in BACKENDS:
            for model in sorted({m for _, m in tm.MESHES}):
                for with_post in (False, True):
                    spec = jaccel.ExecSpec(
                        backend=JAX_NAME.get(backend, backend), ba=4, bx=4,
                        tag=tag, bank_n=w.shape[0] // model)
                    out[tag, backend, spec.bank_n, with_post] = np.asarray(
                        jaccel.matmul(jnp.asarray(x), jnp.asarray(w), spec,
                                      post=post if with_post else None))
    return out


def _port_post(regs):
    return Postreduce(scale=torch.from_numpy(regs["scale"]),
                      bias=torch.from_numpy(regs["bias"]), act="relu",
                      saturate=True)


def _results(runs, part, backend, bank):
    """``(key, dispatched, direct)`` of every case of one part/backend at
    ``bank`` ("whole" or the default), from rank 0, each checked equal on
    every rank of its mesh."""
    ranks = runs[0]
    for key, ys in ranks[0].items():
        if key == "local":
            continue
        (y, y_direct), (shape, tag, be, bank_n, with_post, tiled) = ys, key
        if tag != TAGS[part] or be != backend:
            continue
        if (bank == "whole") != (bank_n != DEFAULT_BANK):
            continue
        for r in ranks[1:shape[0] * shape[1]]:
            assert torch.equal(r[key][0], y), (key, "ranks disagree")
        yield key, y, y_direct


@pytest.mark.parametrize("part", ["col", "row"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_equals_port_unsharded(runs, part, backend):
    x, w, regs = runs[2]
    xt, wt, post = torch.from_numpy(x), torch.from_numpy(w), _port_post(regs)
    seen = 0
    for key, y, y_direct in _results(runs, part, backend, "whole"):
        shape, tag, _, bank_n, with_post, tiled = key
        spec = taccel.ExecSpec(backend=backend, ba=4, bx=4, tag=tag,
                               bank_n=bank_n)
        p = post if with_post else None
        with torch.inference_mode():
            want = taccel.matmul(xt, wt, spec, post=p)
            unfused = (p.apply(taccel.matmul(xt, wt, spec), 4, 4)
                       if p is not None else want)
        assert torch.equal(y, y_direct), key
        if backend == "kernel" and part == "row" and with_post:
            assert torch.equal(y, unfused), key
            torch.testing.assert_close(y, want, **FUSED_TOL)
        else:
            assert torch.equal(y, want), key
        seen += 1
    assert seen == len(tm.MESHES) * 4


@pytest.mark.parametrize("part", ["col", "row"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_equals_reference_unsharded(runs, part, backend):
    seen = 0
    for key, y, _ in _results(runs, part, backend, "whole"):
        _, tag, _, bank_n, with_post, tiled = key
        ref = runs[3][tag, backend, bank_n, with_post]
        if with_post:
            np.testing.assert_allclose(y.numpy(), ref, **FUSED_TOL)
        else:
            np.testing.assert_array_equal(y.numpy(), ref)
        seen += 1
    assert seen == len(tm.MESHES) * 4


@pytest.mark.parametrize("case", REF_SHARDED,
                         ids=[f"{d}x{m}-{t}-{b}-{'post' if p else 'nopost'}"
                              for (d, m), t, b, p in REF_SHARDED])
def test_default_bank_equals_reference_sharded(runs, case):
    (data, model), tag, backend, with_post = case
    ref = runs[1][f"{data}x{model}/{tag}/{backend}/{int(with_post)}"]
    port = {"pallas": "kernel"}.get(backend, backend)
    for tiled in (False, True):
        y, y_direct = runs[0][0][((data, model), tag, port, DEFAULT_BANK,
                                  with_post, tiled)]
        if with_post:
            np.testing.assert_allclose(y.numpy(), ref, **FUSED_TOL)
        else:
            np.testing.assert_array_equal(y.numpy(), ref)
        assert torch.equal(y, y_direct)


@pytest.mark.parametrize("part", ["col", "row"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_local_forms_equal_the_gathered_and_sliced_forms(runs, part,
                                                         backend):
    """The local forms attention uses on its own heads: a column tile's
    local output is bitwise the gathered output's rank slice; a row tile
    on the rank's N range is bitwise today's row form, which slices the
    whole input.  Per-tensor and per-row input scales; with the per-row
    scale each rank holds rows whose largest element sits on another
    rank, so only the ``max`` over the model axis gives their grid."""
    x = runs[2][0]
    seen = 0
    for r, rank in enumerate(runs[0]):
        for key, (y, y_local) in rank["local"].items():
            shape, tag, be, _, _, _, per_row = key
            if tag != TAGS[part] or be != backend or r >= shape[0] * shape[1]:
                continue
            k = r % shape[1]
            if part == "col":
                want = y[:, slice(*tile_bounds(y.shape[-1], shape[1], k))]
            else:
                want = y
                lo, hi = tile_bounds(x.shape[-1], shape[1], k)
                top = np.abs(x).argmax(axis=-1)
                assert ((top < lo) | (top >= hi)).any()
            assert torch.equal(y_local, want), (r, key)
            seen += 1
    # every rank of each mesh, with and without post, two scales
    assert seen == sum(d * m for d, m in tm.MESHES) * 2 * 2


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("partition", ["col", "row"])
def test_compiled_tile_is_the_sliced_whole_image(partition, per_channel):
    """A rank's compiled tile holds the bits of the whole image's slice,
    stacked copies included; its accounting is the whole image's."""
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 64, 48)).astype(np.float32))
    spec = taccel.ExecSpec(backend="bpbs", ba=4, bx=4,
                           per_channel=per_channel)
    whole = _compile_image(w, spec, "p", shards=4, partition=partition)
    for k in range(4):
        tile = _compile_image(w, spec, "p", shards=4, partition=partition,
                              tile=k)
        if partition == "row":
            lo, hi = tile_bounds(64, 4, k)
            parts = (whole.ws[:, lo:hi], whole.wq[:, lo:hi], whole.scale)
        else:
            lo, hi = tile_bounds(48, 4, k)
            parts = (whole.ws[..., lo:hi], whole.wq[..., lo:hi],
                     whole.scale[..., lo:hi] if per_channel else whole.scale)
        for got, want in zip((tile.ws, tile.wq, tile.scale), parts):
            assert torch.equal(got, want)
        assert (tile.tile, tile.n, tile.m, tile.tiles, tile.segments) == \
            (k, 64, 48, whole.tiles, whole.segments)
        assert taccel.program.image_matches(tile, spec, w)


def test_tile_without_its_mesh_raises():
    w = torch.ones(64, 48)
    spec = taccel.ExecSpec(backend="bpbs", ba=4, bx=4, tag="mlp.gate")
    tile = _compile_image(w, spec, "p", shards=2, partition="col", tile=1)
    with pytest.raises(RuntimeError, match="run it under its mesh"):
        taccel.matmul(torch.ones(2, 64), w, spec, image=tile)


def test_local_forms_refuse_what_they_cannot_run():
    """A local form needs its own partition on its mesh; an input of
    n / devices is legal only as a local row input; an XNOR 1-bit input
    statistic (a mean) refuses a split input."""
    from repro_torch.accel.backends import quantize_input
    from repro_torch.distributed.autoshard import model_block, use_mesh
    from repro_torch.launch.mesh import ServeMesh

    w = torch.ones(64, 48)
    spec = taccel.ExecSpec(backend="bpbs", ba=4, bx=4, tag="mlp.down")
    row = _compile_image(w, spec, "p", shards=2, partition="row", tile=0)
    mesh = ServeMesh(data=1, model=2)
    with torch.inference_mode(), use_mesh(mesh):
        with pytest.raises(ValueError, match="partition 'row'"):
            taccel.matmul(torch.ones(2, 64), w, spec, image=row, local="col")
        with pytest.raises(ValueError, match="runs only as local='row'"):
            taccel.matmul(torch.ones(2, 32), w, spec, image=row)
        with pytest.raises(ValueError, match="rank's 32"):
            taccel.matmul(torch.ones(2, 64), w, spec, image=row, local="row")
    with pytest.raises(ValueError, match="no matching mesh"):
        taccel.matmul(torch.ones(2, 32), w, spec, image=_compile_image(
            w, spec, "p", shards=2, partition="row"), local="row")
    xnor = taccel.ExecSpec(backend="bpbs", ba=1, bx=1, coding="xnor")
    with pytest.raises(ValueError, match="XNOR 1-bit"):
        quantize_input(torch.ones(2, 32), xnor, split=model_block(mesh))
