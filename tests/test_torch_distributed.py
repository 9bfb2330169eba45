"""The port's distribution layer (``repro_torch.launch.mesh``,
``repro_torch.distributed``) against the JAX package.

The spec rules (``pick_spec``, ``param_specs`` with a program's image
rules, ``batch_specs``, ``cache_specs``, ``paged_cache_specs``) must give
the reference's ``PartitionSpec``s, as tuples, leaf for leaf on reduced
olmo-1b and mamba2-130m at 1 x 2, 1 x 4, 2 x 2 and 2 x 4 (data x model):
the reference runs on a ``jax.sharding.AbstractMesh`` of the shape, the
port on a shape-only ``ServeMesh``.  The mesh object itself (coordinates,
per-axis process groups, collectives and their counts, the refusal of a
job of the wrong size) runs on one spawned group of 4 ``gloo`` ranks.
"""
import jax
import numpy as np
import pytest
import torch

import torch_mesh as tm
from repro import accel as jaccel
from repro.configs import get_config as jget
from repro.distributed import sharding as jshd
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.serve import kv as jkv
from repro_torch import accel as taccel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_jax
from repro_torch.distributed import autoshard
from repro_torch.distributed import sharding as tshd
from repro_torch.launch.mesh import ServeMesh, make_serve_mesh
from repro_torch.models import init_cache as tinit_cache
from repro_torch.serve import kv as tkv

SHAPES = [(1, 2), (1, 4), (2, 2), (2, 4)]
ARCHS = ["olmo-1b", "mamba2-130m"]


def _meshes(data, model):
    return (jax.sharding.AbstractMesh((data, model), ("data", "model")),
            ServeMesh(data=data, model=model))


def _ref_flat(specs) -> dict:
    return {jax.tree_util.keystr(k): tuple(v.spec)
            for k, v in jax.tree_util.tree_flatten_with_path(specs)[0]}


def _port_flat(tree, specs) -> dict:
    """``{keystr: spec}`` of a port spec tree, read beside the paths
    ``_map_with_path`` names for ``tree``."""
    paths = tshd._map_with_path(lambda p, _: p, tree)

    def walk(p, s, out):
        if isinstance(p, str):
            out[p] = s
        elif isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], out)
        elif p is not None:
            for a, b in zip(p, s):
                walk(a, b, out)
        return out

    return walk(paths, specs, {})


@pytest.fixture(scope="module")
def archs():
    out = {}
    for name in ARCHS:
        jc = jget(name).reduced().with_accel("bpbs", ba=4, bx=4)
        pj = jinit(jc, jax.random.PRNGKey(0), max_seq=64)
        pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
        out[name] = (jc, tget(name).reduced().with_accel("bpbs", ba=4, bx=4),
                     pj, pt)
    return out


def test_pick_spec_matches_reference():
    cands = [[["data"], ["model"]], [[("data", "model")], ["model"]],
             [["model"], ["model"], ["data"]], [[None, "data"], ["data"]]]
    for data, model in SHAPES:
        jm, tm_ = _meshes(data, model)
        for shape in ((8, 16), (6, 4), (4, 8, 2), (1, 3)):
            for c in cands:
                assert tshd.pick_spec(shape, tm_, c) == \
                    tuple(jshd.pick_spec(shape, jm, c)), (shape, c)


@pytest.mark.parametrize("mode", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(archs, arch, mode):
    jc, tc, pj, pt = archs[arch]
    for data, model in SHAPES:
        jm, tm_ = _meshes(data, model)
        jprog = jaccel.build_program(pj, jc, model_shards=model,
                                     data_shards=data)
        tprog = taccel.build_program(pt, tc, model_shards=model,
                                     data_shards=data)
        jin = jaccel.install_program(pj, jprog, jc)
        tin = taccel.install_program(pt, tprog, tc)
        want = _ref_flat(jshd.param_specs(
            jax.eval_shape(lambda: jin), jm, jshd.ShardPolicy(mode),
            program=jprog))
        got = _port_flat(tin, tshd.param_specs(
            tin, tm_, tshd.ShardPolicy(mode), program=tprog))
        assert got == want, (data, model)
        assert any(".ws" in k and "model" in v for k, v in got.items()) \
            or model == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(archs, arch):
    jc, tc, _, _ = archs[arch]
    for data, model in SHAPES:
        jm, tm_ = _meshes(data, model)
        for batch in (1, 4):
            jcache = jax.eval_shape(lambda: jinit_cache(jc, batch, 64))
            tcache = tinit_cache(tc, batch, 64, device="meta")
            assert _port_flat(tcache, tshd.cache_specs(
                tcache, tm_, batch)) == _ref_flat(jshd.cache_specs(
                    jcache, jm, batch)), (data, model, batch)
        toks = {"tokens": torch.zeros(4, 8, dtype=torch.int64),
                "mask": torch.zeros(4, 8)}
        assert _port_flat(toks, tshd.batch_specs(toks, tm_, 4)) == \
            _ref_flat(jshd.batch_specs(jax.eval_shape(
                lambda: {k: jax.numpy.zeros(v.shape) for k, v in
                         toks.items()}), jm, 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_specs_match_reference(archs, arch):
    jc, tc, _, _ = archs[arch]
    for data, model in SHAPES:
        jm, tm_ = _meshes(data, model)
        for n_slots, blocks in ((4, None), (3, 6)):
            jl = jkv.build_layout(jc, n_slots, 64, 16, blocks)
            tl = tkv.build_layout(tc, n_slots, 64, 16, blocks)
            jp = jax.eval_shape(lambda: jkv.init_paged_cache(jl))
            tp = tkv.init_paged_cache(tl, device="meta")
            want = _ref_flat(jkv.paged_cache_specs(jp, jl, jm))
            got = _port_flat(tp, tkv.paged_cache_specs(tp, tl, tm_))
            assert got == want, (data, model, n_slots)


def test_local_slice_cuts_the_rank_block():
    t = torch.arange(8 * 6 * 2).reshape(8, 6, 2)
    for rank in range(8):
        mesh = ServeMesh(data=2, model=4, rank=rank)
        d, m = mesh.coords
        k = d * 4 + m
        assert torch.equal(tshd.local_slice(t, ("data",), mesh),
                           t[4 * d:4 * d + 4])
        assert torch.equal(tshd.local_slice(t, (("data", "model"),), mesh),
                           t[k:k + 1])
        assert torch.equal(tshd.local_slice(t, ("model", None, "data"),
                                            mesh), t[2 * m:2 * m + 2, :, d:d + 1])


def test_autoshard_scopes():
    mesh = ServeMesh(data=2, model=4)
    assert autoshard.get_mesh() is None and autoshard.mesh_axis_size(
        "model") == 1
    pol = tshd.ShardPolicy(data_shards=2)
    with autoshard.use_mesh(mesh, pol):
        assert autoshard.get_mesh() is mesh
        assert autoshard.mesh_axis_size("model") == 4
        assert autoshard.get_shard_policy() is pol
        assert not autoshard.in_manual("data")
        with autoshard.manual("data"):
            assert autoshard.in_manual("data")
            assert not autoshard.in_manual("model")
            assert not autoshard.in_manual()
            with autoshard.manual():
                assert autoshard.in_manual()
        assert not autoshard.in_manual("data")
    assert autoshard.get_mesh() is None
    assert autoshard.get_shard_policy() is tshd.DEFAULT_POLICY


def test_shard_policy_validation_matches_reference():
    for bad in (dict(mode="tp"), dict(data_shards=0)):
        with pytest.raises(ValueError) as te:
            tshd.ShardPolicy(**bad)
        with pytest.raises(ValueError) as je:
            jshd.ShardPolicy(**bad)
        assert str(te.value) == str(je.value)


def test_make_serve_mesh_argument_errors():
    with pytest.raises(ValueError, match="backend must be one of"):
        make_serve_mesh(1, 1, backend="mpi")
    one = make_serve_mesh(1, 1, backend="gloo", device="cpu")
    assert (dict(one.shape), one.coords) == ({"data": 1, "model": 1}, (0, 0))
    x = torch.ones(3)
    assert one.all_reduce(x, "model") is x and \
        one.all_gather(x, "data", 0) is x


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return tm.spawn("mesh", 4, tmp_path_factory.mktemp("mesh"), {})


@pytest.mark.parametrize("shape", tm.MESHES)
def test_mesh_groups_and_collectives(group, shape):
    data, model = shape
    for rank, res in enumerate(group):
        got = res[shape]
        if rank >= data * model:
            assert got is None
            continue
        d, m = divmod(rank, model)
        assert got["coords"] == (d, m)
        assert got["shape"] == {"data": data, "model": model}
        assert got["axis_names"] == ("data", "model")
        row = [d * model + j for j in range(model)]
        col = [i * model + m for i in range(data)]
        assert got["model_sum"].tolist() == [[float(sum(row)), model]]
        assert got["data_sum"].tolist() == [[float(sum(col)), data]]
        assert got["model_cat"].tolist() == [
            [v for j in row for v in (float(j), 1.0)]]
        assert got["data_cat"].tolist() == [[float(i), 1.0] for i in col]
        n = (model > 1) * 2 + (data > 1) * 2
        assert got["stats"]["collectives"] == n
        assert got["stats"]["bytes"] == n * 8


def test_mesh_of_the_wrong_size_is_refused(group):
    for res in group:
        assert res["refused 3x1"].startswith(
            "make_serve_mesh(3x1) needs 3 processes, have 4")
        assert res["refused 2x4"].startswith(
            "make_serve_mesh(2x4) needs 8 processes, have 4")
    assert [r["host"] for r in group] == [
        ({"data": 2, "model": 2}, divmod(r, 2)) for r in range(4)]
