"""MLA, the SSD mixer and the RG-LRU on each rank's share of a serving
mesh (``repro_torch.models.mixer_split``).

The mode table is the reference's ``cs`` rule on each mixer's own
constraint, read from ``repro.distributed.autoshard.cs`` itself (its
sharding call captured): MLA's q heads (``repro/models/attention.py:
394-396``), SSD's ``xs`` on its heads else its head dim
(``repro/models/ssm.py:167-168``), the RG-LRU's ``xr`` on its width
(``repro/models/rglru.py:81-82``).  At published widths:

| config | model axis m | split |
|---|---|---|
| mamba2-130m (24 heads of 64) | 2, 4 and 8 | "heads" |
| mamba2-130m | 16 | "p" |
| recurrentgemma-9b (width 4,096) | every m | "width" |
| deepseek-v2-lite (16 heads) | every m | "heads" |

On a spawned 1 x 2 gloo mesh (``tests/torch_mesh.py::serve_mixer``):
reduced deepseek-v2-lite at 2 layers (MLA, 2 of 4 heads a rank; an
attention and a MoE block), reduced mamba2-130m in "heads" (4 of 8
heads a rank) and in "p" (``d_model`` 48 on both packages' configs: 3
heads of 32, 16 head dims a rank), and reduced recurrentgemma-9b (LRU
width 64 of 128 a rank), each on ``digital_int``, the reference run
eagerly on the port's seeded weights as numpy.  Held: the splits and
the ranks' state and cache shapes; greedy tokens equal to the port
unsharded, the first two also to the reference's greedy picks;
``digital_int`` logits of a
prefill and of the decode step after it bitwise to the port unsharded
for MLA and both SSD modes (the per-head sums of squares are gathered,
so the norm's mean is the unsharded one), within 1e-5 for the RG-LRU
(its gates' column slices may sum in another order), and within 1e-4 of
the reference (float ops in another order, as the port's other model
tests hold it); a traced decode step's collectives by kind and op as
reckoned from its records.
"""
import dataclasses
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
from repro.distributed import autoshard as jauto
from repro.models import decode_step as jdecode
from repro.models import prefill as jprefill
from repro_torch.accel.program import partition_for
from repro_torch.configs import ALL_ARCHS, get_config as tget
from repro_torch.distributed.autoshard import (global_batch, manual,
                                               use_mesh)
from repro_torch.distributed.sharding import ShardPolicy
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models import init_cache, init_params
from repro_torch.models.mixer_split import (LRU_TILES, MLA_TILES, SSD_TILES,
                                            lru_split, mla_split, ssd_split)
from repro_torch.models.rglru import init_lru_state, init_rglru, rglru_forward
from repro_torch.models.ssm import init_ssm, init_ssm_state, ssm_forward
from repro_torch.serve import ServeConfig
from repro_torch.tree import tree_map

TILES = {**MLA_TILES, **SSD_TILES, **LRU_TILES}
# arch -> (mixer, split at m = 2, 4, 8, 16)
TABLE = {
    "mamba2-130m": ("ssd", ("heads", "heads", "heads", "p")),
    "recurrentgemma-9b": ("lru", ("width",) * 4),
    "deepseek-v2-lite-16b": ("mla", ("heads",) * 4),
}
MODELS = (2, 4, 8, 16)

SPEC = dict(ba=4, bx=4, bank_n=8)
SERVE = dict(max_seq=32, max_new_tokens=6)
# name -> (arch, config changes on both packages)
CASES = {"deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", dict(n_layers=2)),
         "mamba2-130m": ("mamba2-130m", {}),
         "mamba2-130m-p": ("mamba2-130m", dict(d_model=48)),
         "recurrentgemma-9b": ("recurrentgemma-9b", {})}
SPLITS = {"deepseek-v2-lite-16b": ("mla", ("heads", 2)),
          "mamba2-130m": ("ssd", ("heads", 4)),
          "mamba2-130m-p": ("ssd", ("p", 16)),
          "recurrentgemma-9b": ("lru", ("width", 64))}
BITWISE = ("deepseek-v2-lite-16b", "mamba2-130m", "mamba2-130m-p")
TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(get, name: str):
    arch, changes = CASES[name]
    return dataclasses.replace(get(arch).reduced(), **changes)


# ----------------------------------------------------------- the rule

def _reference_spec(shape, cands, model: int) -> tuple:
    """The spec the reference's ``cs`` gives a tensor of ``shape`` with
    candidates ``cands`` on a ``16/model x model`` mesh (its sharding
    call captured, so no device is asked)."""
    seen = []
    amesh = jax.sharding.AbstractMesh((max(16 // model, 1), model),
                                      ("data", "model"))
    with pytest.MonkeyPatch.context() as mp, jauto.use_mesh(amesh):
        mp.setattr(jauto, "NamedSharding", lambda mesh, spec: spec)
        mp.setattr(jax.lax, "with_sharding_constraint",
                   lambda x, spec: seen.append(tuple(spec)) or x)
        jauto.cs(np.empty(shape, np.float32), cands)
    return seen[0] + (None,) * (len(shape) - len(seen[0]))


def _reference_modes(cfg, model: int) -> dict:
    """Each mixer's split by the reference's constraint on it: MLA's q
    ``("dp", None, ["tp"], None)``, SSD's ``xs`` ``("dp", None, ["tp"],
    ["tp"])``, the RG-LRU's ``xr`` ``("dp", None, "tp")``."""
    out = {}
    if cfg.mla:
        spec = _reference_spec(
            (1, 1, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
            ("dp", None, ["tp"], None), model)
        out["mla"] = "heads" if spec[2] == "model" else "whole"
    if "ssm" in cfg.pattern():
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        spec = _reference_spec((1, 1, heads, cfg.ssm_head_dim),
                               ("dp", None, ["tp"], ["tp"]), model)
        out["ssd"] = ("heads" if spec[2] == "model" else
                      "p" if spec[3] == "model" else "whole")
    if "rec" in cfg.pattern():
        spec = _reference_spec((1, 1, cfg.lru_width), ("dp", None, "tp"),
                               model)
        out["lru"] = "width" if spec[2] == "model" else "whole"
    return out


def _port_modes(cfg, model: int, rank: int = 0) -> dict:
    with use_mesh(ServeMesh(data=max(16 // model, 1), model=model,
                            rank=rank), tiles=TILES):
        return {k: v if v == "whole" else v[0]
                for k, v in tm.mixer_modes(cfg).items()}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_split_modes_match_the_reference(arch, model):
    """Every config's mixers split as the reference's ``cs`` splits
    them; the three families as the table above."""
    cfg = tget(arch).with_accel("bpbs")
    got = _port_modes(cfg, model)
    assert got == _reference_modes(jget(arch), model)
    if arch in TABLE:
        kind, modes = TABLE[arch]
        assert got == {kind: modes[MODELS.index(model)]}
    else:
        assert got == {}


@pytest.mark.parametrize("arch", list(TABLE))
def test_each_rank_takes_its_own_share(arch):
    """Rank k of the model axis takes ``[k n/m, (k+1) n/m)`` of the
    split dim, the ranks together all of it."""
    cfg = tget(arch).with_accel("bpbs")
    kind = TABLE[arch][0]
    fn = {"mla": mla_split, "ssd": ssd_split, "lru": lru_split}[kind]
    for model in MODELS:
        shares = []
        for rank in range(model):
            with use_mesh(ServeMesh(data=1, model=model, rank=rank),
                          tiles=TILES):
                split = fn(cfg)
            shares.append((split.lo, split.hi))
        size = shares[0][1]
        assert shares == [(k * size, (k + 1) * size) for k in range(model)]


def test_split_needs_a_serving_mesh_and_mla_its_tiles():
    """No split off a mesh, under an fsdp policy, on a model axis of 1,
    in a training step's scope or with the model axis manual.  MLA needs
    the program's q and ukv column tiles and wo's row tile on a sharded
    backend and no XNOR 1-bit wo input, and heads the axis divides; the
    SSD mixer and the RG-LRU split their scan and state without tiles,
    their projections then not local."""
    mla = tget("deepseek-v2-lite-16b").reduced().with_accel("bpbs")
    ssd = tget("mamba2-130m").reduced().with_accel("bpbs")
    lru = tget("recurrentgemma-9b").reduced().with_accel("bpbs")
    mesh = ServeMesh(data=1, model=2)
    fns = ((mla_split, mla), (ssd_split, ssd), (lru_split, lru))
    assert all(fn(cfg) is None for fn, cfg in fns)
    for scope_mesh, policy in ((mesh, ShardPolicy("fsdp")),
                               (ServeMesh(data=2, model=1), None)):
        with use_mesh(scope_mesh, policy, tiles=TILES):
            assert all(fn(cfg) is None for fn, cfg in fns)
    with use_mesh(mesh, tiles=TILES):
        assert all(fn(cfg).local for fn, cfg in fns)
        with manual("model"):
            assert all(fn(cfg) is None for fn, cfg in fns)
        with global_batch(mesh):
            assert all(fn(cfg) is None for fn, cfg in fns)
        xnor = dict(ba=1, bx=1, coding="xnor")
        assert mla_split(mla.with_accel("bpbs", **xnor)) is None
        assert not ssd_split(ssd.with_accel("bpbs", **xnor)).local
        assert not lru_split(lru.with_accel("bpbs", **xnor)).local
        assert mla_split(dataclasses.replace(mla, n_heads=3)) is None
        assert lru_split(dataclasses.replace(lru, lru_width=127)) is None
    with use_mesh(mesh, tiles={**TILES, "attn.ukv": "row"}):
        assert mla_split(mla) is None
    with use_mesh(mesh):
        assert mla_split(mla) is None
        assert (ssd_split(ssd).mode, ssd_split(ssd).local) == ("heads",
                                                               False)
        assert not lru_split(lru).local


def test_ukv_is_a_column_tile():
    """A serving program cuts ``w_ukv`` into column tiles (its heads'
    keys and values on each rank, no collective); ``wo`` and the other
    second GEMMs stay row tiles."""
    assert partition_for("blocks.attn.ukv", 512, 4096, 16) == "col"
    assert partition_for("blocks.attn.ukv", 32, 256, 2) == "col"
    for tag in ("attn.o", "mlp.down", "rec.out", "ssm.out_proj"):
        assert partition_for(tag, 256, 128, 2) == "row"


@pytest.mark.parametrize("name", list(CASES))
def test_states_hold_the_ranks_share(name):
    """A cache made on a 1 x 2 serving mesh holds the rank's share of
    the SSM state ([B, H/2, P, N] in "heads", [B, H, P/2, N] in "p"; the
    conv state its x channels and B, C) and of the LRU state ([B, K-1,
    w/2], [B, w/2]); MLA's latent cache stays whole.  A mixer handed a
    state of another split refuses it."""
    cfg = _cfg(tget, name).with_accel("bpbs")
    whole = tm.state_shapes(init_cache(cfg, 3, 16, device="meta").layers)
    with use_mesh(ServeMesh(data=1, model=2, rank=1), tiles=TILES):
        got = tm.state_shapes(init_cache(cfg, 3, 16, device="meta").layers)
    k = cfg.conv1d_size - 1
    if cfg.mla:
        assert got == whole
        return
    if "ssm" in cfg.pattern():
        d_inner = cfg.ssm_expand * cfg.d_model
        h, p, n = d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
        ssm = (h // 2, p, n) if h % 2 == 0 else (h, p // 2, n)
        assert got == {"ssm.conv": {(cfg.n_layers, 3, k, d_inner // 2 + 2 * n)},
                       "ssm.ssm": {(cfg.n_layers, 3) + ssm}}
        assert whole["ssm.ssm"] == {(cfg.n_layers, 3, h, p, n)}
        state = init_ssm_state(cfg, 3, torch.float32, "cpu")
        x = torch.zeros(3, 1, cfg.d_model)
        with use_mesh(ServeMesh(data=1, model=2), tiles=TILES), \
                pytest.raises(ValueError, match="scope that serves it"):
            ssm_forward(init_ssm(torch.Generator(), cfg, "cpu"), x, cfg,
                        state, True)
        return
    w = cfg.lru_width
    assert {key: got[key] for key in ("lru.conv", "lru.h")} == {
        "lru.conv": {(1, 3, k, w // 2)}, "lru.h": {(1, 3, w // 2)}}
    state = init_lru_state(cfg, 3, torch.float32, "cpu")
    with use_mesh(ServeMesh(data=1, model=2), tiles=TILES), \
            pytest.raises(ValueError, match="scope that serves it"):
        rglru_forward(init_rglru(torch.Generator(), cfg, "cpu"),
                      torch.zeros(3, 1, cfg.d_model), cfg, state, True)


# ------------------------------------------------ parity on a 1 x 2 mesh

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 1 x 2 ranks' results, the port unsharded and the reference
    unsharded, on the same seeded weights (the port's ``init_params``,
    handed to the reference as numpy)."""
    cases, jax_cases = {}, {}
    for name in CASES:
        cfg = _cfg(tget, name).with_accel("digital_int", **SPEC)
        params = init_params(cfg, 0, device="cpu", max_seq=64)
        cases[name] = (cfg, params)
        jax_cases[name] = (_cfg(jget, name).with_accel("digital_int", **SPEC),
                           tree_map(lambda t: t.numpy(), params))
    prompts = np.random.default_rng(0).integers(0, 256, (4, 8))
    wait = tm.start("mixers", 2, tmp_path_factory.mktemp("mixers"),
                    dict(cases=cases, serve=SERVE, prompts=prompts))
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        reference = pool.submit(_reference, jax_cases, prompts)
        flat = {name: tm.serve_mixer(params, cfg, ServeConfig(**SERVE),
                                     prompts)
                for name, (cfg, params) in cases.items()}
        return wait(), flat, reference.result(), cases


def _reference(cases: dict, prompts) -> dict:
    """The reference unsharded on each case, under the serving
    quantization scope: the ``digital_int`` logits of the prefill and of
    one decode step after it (on the prefill's greedy token)."""
    toks = jax.numpy.asarray(prompts, jax.numpy.int32)
    out = {}
    for name, (jc, pj) in cases.items():
        with jaccel.override(x_per_row=True):
            logits, cache = jprefill(pj, toks, jc, SERVE["max_seq"])
            step = jdecode(pj, jax.numpy.argmax(logits, -1), cache, jc)[0]
        out[name] = dict(prefill=np.asarray(logits), decode=np.asarray(step))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_run_their_share(runs, name):
    ranks, flat, _, cases = runs
    kind, (mode, size) = SPLITS[name]
    for k, r in enumerate(ranks):
        got = r[name]["modes"][kind]
        assert got[:3] == (mode, k * size, (k + 1) * size)
        assert got[3] is True or mode == "p"
    assert flat[name]["modes"] == {kind: "whole"}
    # every rank's states and caches as the meta probe predicts
    cfg = cases[name][0]
    with use_mesh(ServeMesh(data=1, model=2), tiles=TILES):
        want = tm.state_shapes(init_cache(cfg, 4, SERVE["max_seq"],
                                          device="meta").layers)
    assert all(r[name]["shapes"] == want for r in ranks)


@pytest.mark.parametrize("backend", ["digital_int", "digital"])
@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_unsharded(runs, name, backend):
    """Logits of the prefill and of a decode step, on ``digital_int``
    (the projections around the mixers local where the tiles allow) and
    on ``digital`` (no program, so no tile: MLA whole, the SSD and LRU
    activations gathered around their projections): bitwise unsharded
    for MLA and both SSD modes, within 1e-5 for the RG-LRU."""
    ranks, flat, _, _ = runs
    want = flat[name][backend]
    for r in ranks:
        for key, got in r[name][backend].items():
            if name in BITWISE:
                assert torch.equal(got, want[key]), key
            else:
                np.testing.assert_allclose(got.numpy(), want[key].numpy(),
                                           **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_tokens_equal_unsharded_and_the_reference(runs, name):
    """Greedy tokens on every rank equal the port's unsharded ones; the
    first two (the prefill's and a decode step's) equal the reference's
    greedy picks, whose logits the ranks' are held to within 1e-4."""
    ranks, flat, ref, _ = runs
    picks = np.stack([ref[name][k].argmax(-1) for k in ("prefill",
                                                         "decode")], 1)
    for r in ranks:
        np.testing.assert_array_equal(r[name]["tokens"], flat[name]["tokens"])
        np.testing.assert_array_equal(r[name]["tokens"][:, :2], picks)
        for key in ("prefill", "decode"):
            np.testing.assert_allclose(r[name]["digital_int"][key].numpy(),
                                       ref[name][key], **REF_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_collectives_are_reckoned(runs, name):
    """A traced decode step's collectives by kind and op: a column
    tile's gather but for the local ones (MLA's q and ``w_ukv``: no
    collective for the expansion; the RG-LRU's ``in_x`` and ``in_gate``;
    recurrentgemma's attention q in mode "g"), a row tile's sum and, for
    a local one, the ``max`` of its input scale; and per mixer layer
    one gather of its own: the SSD heads' sums of squares ("heads") or
    its output ("p"), the RG-LRU conv's output."""
    ranks, _, _, cases = runs
    cfg = cases[name][0]
    local = {"deepseek-v2-lite-16b": set(MLA_TILES),
             "mamba2-130m": set(SSD_TILES),
             "mamba2-130m-p": set(),
             "recurrentgemma-9b": set(LRU_TILES) | {"attn.q", "attn.o"}}
    layers = Counter(cfg.pattern())
    for r in ranks:
        got = r[name]["decode"]
        gathers = layers["ssm"] + layers["rec"]
        want = tm.reckoned_collectives(got["records"], local[name],
                                       gathers=gathers)
        assert Counter(got["collectives"]) == want
        if cfg.mla:
            assert ("attn.ukv", "col") in got["records"]
