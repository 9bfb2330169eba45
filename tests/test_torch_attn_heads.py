"""Attention on each rank's share (``repro_torch.models.attention``):
the mode rule against the reference's ``_attn_tp_mode``,
:func:`head_split`'s conditions, the rows or head dims a rank takes in
modes ``"sq"`` and ``"d"`` and the (kv heads, head dim) its caches hold,
without a spawned group (a shape-only ``ServeMesh`` of the rank given).

The table below is transcribed from the reference's rule
(``repro/models/attention.py:31-56``): kv heads, then the GQA group,
then the query sequence, then the head dim, each taken where the model
axis divides it; ``"none"`` under an fsdp policy or a model axis of 1.
Decode queries one position, prefill the prefill_32k cell's 32,768.
mamba2-130m has no attention (0 kv heads, which every axis divides).
"""
import dataclasses

import jax
import pytest
import torch

from repro.distributed import autoshard as jauto
from repro.distributed.sharding import ShardPolicy as JPolicy
from repro.models.attention import _attn_tp_mode as ref_mode
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed.autoshard import (global_batch, manual,
                                               use_mesh)
from repro_torch.distributed.sharding import ShardPolicy
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models import init_params
from repro_torch.models.attention import (attn_tp_mode, cross_kv_dims,
                                          cross_split, encode_cross_kv,
                                          head_split, kv_cache_dims)
from repro_torch.models.transformer import layer_slice

SQ = {"decode": 1, "prefill": 32768}
# arch -> (m=2, m=4, m=16 at decode, m=16 at prefill)
TABLE = {
    "olmo-1b": ("kv", "kv", "kv", "kv"),
    "phi-3-vision-4.2b": ("kv", "kv", "kv", "kv"),
    "deepseek-v2-lite-16b": ("kv", "kv", "kv", "kv"),
    "llama3.2-1b": ("kv", "kv", "d", "sq"),
    "granite-8b": ("kv", "kv", "d", "sq"),
    "llama4-scout-17b-a16e": ("kv", "kv", "d", "sq"),
    "recurrentgemma-9b": ("g", "g", "g", "g"),
    "starcoder2-3b": ("kv", "g", "d", "sq"),
    "whisper-tiny": ("kv", "d", "d", "sq"),
    "mamba2-130m": ("kv", "kv", "kv", "kv"),
}
TABLE_PREFILL = {"whisper-tiny": ("kv", "sq", "d", "sq")}
TILES = {"attn.q": "col", "attn.k": "col", "attn.v": "col", "attn.o": "row"}


def _dims(cfg, kind: str) -> tuple:
    kv = cfg.n_kv_heads
    return kv, (cfg.n_heads // kv if kv else 0), SQ[kind], cfg.hd


@pytest.mark.parametrize("kind", list(SQ))
@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_attn_tp_mode_matches_the_reference(arch, model, kind):
    cfg = get_config(arch)
    row = TABLE_PREFILL.get(arch, TABLE[arch]) if kind == "prefill" \
        else TABLE[arch]
    want = row[[2, 4].index(model)] if model < 16 else \
        row[2 if kind == "decode" else 3]
    dims = _dims(cfg, kind)
    with use_mesh(ServeMesh(data=16 // min(model, 16), model=model)):
        got = attn_tp_mode(*dims)
    amesh = jax.sharding.AbstractMesh((16 // model, model),
                                      ("data", "model"))
    with jauto.use_mesh(amesh):
        ref = ref_mode(*dims)
    assert got == ref == want
    # fsdp and a model axis of 1: "none", in both
    with use_mesh(ServeMesh(data=2, model=model), ShardPolicy("fsdp")):
        assert attn_tp_mode(*dims) == "none"
    with jauto.use_mesh(amesh, JPolicy("fsdp")):
        assert ref_mode(*dims) == "none"
    with use_mesh(ServeMesh(data=model, model=1)):
        assert attn_tp_mode(*dims) == "none"


def _cfg(arch="olmo-1b", **spec):
    return get_config(arch).reduced().with_accel(
        "bpbs", **dict(dict(ba=4, bx=4), **spec))


@pytest.mark.parametrize("arch,model,mode,heads,kv",
                         [("olmo-1b", 2, "kv", 2, 2),
                          ("olmo-1b", 4, "kv", 1, 1),
                          ("starcoder2-3b", 2, "g", 2, 1),
                          ("starcoder2-3b", 4, "g", 1, 1)])
def test_head_split_takes_the_ranks_heads(arch, model, mode, heads, kv):
    cfg = _cfg(arch)
    with use_mesh(ServeMesh(data=1, model=model), tiles=TILES):
        split = head_split(cfg)
        assert kv_cache_dims(cfg) == (kv, cfg.hd)
    assert (split.mode, split.h, split.kv, split.q0) == (mode, heads, kv, 0)


def test_head_split_needs_the_programs_tiles_and_an_amax_statistic():
    """Head-local needs the mesh's tiles (no program: the layer runs
    whole), no training step's scope, a model axis that is not manual,
    and an amax input statistic for wo: an XNOR 1-bit layer stays
    replicated."""
    cfg, mesh = _cfg(), ServeMesh(data=1, model=2)
    assert head_split(cfg) is None
    with use_mesh(mesh):
        assert head_split(cfg) is None
    with use_mesh(mesh, tiles=dict(TILES, **{"attn.o": "col"})):
        assert head_split(cfg) is None
    with use_mesh(mesh, tiles=TILES):
        assert head_split(cfg) is not None
        with manual("model"):
            assert head_split(cfg) is None
        with global_batch(mesh):
            assert head_split(cfg) is None
        xnor = _cfg(ba=1, bx=1, coding="xnor")
        assert head_split(xnor) is None
        assert kv_cache_dims(xnor) == (xnor.n_kv_heads, xnor.hd)
        digital = get_config("olmo-1b").reduced()
        assert head_split(digital) is None


# the configs with MHA/GQA attention (deepseek's is MLA, mamba2 has none)
GQA_ARCHS = [a for a in ALL_ARCHS
             if a not in ("deepseek-v2-lite-16b", "mamba2-130m")]


def _want_mode(arch, model, kind) -> str:
    row = TABLE_PREFILL.get(arch, TABLE[arch]) if kind == "prefill" \
        else TABLE[arch]
    return row[[2, 4].index(model)] if model < 16 else \
        row[2 if kind == "decode" else 3]


@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_head_split_mode_and_cache_dims_follow_the_reference(arch, model):
    """At published widths, on ``bpbs`` with the program's tiles:
    :func:`head_split` of a decode step and of a 32,768-row prefill takes
    the reference's mode, and the KV cache holds the decode mode's
    layout: kv / model heads in "kv", every kv head in "g", hd / model
    dims in "d" (whisper's cross keys and values too, whole in "kv")."""
    cfg = get_config(arch).with_accel("bpbs", ba=4, bx=4)
    kv, hd = cfg.n_kv_heads, cfg.hd
    with use_mesh(ServeMesh(data=16 // model, model=model), tiles=TILES):
        for kind, sq in SQ.items():
            assert head_split(cfg, sq).mode == _want_mode(arch, model, kind)
        mode = _want_mode(arch, model, "decode")
        want = {"kv": (kv // model, hd), "g": (kv, hd),
                "d": (kv, hd // model)}[mode]
        assert kv_cache_dims(cfg) == want
        if cfg.is_encdec:
            assert cross_kv_dims(cfg) == (want if mode == "d" else (kv, hd))


def _odd_gqa(arch="llama3.2-1b", **spec):
    """Reduced, with kv heads and GQA group odd (9 q / 3 kv heads): a
    1 x 2 or 1 x 4 mesh splits the rows or the head dims."""
    return dataclasses.replace(_cfg(arch, **spec), n_heads=9, n_kv_heads=3)


@pytest.mark.parametrize("model,rank", [(2, 0), (2, 1), (4, 3)])
def test_head_split_takes_the_ranks_rows_or_head_dims(model, rank):
    """"sq" gives the rank's query rows of an 8-row call, "d" its head
    dims of a 7-row call and of a decode step; every q and kv head stays
    on every rank, and the caches hold the rank's head dims."""
    cfg = _odd_gqa()
    with use_mesh(ServeMesh(data=1, model=model, rank=rank), tiles=TILES):
        rows = head_split(cfg, 8)
        dims = head_split(cfg, 7)
        assert head_split(cfg) == dims
        assert kv_cache_dims(cfg) == (3, 32 // model)
    assert (rows.mode, rows.h, rows.kv, rows.lo, rows.hi) == \
        ("sq", 9, 3, rank * 8 // model, (rank + 1) * 8 // model)
    assert (dims.mode, dims.h, dims.kv, dims.lo, dims.hi) == \
        ("d", 9, 3, rank * 32 // model, (rank + 1) * 32 // model)


def test_sq_and_d_hold_on_any_backend_outside_training():
    """"sq" and "d" change no tile: they need no program tiles and hold on
    ``digital`` and for an XNOR 1-bit ``wo``; none off a mesh, in a
    training step's scope, with the model axis manual or under fsdp."""
    mesh = ServeMesh(data=1, model=2)
    digital = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                  n_heads=9, n_kv_heads=3)
    for cfg in (_odd_gqa(), _odd_gqa(ba=1, bx=1, coding="xnor"), digital):
        assert head_split(cfg, 7) is None
        assert kv_cache_dims(cfg) == (3, 32)
        with use_mesh(mesh):
            assert head_split(cfg, 8).mode == "sq"
            assert head_split(cfg, 7).mode == "d"
            assert kv_cache_dims(cfg) == (3, 16)
            with manual("model"):
                assert head_split(cfg, 7) is None
            with global_batch(mesh):
                assert head_split(cfg, 7) is None
        with use_mesh(mesh, ShardPolicy("fsdp")):
            assert head_split(cfg, 7) is None


def test_cross_attention_takes_only_sq_and_d():
    """Whisper's cross-attention follows the call's "sq" / "d" split
    (3 heads on 1 x 2) and runs whole where self-attention is head-local
    ("kv", 6 heads on 1 x 2), its cross keys and values then whole."""
    small = dataclasses.replace(_cfg("whisper-tiny"), n_heads=3,
                                n_kv_heads=3)
    full = get_config("whisper-tiny").with_accel("bpbs", ba=4, bx=4)
    with use_mesh(ServeMesh(data=1, model=2, rank=1), tiles=TILES):
        assert cross_split(small, 8).mode == "sq"
        assert (cross_split(small).mode, cross_split(small).lo) == ("d", 16)
        assert cross_kv_dims(small) == (3, 16)
        assert head_split(full).mode == "kv"
        assert cross_split(full) is None
        assert cross_kv_dims(full) == (6, 64)
        assert kv_cache_dims(full) == (3, 64)


def test_encode_cross_kv_gives_the_ranks_head_dims():
    """``encode_cross_kv`` on a "d" rank: its head-dim slice of the
    whole keys and values (``digital``: the projections run whole)."""
    cfg = dataclasses.replace(get_config("whisper-tiny").reduced(),
                              n_heads=3, n_kv_heads=3)
    p = layer_slice(init_params(cfg, 0, device="cpu")["cross"]["attn"], 0)
    enc = torch.randn(2, 8, cfg.d_model,
                      generator=torch.Generator().manual_seed(0))
    whole = encode_cross_kv(p, enc, cfg, torch.float32)
    with use_mesh(ServeMesh(data=1, model=2, rank=1)):
        mine = encode_cross_kv(p, enc, cfg, torch.float32)
    for got, want in zip(mine, whole):
        assert torch.equal(got, want[..., 16:])
