"""Attention on each rank's own heads (``repro_torch.models.attention``):
the mode rule against the reference's ``_attn_tp_mode`` and
:func:`head_split`'s conditions, without a spawned group (a shape-only
``ServeMesh`` is rank 0 of its mesh).

The table below is transcribed from the reference's rule
(``repro/models/attention.py:31-56``): kv heads, then the GQA group,
then the query sequence, then the head dim, each taken where the model
axis divides it; ``"none"`` under an fsdp policy or a model axis of 1.
Decode queries one position, prefill the prefill_32k cell's 32,768.
mamba2-130m has no attention (0 kv heads, which every axis divides).
"""
import jax
import pytest

from repro.distributed import autoshard as jauto
from repro.distributed.sharding import ShardPolicy as JPolicy
from repro.models.attention import _attn_tp_mode as ref_mode
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed.autoshard import (global_batch, manual,
                                               use_mesh)
from repro_torch.distributed.sharding import ShardPolicy
from repro_torch.launch.mesh import ServeMesh
from repro_torch.models.attention import (attn_tp_mode, head_split,
                                          kv_cache_heads)

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
        assert kv_cache_heads(cfg) == kv
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
        assert kv_cache_heads(xnor) == xnor.n_kv_heads
        digital = get_config("olmo-1b").reduced()
        assert head_split(digital) is None
