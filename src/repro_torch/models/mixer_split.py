"""Where MLA, the SSD mixer and the RG-LRU run on a serving mesh: each
rank's share of the dim the reference's ``cs`` constraints put on
``"tp"``, taken by its rule (``repro.distributed.autoshard.cs``: the
first candidate that the model axis divides, else replicated).

* MLA (``repro/models/attention.py:394-396, 440-441``): q and the
  expanded keys and values ``kvu`` on their heads.  The rank runs its q
  heads ``[k h/m, (k+1) h/m)``: ``wq`` and ``w_ukv`` as local column
  tiles, ``wo`` as a local row tile (the latent cache and the shared
  rope key stay whole).  Only where the program's tiles allow it
  (:func:`tiles_allow`); else MLA runs whole.
* SSD (``repro/models/ssm.py:167-168``): ``xs`` on its heads
  (``"heads"``), else on its head dim (``"p"``).  The rank runs the
  conv, the scan and the state of its heads or of its slice of every
  head's dims; ``out_proj`` takes its channels as a local row tile in
  ``"heads"`` where the tiles allow it.
* RG-LRU (``repro/models/rglru.py:81-95``): ``xr``, ``a`` and
  ``gated`` on the LRU width (``"width"``).  The rank runs the conv, the
  gates' columns, the scan and the state of its width slice; ``in_x``
  and ``in_gate`` as local column tiles and ``out`` as a local row tile
  where the tiles allow it.

A serving mesh is an ambient mesh (:func:`~repro_torch.distributed.
autoshard.use_mesh`) outside a training step's scope, with the model
axis not manual, a model axis wider than 1 and no fsdp policy (whose
``"tp"`` resolves to no axis): the conditions of
``models.attention.head_split``.  In a tensor-parallel training step
(:func:`~repro_torch.distributed.autoshard.tp_mesh`) the same rule
splits SSD and the RG-LRU on the step's mesh, their projections always
the rank's tiles (its weight slices are the tiles); MLA trains whole.
Off both every function here returns None and the mixers run whole.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

from repro_torch.accel.context import current_override
from repro_torch.accel.shard import SHARD_BACKENDS
from repro_torch.core.quant import Coding
from repro_torch.distributed.autoshard import (get_mesh, get_shard_policy,
                                               in_manual, mesh_tiles,
                                               tp_mesh, train_mesh)


class MixerSplit(NamedTuple):
    """One rank's share of a mixer: ``[lo, hi)`` of the split dim (MLA's
    and SSD's heads in ``"heads"``, SSD's head dim in ``"p"``, the LRU
    width in ``"width"``), and whether the mixer's projections run as
    the rank's local tiles (``local``)."""

    mode: str
    lo: int
    hi: int
    local: bool

    @property
    def size(self) -> int:
        return self.hi - self.lo


def serving_mesh():
    """The ambient mesh where it is a serving mesh with a model axis
    wider than 1 (see the module docstring), else None."""
    mesh = get_mesh()
    if mesh is None or train_mesh() is not None or in_manual("model") \
            or "model" not in mesh.axis_names \
            or get_shard_policy().is_fsdp or mesh.size("model") <= 1:
        return None
    return mesh


def tiles_allow(cfg, kind: str, need: dict, row: str) -> bool:
    """Do the program's tiles on this mesh let a layer's projections run
    as local tiles: each tag of ``need`` partitioned as it names
    (:func:`~repro_torch.distributed.autoshard.mesh_tiles`), its spec
    (policy kind ``kind``) on a backend with a sharded path, and the
    local row input ``row`` not an XNOR 1-bit one, whose scale is a
    mean that a split input would sum in another order."""
    tiles = mesh_tiles()
    if any(tiles.get(tag) != part for tag, part in need.items()):
        return False
    sp, ov = cfg.policy.resolver(kind), current_override()
    specs = {tag: dataclasses.replace(sp(tag), **ov) for tag in need}
    if any(s.backend not in SHARD_BACKENDS for s in specs.values()):
        return False
    o = specs[row]
    return not (Coding(o.coding) == Coding.XNOR and o.bx == 1)


def _share(mesh, size: int) -> tuple:
    m, k = mesh.size("model"), mesh.index("model")
    return k * (size // m), (k + 1) * (size // m)


MLA_TILES = {"attn.q": "col", "attn.ukv": "col", "attn.o": "row"}
SSD_TILES = {"ssm.out_proj": "row"}
LRU_TILES = {"rec.in_x": "col", "rec.in_gate": "col", "rec.out": "row"}


def mla_split(cfg) -> Optional[MixerSplit]:
    """This rank's q heads of an MLA layer on a serving mesh whose model
    axis divides them and whose tiles allow it, else None (whole)."""
    mesh = serving_mesh()
    if mesh is None or not cfg.mla or cfg.n_heads % mesh.size("model") \
            or not tiles_allow(cfg, "attn", MLA_TILES, "attn.o"):
        return None
    return MixerSplit("heads", *_share(mesh, cfg.n_heads), True)


def ssd_mode(cfg, m: int) -> Optional[str]:
    """The SSD split on a model axis of ``m`` ranks, by the reference's
    candidates for ``xs``: ``"heads"`` where ``m`` divides the heads,
    else ``"p"`` where it divides the head dim, else None."""
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    if heads % m == 0:
        return "heads"
    return "p" if cfg.ssm_head_dim % m == 0 else None


def ssd_split(cfg) -> Optional[MixerSplit]:
    """This rank's SSD heads (``"heads"``) or head dims (``"p"``) on a
    serving mesh or in a tensor-parallel training step, by
    :func:`ssd_mode`; None where the model axis divides neither."""
    train = tp_mesh()
    mesh = train if train is not None else serving_mesh()
    if mesh is None or not cfg.ssm_state:
        return None
    mode = ssd_mode(cfg, mesh.size("model"))
    if mode == "heads":
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        return MixerSplit("heads", *_share(mesh, heads), train is not None
                          or tiles_allow(cfg, "ssm", SSD_TILES,
                                         "ssm.out_proj"))
    if mode == "p":
        return MixerSplit("p", *_share(mesh, cfg.ssm_head_dim), False)
    return None


def lru_split(cfg) -> Optional[MixerSplit]:
    """This rank's slice of the RG-LRU width on a serving mesh or in a
    tensor-parallel training step whose model axis divides it, else
    None."""
    train = tp_mesh()
    mesh = train if train is not None else serving_mesh()
    if mesh is None or not cfg.lru_width \
            or cfg.lru_width % mesh.size("model"):
        return None
    return MixerSplit("width", *_share(mesh, cfg.lru_width),
                      train is not None
                      or tiles_allow(cfg, "rec", LRU_TILES, "rec.out"))
