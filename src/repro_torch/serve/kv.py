"""Block-table paged KV cache.  Port of ``repro.serve.kv``.

The slot batcher pads every slot's cache to ``max_seq``.  This module
pools the sequence-indexed cache leaves into shared physical *blocks* of
``block_size`` positions each, addressed through a per-request block
table, generically over the cache tree:

* :func:`build_layout` classifies every leaf of ``DecodeCache.layers``
  by probing ``init_cache`` on the ``meta`` device (no memory) at two
  batch sizes and two capacities: the dim that tracks the batch size is
  the batch axis; a dim that tracks ``s_max`` is the sequence axis and
  the leaf is *paged* (KV caches, MLA latents).  Leaves without one (SSM
  and LRU states, ring caches capped by a window below ``s_max``) stay
  per-slot state.
* a paged leaf ``[.., B, L, ..]`` becomes a pool ``[.., NB + 2, bs, ..]``
  over one shared block-id space: logical block ``j`` of slot ``b``
  lives at physical block ``tables[b, j]``.  Table value ``NB`` is the
  sentinel of an unallocated entry.  The reference reads it as zeros
  (``take(mode="fill")``) and drops writes to it (``.at[].set(mode=
  "drop")``); torch has neither mode, so every pool holds two blocks
  more: block ``NB`` is all zeros and never written (a gather reads the
  sentinel from it as it stands), and block ``NB + 1`` takes every write
  aimed at the sentinel (scatters map ``NB`` to it with ``torch.where``,
  no host sync).  Duplicate writes land only on that discard block, so
  the unordered ``index_copy_`` of duplicates changes no bit ever read.
* :func:`gather_cache` materialises the dense ``DecodeCache`` a decode
  step consumes (fresh tensors for paged leaves, the pool's own state
  leaves, which the decode steps write in place);
  :func:`scatter_decode` writes back only the blocks a K-step decode
  touched, in place; :func:`splice_request` is the paged ``splice_slot``
  for admission.

Unwritten pool positions read as exact zeros, so the gathered view is
bit for bit the contiguous cache, and paged serving is token-identical
to the slot batcher (tests/test_torch_paged.py).  Every function here
is generic over the leaves' shapes: on a mesh where attention runs on
the rank's heads or head dims the probed layout, and so the pools, the
gather, the scatter and the splice, hold the rank's kv heads (mode
``"kv"``) or its head-dim slice (``"d"``), and where the SSD mixer and
the RG-LRU run on the rank's share (``models.mixer_split``) the slot
states hold the rank's SSM heads or head dims and LRU width.

Tables and positions are ``int64`` on the device; the host mirrors the
scheduler keeps are ``int32``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import DecodeCache, init_cache


# ------------------------------------------------------------- allocator

class BlockAllocator:
    """Free-list allocator over ``num_blocks`` interchangeable block ids.

    ``alloc(n)`` returns ``n`` ids or ``None`` (never partial: the caller
    defers admission or preempts instead); ``free(ids)`` returns them.
    Double frees and foreign ids raise."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))   # pop() ascending
        self._held: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._held.update(ids)
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._held:
                raise ValueError(f"free of unallocated block {i}")
            self._held.discard(i)
            self._free.append(i)


# ---------------------------------------------------------------- layout

@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """How ``DecodeCache.layers`` pages.

    ``treedef`` is the probed cache's layers tree (``meta`` tensors), the
    template :func:`repro_torch.tree.unflatten` rebuilds trees from.  Per
    leaf, in :func:`repro_torch.tree.leaves` order: the batch axis, the
    sequence axis (``None`` for per-slot state leaves) and the leaf's own
    cache length ``L``.  ``table_width`` is ``max(L) // block_size``; a
    leaf shorter than that indexes the table modulo its own
    ``L // block_size``."""

    treedef: Any
    batch_axes: tuple
    seq_axes: tuple
    lengths: tuple
    leaf_shapes: tuple
    leaf_dtypes: tuple
    block_size: int
    num_blocks: int
    table_width: int
    n_slots: int
    s_max: int

    @property
    def sentinel(self) -> int:
        return self.num_blocks


def build_layout(cfg, n_slots: int, s_max: int, block_size: int,
                 num_blocks: Optional[int] = None) -> PagedLayout:
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    t0 = init_cache(cfg, n_slots, s_max, device="meta")
    tb = init_cache(cfg, n_slots + 1, s_max, device="meta")
    ts = init_cache(cfg, n_slots, s_max + block_size, device="meta")
    if t0.cross_kv is not None:
        raise NotImplementedError("paged caches do not cover encoder-decoder "
                                  "cross_kv")
    l0 = tree.leaves(t0.layers)

    def _changed(a, b):
        d = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(d) > 1:
            raise ValueError(f"ambiguous cache leaf {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        return d[0] if d else None

    b_axes, q_axes, lengths = [], [], []
    for a, b, c in zip(l0, tree.leaves(tb.layers), tree.leaves(ts.layers)):
        b_ax = _changed(a, b)
        if b_ax is None:
            raise ValueError(f"cache leaf {tuple(a.shape)} has no batch dim")
        q_ax = _changed(a, c)
        if q_ax is not None:
            L = a.shape[q_ax]
            if q_ax != b_ax + 1:
                raise NotImplementedError(
                    f"paged leaf {tuple(a.shape)}: sequence axis {q_ax} must "
                    f"directly follow batch axis {b_ax}")
            if L % block_size:
                raise ValueError(
                    f"kv_block_size={block_size} does not divide the "
                    f"cache length {L} of leaf {tuple(a.shape)}")
            lengths.append(L)
        else:
            lengths.append(None)
        b_axes.append(b_ax)
        q_axes.append(q_ax)

    widths = [L // block_size for L in lengths if L is not None]
    table_width = max(widths, default=1)
    if num_blocks is None:
        num_blocks = max(1, n_slots * table_width)
    return PagedLayout(
        treedef=t0.layers,
        batch_axes=tuple(b_axes), seq_axes=tuple(q_axes),
        lengths=tuple(lengths),
        leaf_shapes=tuple(tuple(l.shape) for l in l0),
        leaf_dtypes=tuple(l.dtype for l in l0),
        block_size=block_size, num_blocks=int(num_blocks),
        table_width=table_width, n_slots=n_slots, s_max=s_max)


class PagedCache(NamedTuple):
    """Device half of the paged state: the pools tree (paged leaves as
    ``[.., NB + 2, bs, ..]`` pools, state leaves dense ``[.., B, ..]``) and
    the per-slot write position.  Block tables live on the host (the
    scheduler owns admission) and go to the device with each call."""

    pools: Any
    pos: torch.Tensor            # [B] int64


def _iter_meta(layout: PagedLayout):
    return zip(layout.batch_axes, layout.seq_axes, layout.lengths,
               layout.leaf_shapes, layout.leaf_dtypes)


def init_paged_cache(layout: PagedLayout, device="cuda") -> PagedCache:
    """Zero pools (with the zero-read and discard blocks) and positions."""
    bs, nb = layout.block_size, layout.num_blocks
    leaves = []
    for b_ax, q_ax, _L, shape, dtype in _iter_meta(layout):
        if q_ax is not None:
            shape = shape[:b_ax] + (nb + 2, bs) + shape[q_ax + 1:]
        leaves.append(torch.zeros(shape, dtype=dtype, device=device))
    pools = tree.unflatten(layout.treedef, leaves)
    return PagedCache(pools, torch.zeros(layout.n_slots, dtype=torch.int64,
                                         device=device))


def _writable(ids: torch.Tensor, layout: PagedLayout) -> torch.Tensor:
    """Block ids to write: the sentinel goes to the discard block."""
    return torch.where(ids == layout.sentinel, layout.sentinel + 1, ids)


def gather_cache(paged: PagedCache, tables: torch.Tensor,
                 layout: PagedLayout) -> DecodeCache:
    """The dense ``DecodeCache`` view: physical blocks gathered into each
    slot's logical order, sentinel entries read from the zero block, so
    the view is bit for bit the contiguous cache the slot batcher holds.
    Paged leaves are fresh tensors; state leaves are the pool's own."""
    bs = layout.block_size
    out = []
    for leaf, (b_ax, q_ax, L, shape, _) in zip(tree.leaves(paged.pools),
                                               _iter_meta(layout)):
        if q_ax is None:
            out.append(leaf)
            continue
        idx = tables[:, :L // bs].reshape(-1)
        g = leaf.index_select(b_ax, idx)            # [.., B * T, bs, ..]
        out.append(g.reshape(shape[:q_ax] + (L,) + shape[q_ax + 1:]))
    return DecodeCache(tree.unflatten(layout.treedef, out), paged.pos, None)


def scatter_decode(paged: PagedCache, dense: DecodeCache,
                   tables: torch.Tensor, layout: PagedLayout,
                   start_pos: torch.Tensor, k: int) -> PagedCache:
    """Write back, in place, the blocks a K-step decode touched: positions
    ``[start_pos, start_pos + k)`` per slot (a leaf shorter than the table
    wraps modulo its own length).  State leaves are replaced wholesale.
    Sentinel entries (retired or unallocated rows) write to the discard
    block."""
    bs = layout.block_size
    nt_max = (k - 1) // bs + 2
    for pool, dleaf, (b_ax, q_ax, L, _shape, _) in zip(
            tree.leaves(paged.pools), tree.leaves(dense.layers),
            _iter_meta(layout)):
        if q_ax is None:
            if dleaf is not pool:
                pool.copy_(dleaf)
            continue
        t = L // bs
        nt = min(t, nt_max)
        lg = torch.remainder(
            torch.div(start_pos, bs, rounding_mode="floor")[:, None]
            + torch.arange(nt, device=start_pos.device)[None, :], t)
        phys = _writable(torch.gather(tables[:, :t], 1, lg), layout)
        d = torch.movedim(dleaf, (b_ax, q_ax), (0, 1))      # [B, L, ..]
        rows = torch.arange(d.shape[0], device=d.device)[:, None, None]
        at = lg[..., None] * bs + torch.arange(bs, device=d.device)
        vals = d[rows, at]                                  # [B, nt, bs, ..]
        torch.movedim(pool, (b_ax, b_ax + 1), (0, 1)).index_copy_(
            0, phys.reshape(-1),
            vals.reshape((-1,) + vals.shape[2:]).to(pool.dtype))
    return PagedCache(paged.pools, dense.pos)


def splice_request(paged: PagedCache, slot: DecodeCache, i: int,
                   row_table: torch.Tensor, layout: PagedLayout
                   ) -> PagedCache:
    """Admission: write a batch-1 prefill cache into slot ``i`` in place.
    Paged leaves scatter whole blocks through the slot's table row
    (sentinel entries to the discard block), state leaves splice at the
    batch axis like ``splice_slot``."""
    bs = layout.block_size
    for pool, sleaf, (b_ax, q_ax, L, _shape, _) in zip(
            tree.leaves(paged.pools), tree.leaves(slot.layers),
            _iter_meta(layout)):
        if q_ax is None:
            pool.narrow(b_ax, i, 1).copy_(sleaf)
            continue
        t = L // bs
        d = torch.movedim(sleaf, (b_ax, q_ax), (0, 1))[0]   # [L, ..]
        torch.movedim(pool, (b_ax, b_ax + 1), (0, 1)).index_copy_(
            0, _writable(row_table[:t], layout),
            d.reshape((t, bs) + d.shape[1:]).to(pool.dtype))
    paged.pos[i:i + 1] = slot.pos.to(paged.pos.dtype)
    return paged


# ------------------------------------------------------------------ mesh

def paged_cache_specs(paged: PagedCache, layout: PagedLayout, mesh,
                      policy=None) -> PagedCache:
    """The spec tree of a :class:`PagedCache` under a serving mesh.

    Pool leaves have no batch dim; the block-offset dim is the paging
    address space and stays whole, and "model" goes on the largest
    divisible remaining dim (heads, latent), mirroring
    :func:`~repro_torch.distributed.sharding.cache_specs`.  On a ``data x
    model`` mesh the block-id dim also splits over "data" where the
    ``num_blocks`` logical blocks divide (the zero-read and discard
    blocks are each shard's own), and the per-slot positions split with
    the slots.  State leaves take the cache rule with batch
    ``n_slots``.

    This is the reference's rule.  The live pools a rank holds split the
    kv heads where attention runs on the rank's own heads and the head
    dim where a decode step runs on the rank's head dims
    (``models.attention.head_split``, modes ``"kv"`` and ``"d"``), also
    where this spec names another dim (the head dim of olmo-1b's pool
    leaves, in mode ``"kv"``): the reference's attention constraints put
    those dims on "tp", and XLA reshards between the two."""
    from repro_torch.distributed import sharding as shd

    msize = shd.axis_size(mesh, ("model",))
    dsize = (shd.axis_size(mesh, ("data",))
             if "data" in mesh.axis_names else 1)

    def pool_spec(shape, b_ax):
        spec: list = [None] * len(shape)
        if dsize > 1 and layout.num_blocks % dsize == 0:
            spec[b_ax] = "data"
        reserved = {b_ax, b_ax + 1}
        cand = [i for i, d in enumerate(shape)
                if i not in reserved and d % msize == 0 and d >= msize > 1]
        mdim = max(cand, key=lambda i: shape[i]) if cand else -1
        if mdim >= 0:
            spec[mdim] = "model"
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    out = []
    for leaf, (b_ax, q_ax, _L, _shape, _) in zip(tree.leaves(paged.pools),
                                                 _iter_meta(layout)):
        if q_ax is None:
            out.append(shd.cache_spec(leaf.shape, mesh, layout.n_slots,
                                      policy))
        else:
            out.append(pool_spec(tuple(leaf.shape), b_ax))
    pos = ("data",) if dsize > 1 and layout.n_slots % dsize == 0 else ()
    return PagedCache(tree.unflatten(layout.treedef, out), pos)


def required_blocks(n_positions: int, layout: PagedLayout) -> int:
    """Table entries needed to cover ``n_positions`` written positions
    (capped at the table width: ring wrap reuses early entries)."""
    return min(layout.table_width,
               -(-int(n_positions) // layout.block_size))


def host_table_row(layout: PagedLayout, blocks: list[int]) -> np.ndarray:
    row = np.full((layout.table_width,), layout.sentinel, np.int32)
    row[:len(blocks)] = blocks
    return row
