"""Attention: GQA/MHA with a dense path, a chunked online-softmax path
for long caches, and KV-cache prefill/decode; and deepseek-v2's
Multi-head Latent Attention (MLA); and whisper's decoder-to-encoder
cross-attention.  Port of ``repro.models.attention``.

Only the static-weight projections (q/k/v/o, MLA's dkv/krope/ukv, policy
paths ``attn.*``; cross-attention's ``cross.*``; kind ``attn``) resolve an
``ExecSpec``; the score/value
products have two dynamic operands and stay digital by design, as on the
chip.

KV caches (and MLA's latent caches) are updated IN PLACE (the reference
returns fresh arrays): a prefill writes its keys into the cache it is
given, a decode step writes one slot per row, and both return that same
cache.

On a serving mesh MHA/GQA attention runs on the rank's share where the
reference's rule (:func:`attn_tp_mode`) puts the model axis
(:func:`head_split`):

* on the kv heads (``"kv"``) or the GQA group (``"g"``), where the
  layer's q/k/v images are column tiles and its ``wo`` image a row tile:
  q (and in ``"kv"`` k, v and the KV cache) hold the rank's heads,
  attention runs on them alone, and ``wo``'s row tile takes the rank's
  slice of the attention output as its input;
* on the query rows (``"sq"``) or the head dim (``"d"``), on any
  backend: q, k and v are gathered as off the head split, each rank
  runs attention on its rows (against every key) or on its head-dim
  slice (the partial scores summed over ``"model"`` before the
  softmax), and the output is gathered before ``wo``.  The KV caches
  (and whisper's cross keys and values) hold the rank's head-dim slice
  where a decode step is ``"d"``.

In a tensor-parallel training step (``distributed.autoshard.tp_mesh``)
the same modes come from the step's parameter slices instead of a
program's tiles (:func:`head_split` of the call's query rows, on any
backend): q, k and v are the rank's column tiles, kept as its heads in
``"kv"`` (q alone in ``"g"``) and gathered whole otherwise, RoPE runs on
the heads the rank holds, and ``wo`` is the row-parallel projection
(``models.layers.row_linear``) of the rank's heads or of the gathered
output; ``"sq"`` and ``"d"`` run :func:`split_sdpa` with the
differentiable collectives (``autoshard.gather``, ``autoshard.reduce``).

The tiles and the input grid are the ones the whole-activation mesh
path uses, so ``"kv"``, ``"g"`` and ``"sq"`` give its results (``"sq"``
up to the rows' float order where the matmul blocks another number of
rows differently); ``"d"`` sums each score in another order.  MLA runs
on the rank's q heads where the tiles allow it
(:func:`~repro_torch.models.mixer_split.mla_split`, in
:func:`mla_attention`), with the same bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tally
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import (get_mesh, get_shard_policy,
                                               in_manual, sum_grad, tp_mesh,
                                               train_mesh)

from .layers import apply_rope, init_linear, linear, replicated, row_linear
from .mixer_split import mla_split, tiles_allow

DEFAULT_CHUNK = 512


def attn_tp_mode(kv: int, g: int, sq: int, d: int) -> str:
    """Where the ambient mesh's model axis goes inside attention, by the
    reference's divisibility priority (``_attn_tp_mode``): kv heads
    (``"kv"``), the GQA group (``"g"``), the query sequence (``"sq"``),
    the head dim (``"d"``); ``"none"`` without a model axis wider than 1
    or under an fsdp policy."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.axis_names \
            or get_shard_policy().is_fsdp:
        return "none"
    return _tp_mode(int(dict(mesh.shape)["model"]), kv, g, sq, d)


def _tp_mode(m: int, kv: int, g: int, sq: int, d: int) -> str:
    """The reference's priority on a model axis of ``m`` ranks."""
    if m <= 1:
        return "none"
    for mode, size in (("kv", kv), ("g", g), ("sq", sq), ("d", d)):
        if size % m == 0:
            return mode
    return "none"


class HeadSplit(NamedTuple):
    """The share of an attention call one rank of the model axis
    computes."""

    mode: str       # "kv", "g", "sq" or "d"
    h: int          # its q heads, global [q0, q0 + h): all but in kv/g
    kv: int         # the kv heads it holds: its own in "kv", all else
    q0: int
    g: int          # the model's GQA group (q heads a kv head serves)
    lo: int = 0     # "sq": its query rows [lo, hi); "d": its head dims
    hi: int = 0


# the projections of a head-local layer and the tile each runs as
_LOCAL_TILES = {"kv": {"attn.q": "col", "attn.k": "col", "attn.v": "col",
                       "attn.o": "row"},
                "g": {"attn.q": "col", "attn.o": "row"}}


def head_split(cfg, sq: int = 1) -> Optional[HeadSplit]:
    """This rank's share of an MHA/GQA attention call of ``sq`` query
    rows (1: a decode step) on the ambient mesh, else None (the call
    runs whole, as off a mesh).  The mode is the reference's for the
    call (:func:`attn_tp_mode`), outside a training step's scope and
    with the model axis not manual.

    ``"kv"`` and ``"g"`` (head-local) need the program's q (and in
    ``"kv"`` k, v) images as column tiles and ``wo``'s as a row tile on
    this mesh (:func:`~repro_torch.distributed.autoshard.mesh_tiles`),
    their specs on a backend with a sharded path, and an amax input
    statistic for ``wo``: the XNOR 1-bit scale is a mean, which a split
    input would sum in another order.  ``"sq"`` (the rank's query rows
    ``[k sq/m, (k+1) sq/m)``) and ``"d"`` (its head dims ``[k hd/m,
    (k+1) hd/m)``) change no tile (q, k and v are gathered, ``wo`` takes
    the whole activation), so they hold on any backend, the XNOR 1-bit
    ``wo`` included.  MLA takes none of these
    (:func:`~repro_torch.models.mixer_split.mla_split` is its split).

    In a tensor-parallel training step (``autoshard.tp_mesh``) the mode
    is the reference's for the call on the step's mesh, on any backend:
    the step's parameter slices are the tiles."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.mla:
        return None
    mesh = tp_mesh()
    if mesh is not None:
        mode = _tp_mode(mesh.size("model"), kv, h // kv, sq, hd)
    else:
        mesh = get_mesh()
        if mesh is None or train_mesh() is not None or in_manual("model"):
            return None
        mode = attn_tp_mode(kv, h // kv, sq, hd)
        if mode in _LOCAL_TILES and not tiles_allow(
                cfg, "attn", _LOCAL_TILES[mode], "attn.o"):
            return None
    m, k = mesh.size("model"), mesh.index("model")
    if mode in ("sq", "d"):
        n = sq if mode == "sq" else hd
        return HeadSplit(mode, h, kv, 0, h // kv, k * (n // m),
                         (k + 1) * (n // m))
    if mode not in _LOCAL_TILES:
        return None
    # a column tile is whole heads only where the heads divide the axis
    assert h % m == 0, (h, m)
    assert mode == "g" or kv % m == 0, (kv, m)
    return HeadSplit(mode, h // m, kv // m if mode == "kv" else kv,
                     k * (h // m), h // kv)


def _seq_split(split: Optional[HeadSplit]) -> Optional[HeadSplit]:
    """``split`` where it is ``"sq"`` or ``"d"``, else None: the modes
    whose projections run as off the head split."""
    return split if split is not None and split.mode in ("sq", "d") \
        else None


def _rank_kv(t: torch.Tensor, split: Optional[HeadSplit]) -> torch.Tensor:
    """The kv heads of ``t`` [B, S, KV, D] that the rank's q heads read,
    in the layout :func:`sdpa` groups.  ``t`` itself but in mode ``"g"``,
    where it holds every kv head: then the one kv head every local head
    maps to (``j // g``), else one per local q head."""
    if split is None or split.mode != "g":
        return t
    first = split.q0 // split.g
    last = (split.q0 + split.h - 1) // split.g
    if first == last:
        return t[:, :, first:first + 1]
    idx = torch.arange(split.q0, split.q0 + split.h, device=t.device)
    return t.index_select(2, torch.div(idx, split.g, rounding_mode="floor"))


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, S_max, HKV, D]
    v: torch.Tensor


def _pos_mask(q_positions, kv_positions, *, causal, window):
    """Visibility mask [B?, 1, 1, Sq, Sk] from absolute positions; either
    may be per-row ([B, S]) or shared ([S]); negative KV positions mark
    unwritten / padded slots and are always hidden."""
    qi = q_positions if q_positions.ndim == 2 else q_positions[None]
    kj = kv_positions if kv_positions.ndim == 2 else kv_positions[None]
    qi = qi[:, None, None, :, None]
    kj = kj[:, None, None, None, :]
    mask = kj >= 0
    if causal:
        mask = mask & (qi >= kj)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def _default_positions(q, k, q_offset, q_positions, kv_positions):
    if q_positions is None:
        q_positions = torch.arange(q.shape[1], device=q.device) + q_offset
    if kv_positions is None:
        kv_positions = torch.arange(k.shape[1], device=k.device)
    return q_positions, kv_positions


def _dense_attention(q, k, v, *, causal, window, q_offset, scale, dtype,
                     kv_positions=None, q_positions=None, score_sum=None):
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D].  Grouped-GQA dense softmax.
    ``score_sum`` (the ``"d"`` split) sums the partial scores of the
    rank's head dims over the model axis before they are scaled."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32))
    if score_sum is not None:
        s = score_sum(s)
    s = s * scale
    q_positions, kv_positions = _default_positions(q, k, q_offset,
                                                   q_positions, kv_positions)
    mask = _pos_mask(q_positions, kv_positions, causal=causal, window=window)
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, v.shape[-1]).to(dtype)


def _chunked_attention(q, k, v, *, causal, window, q_offset, scale, dtype,
                       chunk=DEFAULT_CHUNK, kv_positions=None,
                       q_positions=None, scan_remat=False, bf16_probs=False,
                       score_sum=None):
    """Online softmax over KV chunks: never materializes the full score
    matrix.  ``bf16_probs`` feeds the probabilities and V to the PV
    product in bf16 with f32 accumulation (``l`` stays f32).
    ``scan_remat`` checkpoints each chunk step when autograd records the
    pass: its scores and probabilities are recomputed in the backward
    pass instead of saved (the same forward values).  ``score_sum`` as
    in :func:`_dense_attention`, once a chunk."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_positions, kv_positions = _default_positions(q, k, q_offset,
                                                   q_positions, kv_positions)
    if kv_positions.ndim == 1:
        kv_positions = kv_positions[None]                     # [B?, Sk]
    qg = q.reshape(b, sq, kv, g, d).to(torch.float32)
    dv = v.shape[-1]

    def step(m, l, acc, kj, kch, vch):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kch)
        if score_sum is not None:
            s = score_sum(s)
        s = s * scale
        mask = _pos_mask(q_positions, kj, causal=causal, window=window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        if bf16_probs:
            # bf16 operands, f32 products and sums (a bf16 product is
            # exact in f32): the reference's preferred_element_type=f32
            p = p.to(torch.bfloat16).to(torch.float32)
            vch = vch.to(torch.bfloat16).to(torch.float32)
        acc = alpha[..., None] * acc + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                    vch)
        return m_new, l, acc

    remat = scan_remat and torch.is_grad_enabled()
    m = torch.full((b, kv, g, sq), -1e30, device=q.device)
    l = torch.zeros((b, kv, g, sq), device=q.device)
    acc = torch.zeros((b, kv, g, sq, dv), device=q.device)
    for c0 in range(0, sk, chunk):
        kj = kv_positions[:, c0:c0 + chunk]
        kch = k[:, c0:c0 + chunk].to(torch.float32)
        vch = v[:, c0:c0 + chunk].to(torch.float32)
        pad = chunk - kch.shape[1]
        if pad:     # the reference pads the last chunk with hidden slots
            kj = torch.nn.functional.pad(kj, (0, pad), value=-1)
            kch = torch.nn.functional.pad(kch, (0, 0, 0, 0, 0, pad))
            vch = torch.nn.functional.pad(vch, (0, 0, 0, 0, 0, pad))
        if remat:
            m, l, acc = checkpoint(step, m, l, acc, kj, kch, vch,
                                   use_reentrant=False)
        else:
            m, l, acc = step(m, l, acc, kj, kch, vch)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(dtype)


def sdpa(q, k, v, *, causal=True, window=None, q_offset=0, scale=None,
         dtype=torch.bfloat16, chunk=DEFAULT_CHUNK, kv_positions=None,
         q_positions=None, scan_remat=False, bf16_probs=False,
         score_sum=None):
    """Dense attention up to ``2 * chunk`` keys, chunked beyond
    (``scan_remat`` and ``bf16_probs`` apply to the chunked path, as in
    the reference)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    fn = _dense_attention if k.shape[1] <= 2 * chunk else _chunked_attention
    kw = ({} if fn is _dense_attention
          else {"chunk": chunk, "scan_remat": scan_remat,
                "bf16_probs": bf16_probs})
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
              scale=scale, dtype=dtype, kv_positions=kv_positions,
              q_positions=q_positions, score_sum=score_sum, **kw)


def _rank_dims(t: torch.Tensor, split: Optional[HeadSplit], hd: int):
    """k or v [B, S, KV, D] as the rank's share of ``split`` reads it:
    its head-dim slice in ``"d"``, whole otherwise.  ``t`` is whole
    (``D == hd``) or already the rank's slice (a ``"d"`` cache), which
    the other modes gather over ``"model"``."""
    sliced = t.shape[-1] != hd
    if split is not None and split.mode == "d":
        return t if sliced else t[..., split.lo:split.hi]
    return get_mesh().all_gather(t, "model", dim=-1) if sliced else t


def split_sdpa(split: Optional[HeadSplit], q, k, v, *, q_offset=0,
               q_positions=None, **kw):
    """:func:`sdpa` of the rank's share of a ``"sq"`` or ``"d"`` call,
    gathered over ``"model"`` (the whole output on every rank); any
    other ``split`` runs :func:`sdpa` as it is.  ``q`` [B, Sq, H, D] is
    whole; ``k``, ``v`` are whole in ``"sq"`` and the rank's head-dim
    slice in ``"d"`` (:func:`_rank_dims`).

    ``"sq"``: the rank's query rows against every key, at their absolute
    positions (``q_positions`` or ``arange(Sq) + q_offset``, per row or
    shared), so causal and window masks are the whole call's; the rows
    are gathered on dim 1.  ``"d"``: the rank's head dims of q, k and v;
    the float32 partial scores are summed over ``"model"`` (once, or
    once a chunk on the chunked path) before the scale, the mask and the
    softmax, which every rank then computes whole; ``p @ v`` runs on the
    rank's slice of v and the slices are gathered on the head dim."""
    split = _seq_split(split)
    if split is None:
        return sdpa(q, k, v, q_offset=q_offset, q_positions=q_positions,
                    **kw)
    mesh = get_mesh()
    if tp_mesh() is not None:
        # a training step: the same collectives under autograd.  The
        # summed scores feed each rank's own head dims of v, so their
        # gradient is summed over the ranks too
        def joined(t, dim):
            return autoshard.gather(t, "model", dim)

        def summed(t):
            return sum_grad(autoshard.reduce(t), "model")
    else:
        def joined(t, dim):
            return mesh.all_gather(t, "model", dim=dim)

        def summed(t):
            return mesh.all_reduce(t, "model")
    if split.mode == "sq":
        if q_positions is None:
            q_positions = torch.arange(q.shape[1], device=q.device) + \
                q_offset
        rows = slice(split.lo, split.hi)
        o = sdpa(q[:, rows], k, v, q_positions=q_positions[..., rows], **kw)
        return joined(o, 1)
    if kw.get("scale") is None:
        kw["scale"] = q.shape[-1] ** -0.5
    o = sdpa(q[..., split.lo:split.hi], k, v, q_offset=q_offset,
             q_positions=q_positions, score_sum=summed, **kw)
    return joined(o, -1)


def ring_slot_positions(cache_len: int, cache_pos) -> torch.Tensor:
    """Absolute position held by each ring-cache slot after writing at
    ``cache_pos`` (negative = not yet written); a per-row ``cache_pos``
    [B] gives [B, L]."""
    cache_pos = torch.as_tensor(cache_pos)
    i = torch.arange(cache_len, device=cache_pos.device)
    if cache_pos.ndim:
        cache_pos = cache_pos[:, None]
    return cache_pos - torch.remainder(cache_pos - i, cache_len)


def _row_positions(cache_pos, batch: int, device) -> torch.Tensor:
    """Normalize a scalar or per-row decode position to [B] int64."""
    cp = torch.as_tensor(cache_pos, dtype=torch.int64, device=device)
    return cp.expand(batch) if cp.ndim == 0 else cp


def left_align(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Shift each row of ``x`` [B, S, ...] left by its pad count so the
    real entries of a LEFT-padded row land at [0, len_b); the tail is
    zero-filled."""
    s = x.shape[1]
    lengths = pad_mask.sum(dim=1)                             # [B]
    ar = torch.arange(s, device=x.device)
    idx = torch.clamp_max(ar[None, :] + (s - lengths)[:, None], s - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    gathered = torch.gather(x, 1, idx)
    valid = ar[None, :] < lengths[:, None]
    valid = valid.reshape(valid.shape + (1,) * (x.ndim - 2))
    return torch.where(valid, gathered, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


# ------------------------------------------------------------------ GQA

def init_attention(gen, cfg, device, lead: tuple = ()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": init_linear(gen, d, h * hd, device, lead),
        "wk": init_linear(gen, d, kv * hd, device, lead),
        "wv": init_linear(gen, d, kv * hd, device, lead),
        "wo": init_linear(gen, h * hd, d, device, lead),
    }


def _cache_dims(cfg, split: Optional[HeadSplit]) -> tuple:
    """(kv heads, head dim) of a cache laid out for ``split``."""
    if split is not None and split.mode == "kv":
        return split.kv, cfg.hd
    if split is not None and split.mode == "d":
        return cfg.n_kv_heads, split.hi - split.lo
    return cfg.n_kv_heads, cfg.hd


def kv_cache_dims(cfg) -> tuple:
    """The (kv heads, head dim) a rank's KV cache holds, fixed by the
    decode step's split (:func:`head_split` of one query row): its own kv
    heads in ``"kv"``, its head-dim slice in ``"d"``, all of both
    otherwise.  Prefills of either mode write that layout."""
    return _cache_dims(cfg, head_split(cfg))


def cross_kv_dims(cfg) -> tuple:
    """The (kv heads, head dim) of the cross keys and values a rank's
    decode cache holds (whisper): its head-dim slice where a decode
    step's cross-attention is ``"d"``, whole otherwise (cross-attention
    takes only the ``"sq"`` and ``"d"`` splits, :func:`cross_split`)."""
    return _cache_dims(cfg, cross_split(cfg))


def init_kv_cache(cfg, batch: int, s_max: int, dtype, device,
                  lead: tuple = ()) -> KVCache:
    """Windowed layers get a ring cache of the window length.  On a
    serving mesh the cache holds the rank's kv heads or head dims
    (:func:`kv_cache_dims`)."""
    length = min(s_max, cfg.attn_window) if cfg.attn_window else s_max
    shape = lead + (batch, length) + kv_cache_dims(cfg)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention(params, x, cfg, positions, cache: Optional[KVCache] = None,
              cache_pos=None, dtype=torch.bfloat16, pad_mask=None):
    """Full sequence (prefill) when ``cache_pos`` is None, else decode
    writing ``cache`` at ``cache_pos`` (scalar or per row [B]).  Returns
    (out, cache).

    ``pad_mask`` ([B, S] bool, True = real token; prefill only) admits
    LEFT-padded prompts: ``positions`` are then the per-row true positions
    [B, S], padded keys are hidden, and the cache is written left-aligned.

    On a serving mesh (:func:`head_split` of the call's S rows): in
    ``"kv"`` and ``"g"`` q holds the rank's heads, k, v and the cache the
    rank's kv heads in ``"kv"`` (all of them in ``"g"``, each local head
    reading its ``j // g``), and the rank's slice of the output goes to
    ``wo``'s row tile; in ``"sq"`` and ``"d"`` attention runs on the
    rank's query rows or head dims (:func:`split_sdpa`) and the cache
    holds the rank's head dims where a decode step is ``"d"``
    (:func:`kv_cache_dims`).
    """
    tp = tp_mesh() is not None
    if tp and (cache is not None or cache_pos is not None):
        raise ValueError("a tensor-parallel training step runs no KV cache")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    split = head_split(cfg, s)
    if tally.ACTIVE and train_mesh() is not None:
        tally.report_form("attn", (f"tp/{split.mode if split else 'none'}"
                                   if tp else "whole"))
    q_local = kv_local = None
    if split is not None and split.mode in _LOCAL_TILES:
        h, q_local = split.h, "col"
        if split.mode == "kv":
            kv, kv_local = split.kv, "col"
    # the cache's layout is the decode step's split
    layout = head_split(cfg) if split is not None and split.mode == "sq" \
        else split
    dims = _cache_dims(cfg, layout)
    if cache is not None and tuple(cache.k.shape[-2:]) != dims:
        raise ValueError(
            f"a cache of {tuple(cache.k.shape[-2:])} (kv heads, head dim) "
            f"for a layer of {dims} on this rank: make the cache in the "
            f"scope that serves it")
    sp = cfg.policy.resolver("attn")
    q = _qkv(params["wq"], x, sp("attn.q"), dtype, q_local,
             split).reshape(b, s, h, hd)
    k = _qkv(params["wk"], x, sp("attn.k"), dtype, kv_local,
             split).reshape(b, s, kv, hd)
    v = _qkv(params["wv"], x, sp("attn.v"), dtype, kv_local,
             split).reshape(b, s, kv, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache_pos is None:
        q_pos = kv_pos = None
        if pad_mask is not None:
            q_pos = positions
            kv_pos = torch.where(pad_mask, positions, -1)
        o = split_sdpa(split, q, _rank_dims(_rank_kv(k, split), split, hd),
                       _rank_dims(_rank_kv(v, split), split, hd),
                       causal=cfg.causal, window=cfg.attn_window, q_offset=0,
                       dtype=dtype, kv_positions=kv_pos, q_positions=q_pos,
                       scan_remat=cfg.attn_scan_remat,
                       bf16_probs=cfg.attn_bf16_probs)
        if cache is not None:   # prefill: fill the (possibly ring) cache
            length = cache.k.shape[1]
            kc, vc = _rank_dims(k, layout, hd), _rank_dims(v, layout, hd)
            if pad_mask is not None:
                if length < s:
                    raise NotImplementedError(
                        "pad-masked prefill into a ring cache shorter than "
                        "the padded prompt is unsupported")
                kc, vc = left_align(kc, pad_mask), left_align(vc, pad_mask)
            if length >= s:
                cache.k[:, :s] = kc
                cache.v[:, :s] = vc
            else:               # keep only the trailing window, ring-aligned
                off = (s - length) % length
                cache.k.copy_(torch.roll(kc[:, s - length:], off, dims=1))
                cache.v.copy_(torch.roll(vc[:, s - length:], off, dims=1))
    else:
        # write the s new tokens at their per-row ring slots, then attend
        # over the whole cache; unwritten slots carry negative positions
        # and get exactly zero probability
        length = cache.k.shape[1]
        cp = _row_positions(cache_pos, b, x.device)
        offs = cp[:, None] + torch.arange(s, device=x.device)[None, :]
        slot = torch.remainder(offs, length)
        rows = torch.arange(b, device=x.device)[:, None]
        cache.k[rows, slot] = _rank_dims(k, layout, hd).to(cache.k.dtype)
        cache.v[rows, slot] = _rank_dims(v, layout, hd).to(cache.v.dtype)
        kv_pos = ring_slot_positions(length, cp + (s - 1))    # [B, L]
        o = split_sdpa(split, q,
                       _rank_dims(_rank_kv(cache.k, split), split, hd),
                       _rank_dims(_rank_kv(cache.v, split), split, hd),
                       causal=True, window=cfg.attn_window, dtype=dtype,
                       kv_positions=kv_pos, q_positions=offs)
    o = o.reshape(b, s, h * hd)
    if tp:
        return row_linear(params["wo"], o, sp("attn.o"), dtype,
                          block=q_local is not None), None
    out = linear(params["wo"], o, sp("attn.o"), dtype,
                 local="row" if q_local is not None else None)
    return out, cache


def _qkv(p: dict, x, spec, dtype, local: Optional[str],
         split: Optional[HeadSplit]):
    """q, k or v: ``linear`` in the serving mesh's ``local`` form.  In a
    tensor-parallel training step the rank's column tile of its
    replicated input, kept as the rank's heads where ``local`` asks for
    them and else gathered whole over ``"model"``: its gradient summed
    over the ranks where each used only its share of it (any
    ``split``)."""
    if tp_mesh() is None:
        return linear(p, x, spec, dtype, local=local)
    y = linear(p, replicated(x, spec), spec, dtype, tile="col")
    if local is None:
        y = autoshard.gather(y, "model", -1, partial=split is not None)
    return y


# ------------------------------------------------------------------ MLA

class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, S_max, kv_lora]  compressed latents
    k_rope: torch.Tensor     # [B, S_max, rope_dim] shared rope key


def init_mla_cache(cfg, batch: int, s_max: int, dtype, device,
                   lead: tuple = ()) -> MLACache:
    return MLACache(
        torch.zeros(lead + (batch, s_max, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros(lead + (batch, s_max, cfg.qk_rope_head_dim), dtype=dtype,
                    device=device))


def init_mla(gen, cfg, device, lead: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return {
        "wq": init_linear(gen, d, h * (dn + dr), device, lead),
        "w_dkv": init_linear(gen, d, r, device, lead),       # compression
        "w_krope": init_linear(gen, d, dr, device, lead),    # shared rope key
        "w_ukv": init_linear(gen, r, h * (dn + dv), device, lead),
        "wo": init_linear(gen, h * dv, d, device, lead),
    }


def _write_rows(buf, offs, vals):
    """``buf[b, offs[b]] = vals[b]`` in place, dropping positions at or past
    the end of ``buf`` as the reference's ``.at[].set`` drops them (a
    retired slot's position runs on while its neighbours decode).  A
    dropped write repeats its row's last kept write, or the old value
    where the row keeps none, so duplicate indices carry equal values."""
    length, s = buf.shape[1], offs.shape[1]
    rows = torch.arange(offs.shape[0], device=offs.device)[:, None]
    last = torch.clamp_min(length - 1 - offs[:, :1], -1)      # [B, 1]
    j = torch.minimum(torch.arange(s, device=offs.device)[None, :], last)
    at = torch.clamp_max(offs, length - 1)
    keep = (j >= 0)[..., None]
    buf[rows, at] = torch.where(keep, vals[rows, torch.clamp_min(j, 0)],
                                buf[rows, at])


def mla_attention(params, x, cfg, positions, cache: Optional[MLACache] = None,
                  cache_pos=None, dtype=torch.bfloat16, pad_mask=None):
    """Multi-head Latent Attention (deepseek-v2): the cache stores only
    the rank-``kv_lora_rank`` latent and the shared rope key per token,
    and ``w_ukv`` expands the latents it attends over (at decode, the
    whole cache) into per-head keys and values.  ``pad_mask`` and a
    per-row ``cache_pos`` as in :func:`attention`.  Returns (out,
    cache).

    On a serving mesh whose tiles allow it (:func:`~repro_torch.models.
    mixer_split.mla_split`) the rank runs its own q heads: ``wq`` and
    ``w_ukv`` as local column tiles (its heads' q, keys and values, with
    no collective), attention on them, and ``wo``'s row tile on its
    heads' output.  The latent cache and the shared rope key stay whole
    on every rank."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    sp = cfg.policy.resolver("attn")
    split = mla_split(cfg)
    col = row = None
    if split is not None:
        h, col, row = split.size, "col", "row"

    q = linear(params["wq"], x, sp("attn.q"), dtype,
               local=col).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    c_kv = linear(params["w_dkv"], x, sp("attn.dkv"), dtype)       # [B,S,r]
    k_rope = linear(params["w_krope"], x, sp("attn.krope"),
                    dtype)[:, :, None, :]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)        # [B,S,1,dr]

    q_pos = kv_pos = None
    if cache_pos is None:
        full_c, full_rope = c_kv, k_rope
        if pad_mask is not None:
            q_pos = positions
            kv_pos = torch.where(pad_mask, positions, -1)
        if cache is not None:   # prefill into the pre-allocated cache
            ckv_w, krope_w = c_kv, k_rope[:, :, 0, :]
            if pad_mask is not None:
                ckv_w = left_align(ckv_w, pad_mask)
                krope_w = left_align(krope_w, pad_mask)
            cache.c_kv[:, :s] = ckv_w
            cache.k_rope[:, :s] = krope_w
    else:
        # decode / resumed prefill: write the s new latents at the rows'
        # absolute positions; slots at or above a row's position are
        # hidden by the causal mask on q_pos (exactly zero probability)
        cp = _row_positions(cache_pos, b, x.device)
        offs = cp[:, None] + torch.arange(s, device=x.device)[None, :]
        _write_rows(cache.c_kv, offs, c_kv.to(cache.c_kv.dtype))
        _write_rows(cache.k_rope, offs,
                    k_rope[:, :, 0, :].to(cache.k_rope.dtype))
        full_c, full_rope = cache.c_kv, cache.k_rope[:, :, None, :]
        q_pos = offs

    length = full_c.shape[1]
    kvu = linear(params["w_ukv"], full_c, sp("attn.ukv"), dtype,
                 local=col).reshape(b, length, h, dn + dv)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    k = torch.cat([k_nope, full_rope.expand(b, length, h, dr)], dim=-1)
    o = sdpa(q, k, v, causal=True, scale=(dn + dr) ** -0.5, dtype=dtype,
             kv_positions=kv_pos, q_positions=q_pos,
             scan_remat=cfg.attn_scan_remat, bf16_probs=cfg.attn_bf16_probs)
    out = linear(params["wo"], o.reshape(b, s, h * dv), sp("attn.o"), dtype,
                 local=row)
    return out, cache


# -------------------------------------------------------- cross-attention

def init_cross_attention(gen, cfg, device, lead: tuple = ()) -> dict:
    return init_attention(gen, cfg, device, lead)


def cross_split(cfg, sq: int = 1) -> Optional[HeadSplit]:
    """This rank's share of a cross-attention call of ``sq`` query rows:
    :func:`head_split`'s ``"sq"`` or ``"d"`` split, else None (whole;
    cross-attention's projections are not head-local)."""
    return _seq_split(head_split(cfg, sq))


def cross_kv_layout(t: torch.Tensor, cfg) -> torch.Tensor:
    """Whole cross keys or values [..., KV, D] as a rank's decode cache
    holds them (:func:`cross_kv_dims`): the rank's head-dim slice where
    a decode step's cross-attention is ``"d"``."""
    split = cross_split(cfg)
    return t if split is None or split.mode != "d" \
        else t[..., split.lo:split.hi].contiguous()


def cross_attention(params, x, enc_kv, cfg, dtype=torch.bfloat16):
    """Decoder-to-encoder attention (whisper): queries from ``x`` [B, S,
    d] over the precomputed encoder keys and values ``enc_kv`` = (k, v),
    each [B, S_enc, KV, D] (whole, or a ``"d"`` cache's head-dim slice),
    unmasked.  Past ``2 * DEFAULT_CHUNK`` keys (whisper's 1,500 frames)
    this is the chunked path, whose padded last chunk is hidden by its
    negative key positions alone.  On a serving mesh it runs on the
    rank's query rows or head dims (:func:`cross_split`,
    :func:`split_sdpa`)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    split = cross_split(cfg, s)
    sp = cfg.policy.resolver("attn")
    q = linear(params["wq"], x, sp("cross.q"), dtype).reshape(b, s, h, hd)
    k, v = (_rank_dims(t, split, hd) for t in enc_kv)
    o = split_sdpa(split, q, k, v, causal=False, dtype=dtype)
    return linear(params["wo"], o.reshape(b, s, h * hd), sp("cross.o"), dtype)


def encode_cross_kv(params, enc_out, cfg, dtype=torch.bfloat16):
    """One layer's cross-attention keys and values of the encoder output
    ``enc_out`` [B, S_enc, d]: (k, v), each [B, S_enc, KV, D], D the
    rank's head-dim slice where its decode cache holds one
    (:func:`cross_kv_layout`)."""
    b, s, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    sp = cfg.policy.resolver("attn")
    k = linear(params["wk"], enc_out, sp("cross.k"), dtype).reshape(
        b, s, kv, hd)
    v = linear(params["wv"], enc_out, sp("cross.v"), dtype).reshape(
        b, s, kv, hd)
    return cross_kv_layout(k, cfg), cross_kv_layout(v, cfg)
