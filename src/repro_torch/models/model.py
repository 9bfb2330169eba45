"""Model API for every architecture of the reference: dense (GQA, local
windows), hybrid RG-LRU (recurrentgemma), SSM (mamba2), MoE with MLA
(deepseek-v2), the encoder-decoder whisper and the early-fusion decoders
(phi-3-vision, llama4-scout).  Port of ``repro.models.model``.

* ``init_params(cfg, gen, device, max_seq)`` — the parameter tree (same
  nested dict keys as the reference, stacked ``"scanned"`` layer leaves;
  whisper's ``encoder``, ``dec_pos`` and per-layer ``cross`` stacked over
  the decoder layers).
* ``forward / loss_fn`` — full-sequence logits and the next-token loss
  (training; ``cfg.remat`` checkpoints each layer under autograd).
* ``init_cache / prefill / decode_step`` — serving with a KV cache.
* ``prefill_resume`` — continue a prefill on top of a cache.
* ``slice_slot / splice_slot`` — per-slot cache surgery for slot-level
  continuous batching.

Modality frontends are stubs, as in the reference: the caller passes
precomputed patch or frame embeddings at ``d_model``
(``frontend_embeds`` [B, F, d]).  An early-fusion decoder puts them in
place of its first F positions; whisper's encoder takes them as its
input (zeros when none are given).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.accel import matmul as accel_matmul, vmapped
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import batch_stats, tp_mesh
from repro_torch.tree import tree_map

from . import attention as attn_mod
from . import transformer as tfm
from .layers import (embed, init_embedding, init_linear, init_norm, linear,
                     norm, replicated, truncated_normal_init, unembed)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _encoder_cfg(cfg):
    """Whisper's encoder: ``enc_layers`` bidirectional attention layers."""
    return dataclasses.replace(cfg, n_layers=cfg.enc_layers,
                               block_pattern=(), causal=False)


# ---------------------------------------------------------------- params

def init_params(cfg, gen: Union[torch.Generator, int] = 0, device="cuda",
                max_seq: int = 32768) -> dict:
    """Random parameters (float32 masters) drawn from ``gen`` — a
    ``torch.Generator`` on ``device`` or an integer seed for one.
    ``max_seq`` sizes whisper's learned decoder positions.  On ``meta``
    (no generator there) the tree has the same shapes and dtypes and no
    values."""
    if torch.device(device).type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    p: dict = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        # accel-lint: allow[JAX02] init: one seeded stream
        "stack": tfm.init_stack(gen, cfg, device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        # accel-lint: allow[JAX02] init: one seeded stream
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, device)
    if cfg.is_encdec:
        d, n = cfg.d_model, cfg.n_layers
        p["encoder"] = {
            # accel-lint: allow[JAX02] init: one seeded stream
            "stack": tfm.init_stack(gen, _encoder_cfg(cfg), device),
            "final_norm": init_norm(d, cfg.norm, device),
            # accel-lint: allow[JAX02] init: one seeded stream
            "pos": truncated_normal_init(gen, (cfg.frontend_seq, d), 0.02,
                                         device),
        }
        # whisper's decoder positions are learned, not rotary
        # accel-lint: allow[JAX02] init: one seeded stream
        p["dec_pos"] = truncated_normal_init(gen, (max_seq, d), 0.02, device)
        # per-decoder-layer cross-attention, stacked over the layers
        p["cross"] = {"ln": init_norm(d, cfg.norm, device, (n,)),
                      # accel-lint: allow[JAX02] init: one seeded stream
                      "attn": attn_mod.init_cross_attention(gen, cfg, device,
                                                            (n,))}
    return p


def _embed_inputs(params, tokens, cfg, frontend_embeds, dtype):
    """Token embeddings; an early-fusion decoder's ``frontend_embeds``
    [B, F, d] replace its first F positions (the prompt must hold at
    least F tokens)."""
    x = embed(params["embed"], tokens, dtype, cfg.onehot_embed, cfg.vocab)
    if cfg.frontend != "none" and not cfg.is_encdec \
            and frontend_embeds is not None:
        f = frontend_embeds.shape[1]
        if tokens.shape[1] < f:
            raise ValueError(
                f"{cfg.name}: a prompt of {tokens.shape[1]} tokens is "
                f"shorter than its {f} frontend positions")
        x = torch.cat([frontend_embeds.to(dtype), x[:, f:]], dim=1)
    return x


# ----------------------------------------------------------- whisper path

def _encode(params, frontend_embeds, cfg, dtype):
    """The encoder over the frame embeddings [B, frontend_seq, d], with
    learned positions; returns its normed output."""
    enc = params["encoder"]
    x = frontend_embeds.to(dtype) + enc["pos"][None].to(dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = tfm.apply_stack(enc["stack"], x, _encoder_cfg(cfg), positions,
                              dtype=dtype)
    return norm(enc["final_norm"], x, cfg.norm)


def _cross_kv_all_layers(params, enc_out, cfg, dtype):
    """Every decoder layer's cross-attention keys and values of
    ``enc_out`` [B, S_enc, d]: (k, v), each [L, B, S_enc, KV, D].  Each
    projection is ONE grouped dispatch over the L layers (the reference's
    ``jax.vmap`` over the stacked ``cross`` params): ``enc_out`` expanded
    over L (a stride-0 view) against the stacked weights and images, one
    grouped kernel launch on the kernel backend."""
    pa = params["cross"]["attn"]
    n = cfg.n_layers
    b, s, d = enc_out.shape
    sp = cfg.policy.resolver("attn")
    x = enc_out.expand(n, b, s, d)

    def proj(name, path):
        y = accel_matmul(x, pa[name]["w"], sp(path), dtype=dtype,
                         image=pa[name].get("cima")).to(dtype)
        return y.reshape(n, b, s, cfg.n_kv_heads, cfg.hd)

    with vmapped(n):
        return proj("wk", "cross.k"), proj("wv", "cross.v")


def _encoder_kv(params, frontend_embeds, cfg, batch: int, dtype, device):
    """Encode the frames (zeros when none are given) and project every
    decoder layer's cross keys and values."""
    if frontend_embeds is None:
        frontend_embeds = torch.zeros((batch, cfg.frontend_seq, cfg.d_model),
                                      dtype=dtype, device=device)
    enc_out = _encode(params, frontend_embeds, cfg, dtype)
    return _cross_kv_all_layers(params, enc_out, cfg, dtype)


def _decoder_with_cross(params, x, cfg, positions, cross_kv, cache,
                        cache_pos, dtype, pad_mask=None):
    """Whisper's decoder: per layer a self-attention block, then
    cross-attention over that layer's encoder keys and values.  The layer
    loop dispatches every layer on its own (the reference scans one body
    under ``vmapped(n_layers)``; here nothing scales).  ``cache`` (when
    given) is written in place and returned."""
    stacked = params["stack"]["scanned"]["u0"]
    caches = cache["scanned"]["u0"] if cache is not None else None
    remat = tfm._remat(cfg, stacked, x, cache)
    for i in range(cfg.n_layers):
        p_block = tfm.layer_slice(stacked, i)
        p_cross = tfm.layer_slice(params["cross"], i)
        ckv = (cross_kv[0][i], cross_kv[1][i])
        c = tfm.layer_slice(caches, i) if caches is not None else None

        def body(x_, p_block=p_block, p_cross=p_cross, ckv=ckv, c=c):
            x_, _, _ = tfm.apply_block(p_block, x_, cfg, "attn", positions,
                                       c, cache_pos, dtype,
                                       pad_mask=pad_mask)
            h = norm(p_cross["ln"], x_, cfg.norm)
            return x_ + attn_mod.cross_attention(p_cross["attn"], h, ckv,
                                                 cfg, dtype)

        x = tfm._checkpointed(body, x) if remat else body(x)
    return x, cache


def vocab_split(params, cfg) -> bool:
    """Does a tensor-parallel training step hold its vocabulary block of
    the head (tied table or ``lm_head``): one the model axis divides?  A
    head of all ``cfg.vocab`` columns is used whole, and each rank
    computes every logit."""
    if tp_mesh() is None:
        return False
    cols = (params["embed"]["table"].shape[0] if cfg.tie_embeddings
            else params["lm_head"]["w"].shape[-1])
    return int(cols) < cfg.vocab


def _lm_logits(params, x, cfg, dtype):
    """Final projection to vocab — a static-weight MVM (path ``unembed``),
    tied or untied.  In a tensor-parallel training step the rank's
    vocabulary block of the logits (its column tile of the head), or all
    of them where the head is whole (:func:`vocab_split`)."""
    spec = cfg.policy.resolve("unembed", kind="unembed")
    tile = None
    if vocab_split(params, cfg):
        x, tile = replicated(x, spec), "col"
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, spec, dtype, tile=tile)
    return linear(params["lm_head"], x, spec, dtype,
                  tile=tile).to(torch.float32)


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp(logits) - logits[target]`` where
    ``logits`` [..., V/m] is this rank's vocabulary block of a
    tensor-parallel training step's logits: the ``max`` over ``"model"``
    (no gradient: the shift cancels), the sum of the exponentials over
    ``"model"`` and the target's logit from the rank that holds it
    (summed over ``"model"``, the others adding zero).  No rank builds
    the whole logits.  The same value as
    ``torch.logsumexp(whole, -1) - whole.gather(target)``, in another
    summation order."""
    mesh = tp_mesh()
    v = logits.shape[-1]
    lo = mesh.index("model") * v
    mx = mesh.all_reduce(torch.amax(logits.detach(), dim=-1, keepdim=True),
                         "model", op="max")
    se = autoshard.reduce(torch.exp(logits - mx).sum(dim=-1))
    local = targets - lo
    mine = (local >= 0) & (local < v)
    tgt = torch.take_along_dim(logits, torch.where(mine, local, 0)[..., None],
                               dim=-1)[..., 0]
    tgt = autoshard.reduce(torch.where(mine, tgt, 0.0))
    return torch.log(se) + mx[..., 0] - tgt


# ---------------------------------------------------------------- training

def forward(params, tokens: torch.Tensor, cfg, frontend_embeds=None):
    """Full-sequence logits [B, S, vocab] (training / teacher forcing) and
    the MoE blocks' summed auxiliary loss (0 without MoE blocks); in a
    tensor-parallel training step the rank's vocabulary block [B, S,
    vocab / m] (:func:`vocab_split`)."""
    dtype = _dtype(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    if cfg.is_encdec:
        cross_kv = _encoder_kv(params, frontend_embeds, cfg, b, dtype,
                               tokens.device)
        x = embed(params["embed"], tokens, dtype, cfg.onehot_embed)
        x = x + params["dec_pos"][:s][None].to(dtype)
        x, _ = _decoder_with_cross(params, x, cfg, positions, cross_kv,
                                   None, None, dtype)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    else:
        x = _embed_inputs(params, tokens, cfg, frontend_embeds, dtype)
        x, _, aux = tfm.apply_stack(params["stack"], x, cfg, positions,
                                    dtype=dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits, aux


def loss_fn(params, batch: dict, cfg):
    """Next-token cross entropy (+ 0.01 x the aux loss).  ``batch``:
    ``tokens`` [B, S] (+ optional ``loss_mask`` and ``frontend_embeds``;
    without a ``loss_mask`` an early-fusion decoder scores no target
    below ``frontend_seq``).  Returns (loss, metrics) with ``loss``,
    ``ce``, ``aux`` and ``tokens`` (the masked target count).  Inside a
    training step on a mesh (:func:`~repro_torch.distributed.autoshard.
    global_batch`) ``batch`` is this rank's rows: the count and the
    metrics are the global batch's, and the loss returned is this rank's
    share of the global one (the aux over the dp size).  In a
    tensor-parallel step whose logits are the rank's vocabulary block
    (:func:`vocab_split`) the cross entropy is :func:`vocab_nll`'s."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg,
                          frontend_embeds=batch.get("frontend_embeds"))
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1]
    if vocab_split(params, cfg):
        nll = vocab_nll(lg, targets)
    else:
        logz = torch.logsumexp(lg, dim=-1)
        tgt_logit = torch.take_along_dim(lg, targets[..., None],
                                         dim=-1)[..., 0]
        nll = logz - tgt_logit
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
        if cfg.frontend != "none" and not cfg.is_encdec:
            pos = torch.arange(targets.shape[1], device=targets.device)
            mask = mask * (pos >= cfg.frontend_seq)[None, :]
    else:
        mask = mask[:, 1:].to(torch.float32)
    stats = batch_stats()
    if stats is None:
        denom = torch.clamp_min(mask.sum(), 1.0)
        ce = (nll * mask).sum() / denom
        loss = ce + 0.01 * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": denom}
    # a rank's rows of the global batch: its nll sum over the global
    # count, so the ranks' gradients sum to the global loss's.  The MoE
    # aux is the global batch's on every rank (models/moe.py), so each
    # adds its share: the dp ranks' shares sum to it once
    denom = torch.clamp_min(stats.sum(mask.sum()), 1.0)
    part = (nll * mask).sum() / denom
    ce = stats.sum(part.detach())
    return part + 0.01 * aux / stats.size, {"loss": ce + 0.01 * aux,
                                            "ce": ce, "aux": aux,
                                            "tokens": denom}


# ---------------------------------------------------------------- serving

class DecodeCache(NamedTuple):
    layers: Any
    pos: torch.Tensor                   # per-slot next write position [B]
    # whisper: (k, v) [L, B, S_enc, KV, D], D the rank's head-dim slice
    # where a decode step's cross-attention is "d"
    cross_kv: Any = None


def init_cache(cfg, batch: int, s_max: int, device="cuda") -> DecodeCache:
    """An empty cache.  For an encoder-decoder model it also holds zero
    cross keys and values at full batch width (the reference's holds
    none), so a batcher's live cache has a place to splice each admitted
    slot's encoder output into.  On a serving mesh its KV caches and
    cross keys and values hold what the rank serves
    (``attention.kv_cache_dims``, ``attention.cross_kv_dims``), and its
    SSM and LRU states the rank's share (``ssm.state_dims``,
    ``rglru.state_width``)."""
    dtype = _dtype(cfg)
    layers = tfm.init_stack_cache(cfg, batch, s_max, dtype, device)
    cross_kv = None
    if cfg.is_encdec:
        shape = (cfg.n_layers, batch, cfg.frontend_seq) + \
            attn_mod.cross_kv_dims(cfg)
        cross_kv = tuple(torch.zeros(shape, dtype=dtype, device=device)
                         for _ in range(2))
    return DecodeCache(layers, torch.zeros(batch, dtype=torch.int64,
                                           device=device), cross_kv)


def prefill(params, tokens: torch.Tensor, cfg, s_max: Optional[int] = None,
            frontend_embeds=None, pad_mask: Optional[torch.Tensor] = None):
    """Run the full prompt; returns (last-position logits [B, V],
    DecodeCache).  ``frontend_embeds`` [B, F, d]: an early-fusion
    decoder's leading positions, or whisper's encoder input (zeros when
    none are given; the cache then carries every decoder layer's cross
    keys and values, in the layout a rank's decode cache holds them:
    ``attention.cross_kv_layout``).  ``pad_mask`` ([B, S] bool, True =
    real token) admits LEFT-padded prompts: pads are masked out of attention,
    positions are the true token indices, the cache is written
    left-aligned and ``cache.pos`` carries each row's true length.  MoE
    expert capacity is shared by every token of the batch, pads included,
    so under a tight ``moe_capacity_factor`` a padded prefill may drop
    other tokens than an unpadded one (as in the reference)."""
    from repro_torch.accel import pad_positions

    dtype = _dtype(cfg)
    b, s = tokens.shape
    if s_max is None:
        s_max = s
    if pad_mask is not None:
        pad_mask = pad_mask.to(torch.bool)
        positions = torch.clamp_min(torch.cumsum(pad_mask, dim=1) - 1, 0)
        pos_out = pad_mask.sum(dim=1)
    else:
        positions = torch.arange(s, device=tokens.device)
        pos_out = torch.full((b,), s, dtype=torch.int64, device=tokens.device)
    layers = tfm.init_stack_cache(cfg, b, s_max, dtype, tokens.device)
    # the pad scope covers the encoder too, as the reference's does; its
    # shape test ignores the mask there unless S equals frontend_seq
    scope = (pad_positions(pad_mask) if pad_mask is not None
             else contextlib.nullcontext())
    with scope:
        if cfg.is_encdec:
            cross_kv = _encoder_kv(params, frontend_embeds, cfg, b, dtype,
                                   tokens.device)
            x = embed(params["embed"], tokens, dtype, cfg.onehot_embed)
            pos_emb = (params["dec_pos"][positions] if pad_mask is not None
                       else params["dec_pos"][:s][None])
            x = x + pos_emb.to(dtype)
            x, layers = _decoder_with_cross(params, x, cfg, positions,
                                            cross_kv, layers, None, dtype,
                                            pad_mask=pad_mask)
        else:
            cross_kv = None
            x = _embed_inputs(params, tokens, cfg, frontend_embeds, dtype)
            x, layers, _ = tfm.apply_stack(params["stack"], x, cfg,
                                           positions, layers, dtype=dtype,
                                           pad_mask=pad_mask)
        x = norm(params["final_norm"], x[:, -1:], cfg.norm)
        logits = _lm_logits(params, x, cfg, dtype)
    if cross_kv is not None:
        cross_kv = tuple(attn_mod.cross_kv_layout(t, cfg) for t in cross_kv)
    return logits[:, 0], DecodeCache(layers, pos_out, cross_kv)


def decode_step(params, token: torch.Tensor, cache: DecodeCache, cfg):
    """One decode step.  token: [B] int.  Returns (logits [B, V], cache);
    ``cache.pos`` is per slot (a scalar is broadcast)."""
    dtype = _dtype(cfg)
    b = token.shape[0]
    pos = torch.as_tensor(cache.pos, dtype=torch.int64, device=token.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    x = embed(params["embed"], token[:, None], dtype, cfg.onehot_embed)
    if cfg.is_encdec:
        x = x + params["dec_pos"][pos][:, None].to(dtype)
        x, layers = _decoder_with_cross(params, x, cfg, pos[:, None],
                                        cache.cross_kv, cache.layers, pos,
                                        dtype)
    else:
        x, layers, _ = tfm.apply_stack(params["stack"], x, cfg, pos[:, None],
                                       cache.layers, cache_pos=pos,
                                       dtype=dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits[:, 0], DecodeCache(layers, pos + 1, cache.cross_kv)


def prefill_resume(params, tokens: torch.Tensor, cfg, cache: DecodeCache):
    """Continue a prefill: run ``tokens`` [B, S] (dense, no padding) on top
    of ``cache``, starting at each row's ``cache.pos``.  The S new keys are
    written at their absolute per-row positions (in place, as every cache
    write of the port) and attend causally over the whole cache.  Returns
    (last-position logits [B, V], cache with ``pos + S``).  Encoder-decoder
    models are refused, as in the reference: their encoder runs whole in
    :func:`prefill`.

    Against a full prefill of the same tokens this is ``allclose``, not
    bitwise: the attention over the cache sums in another order."""
    if cfg.is_encdec:
        raise NotImplementedError(
            "chunked prefill is not supported for encoder-decoder archs")
    dtype = _dtype(cfg)
    b, s = tokens.shape
    pos = torch.as_tensor(cache.pos, dtype=torch.int64, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    positions = pos[:, None] + torch.arange(s, device=tokens.device)[None, :]
    x = embed(params["embed"], tokens, dtype, cfg.onehot_embed)
    x, layers, _ = tfm.apply_stack(params["stack"], x, cfg, positions,
                                   cache.layers, cache_pos=pos, dtype=dtype)
    x = norm(params["final_norm"], x[:, -1:], cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits[:, 0], DecodeCache(layers, pos + s, cache.cross_kv)


# ------------------------------------------------- per-slot cache splicing

def _map_slot(fn, caches):
    """``fn(batch_axis, *leaves)`` over one or more ``DecodeCache.layers``
    trees (KV caches, SSM and LRU states): prefix/suffix block caches
    carry the batch at axis 0, stacked ``"scanned"`` caches at axis 1."""
    return {part: tree_map(functools.partial(fn, 1 if part == "scanned"
                                              else 0),
                            *[c[part] for c in caches])
            for part in ("prefix", "scanned", "suffix")}


def slice_slot(cache: DecodeCache, i: int) -> DecodeCache:
    """Batch slot ``i`` of ``cache`` as a batch-1 cache (a copy: writes to
    either cache do not reach the other), whisper's ``cross_kv`` (batch at
    axis 1) included."""
    layers = _map_slot(lambda axis, leaf: leaf.narrow(axis, i, 1).clone(),
                       (cache.layers,))
    ckv = (None if cache.cross_kv is None else
           tuple(t.narrow(1, i, 1).clone() for t in cache.cross_kv))
    return DecodeCache(layers, cache.pos[i:i + 1].clone(), ckv)


def splice_slot(cache: DecodeCache, slot: DecodeCache, i: int
                ) -> DecodeCache:
    """Write the batch-1 ``slot`` cache into batch slot ``i`` of the live
    ``cache`` IN PLACE (the reference's donated jit does the same) and
    return it, whisper's ``cross_kv`` included.  The other slots are
    untouched, which is what lets one finished slot be retired and
    refilled while the rest keep decoding."""
    def put(axis, dst, src):
        dst.narrow(axis, i, 1).copy_(src)
        return dst

    layers = _map_slot(put, (cache.layers, slot.layers))
    cache.pos[i:i + 1] = slot.pos.to(cache.pos.dtype)
    if cache.cross_kv is not None:
        for dst, src in zip(cache.cross_kv, slot.cross_kv):
            put(1, dst, src)
    return DecodeCache(layers, cache.pos, cache.cross_kv)
