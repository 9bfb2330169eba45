"""Model API for the decoder families the port runs: dense (GQA, local
windows), hybrid RG-LRU (recurrentgemma), SSM (mamba2) and MoE with MLA
(deepseek-v2).  Port of ``repro.models.model``; encoder-decoder and
frontend models raise ``NotImplementedError``.

* ``init_params(cfg, gen, device)``   — the parameter tree (same nested
  dict keys as the reference, stacked ``"scanned"`` layer leaves).
* ``forward / loss_fn`` — full-sequence logits and the next-token loss
  (training; ``cfg.remat`` checkpoints each layer under autograd).
* ``init_cache / prefill / decode_step`` — serving with a KV cache.
* ``prefill_resume`` — continue a prefill on top of a cache.
* ``slice_slot / splice_slot`` — per-slot cache surgery for slot-level
  continuous batching.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.tree import tree_map

from . import transformer as tfm
from .layers import (embed, init_embedding, init_linear, init_norm, linear,
                     norm, unembed)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _supported(cfg) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; they "
            "come with the encoder-decoder slice of the port")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} frontend models are not ported "
            "yet; they come with the frontend slice of the port")


# ---------------------------------------------------------------- params

def init_params(cfg, gen: Union[torch.Generator, int] = 0,
                device="cuda") -> dict:
    """Random parameters (float32 masters) drawn from ``gen`` — a
    ``torch.Generator`` on ``device`` or an integer seed for one."""
    _supported(cfg)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    p: dict = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        "stack": tfm.init_stack(gen, cfg, device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, device)
    return p


def _lm_logits(params, x, cfg, dtype):
    """Final projection to vocab — a static-weight MVM (path ``unembed``),
    tied or untied."""
    spec = cfg.policy.resolve("unembed", kind="unembed")
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, spec, dtype)
    return linear(params["lm_head"], x, spec, dtype).to(torch.float32)


# ---------------------------------------------------------------- training

def forward(params, tokens: torch.Tensor, cfg):
    """Full-sequence logits [B, S, vocab] (training / teacher forcing) and
    the MoE blocks' summed auxiliary loss (0 without MoE blocks)."""
    _supported(cfg)
    dtype = _dtype(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params["embed"], tokens, dtype)
    x, _, aux = tfm.apply_stack(params["stack"], x, cfg, positions,
                                dtype=dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits, aux


def loss_fn(params, batch: dict, cfg):
    """Next-token cross entropy (+ 0.01 x the aux loss).  ``batch``:
    ``tokens`` [B, S] (+ optional ``loss_mask``).  Returns (loss,
    metrics) with ``loss``, ``ce``, ``aux`` and ``tokens`` (the masked
    target count)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg)
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    tgt_logit = torch.take_along_dim(lg, targets[..., None], dim=-1)[..., 0]
    nll = logz - tgt_logit
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(targets, dtype=torch.float32) if mask is None
            else mask[:, 1:].to(torch.float32))
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = (nll * mask).sum() / denom
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------- serving

class DecodeCache(NamedTuple):
    layers: Any
    pos: torch.Tensor                   # per-slot next write position [B]
    cross_kv: Any = None


def init_cache(cfg, batch: int, s_max: int, device="cuda") -> DecodeCache:
    _supported(cfg)
    layers = tfm.init_stack_cache(cfg, batch, s_max, _dtype(cfg), device)
    return DecodeCache(layers, torch.zeros(batch, dtype=torch.int64,
                                           device=device), None)


def prefill(params, tokens: torch.Tensor, cfg, s_max: Optional[int] = None,
            pad_mask: Optional[torch.Tensor] = None):
    """Run the full prompt; returns (last-position logits [B, V],
    DecodeCache).  ``pad_mask`` ([B, S] bool, True = real token) admits
    LEFT-padded prompts: pads are masked out of attention, positions are
    the true token indices, the cache is written left-aligned and
    ``cache.pos`` carries each row's true length.  MoE expert capacity is
    shared by every token of the batch, pads included, so under a tight
    ``moe_capacity_factor`` a padded prefill may drop other tokens than
    an unpadded one (as in the reference)."""
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
    cache = init_cache(cfg, b, s_max, tokens.device)
    x = embed(params["embed"], tokens, dtype)
    scope = (pad_positions(pad_mask) if pad_mask is not None
             else contextlib.nullcontext())
    with scope:
        x, layers, _ = tfm.apply_stack(params["stack"], x, cfg, positions,
                                       cache.layers, dtype=dtype,
                                       pad_mask=pad_mask)
    x = norm(params["final_norm"], x[:, -1:], cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits[:, 0], DecodeCache(layers, pos_out, None)


def decode_step(params, token: torch.Tensor, cache: DecodeCache, cfg):
    """One decode step.  token: [B] int.  Returns (logits [B, V], cache);
    ``cache.pos`` is per slot (a scalar is broadcast)."""
    dtype = _dtype(cfg)
    b = token.shape[0]
    pos = torch.as_tensor(cache.pos, dtype=torch.int64, device=token.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    x = embed(params["embed"], token[:, None], dtype)
    x, layers, _ = tfm.apply_stack(params["stack"], x, cfg, pos[:, None],
                                   cache.layers, cache_pos=pos, dtype=dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits[:, 0], DecodeCache(layers, pos + 1, cache.cross_kv)


def prefill_resume(params, tokens: torch.Tensor, cfg, cache: DecodeCache):
    """Continue a prefill: run ``tokens`` [B, S] (dense, no padding) on top
    of ``cache``, starting at each row's ``cache.pos``.  The S new keys are
    written at their absolute per-row positions (in place, as every cache
    write of the port) and attend causally over the whole cache.  Returns
    (last-position logits [B, V], cache with ``pos + S``).

    Against a full prefill of the same tokens this is ``allclose``, not
    bitwise: the attention over the cache sums in another order."""
    _supported(cfg)
    dtype = _dtype(cfg)
    b, s = tokens.shape
    pos = torch.as_tensor(cache.pos, dtype=torch.int64, device=tokens.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    positions = pos[:, None] + torch.arange(s, device=tokens.device)[None, :]
    x = embed(params["embed"], tokens, dtype)
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
    either cache do not reach the other)."""
    layers = _map_slot(lambda axis, leaf: leaf.narrow(axis, i, 1).clone(),
                       (cache.layers,))
    return DecodeCache(layers, cache.pos[i:i + 1].clone(), None)


def splice_slot(cache: DecodeCache, slot: DecodeCache, i: int
                ) -> DecodeCache:
    """Write the batch-1 ``slot`` cache into batch slot ``i`` of the live
    ``cache`` IN PLACE (the reference's donated jit does the same) and
    return it.  The other slots are untouched, which is what lets one
    finished slot be retired and refilled while the rest keep decoding."""
    def put(axis, dst, src):
        dst.narrow(axis, i, 1).copy_(src)
        return dst

    layers = _map_slot(put, (cache.layers, slot.layers))
    cache.pos[i:i + 1] = slot.pos.to(cache.pos.dtype)
    return DecodeCache(layers, cache.pos, cache.cross_kv)
