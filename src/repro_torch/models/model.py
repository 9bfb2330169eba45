"""Model API for the dense decoder path.  Port of ``repro.models.model``.

* ``init_params(cfg, gen, device)``   — the parameter tree (same nested
  dict keys as the reference, stacked ``"scanned"`` layer leaves).
* ``init_cache / prefill / decode_step`` — serving with a KV cache.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Union

import torch

from . import transformer as tfm
from .layers import (embed, init_embedding, init_linear, init_norm, linear,
                     norm, unembed)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _supported(cfg) -> None:
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend models are not "
            "ported yet")


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
    ``cache.pos`` carries each row's true length."""
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
        x, layers = tfm.apply_stack(params["stack"], x, cfg, positions,
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
    x, layers = tfm.apply_stack(params["stack"], x, cfg, pos[:, None],
                                cache.layers, cache_pos=pos, dtype=dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    logits = _lm_logits(params, x, cfg, dtype)
    return logits[:, 0], DecodeCache(layers, pos + 1, cache.cross_kv)
