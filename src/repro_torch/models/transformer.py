"""Decoder blocks and stacked layers.  Port of
``repro.models.transformer`` for block kinds ``"attn"``, ``"moe"`` (an
attention or MLA mixer before a mixture-of-experts FFN), ``"rec"``
(RG-LRU) and ``"ssm"`` (Mamba2).

The reference compiles a stack with ``lax.scan`` over stacked layer
parameters; here :func:`apply_stack` loops over the leading layer dim of
the stacked ``"scanned"`` leaves (images and caches included), so every
layer dispatches, and records, on its own.  ``cfg.remat`` checkpoints
each stacked layer when autograd records the pass; the recomputation
replays the layer's dispatch-time overrides and ADC-noise counter, as
``jax.checkpoint`` replays the reference's folded keys.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.accel import CimaImage
from repro_torch.accel import context as accel_context
from repro_torch.tree import leaves

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import init_mlp, init_norm, mlp, norm


def _kind_check(kind: str) -> None:
    if kind not in ("attn", "moe", "rec", "ssm"):
        raise ValueError(f"unknown block kind {kind!r}")


def init_block(gen, cfg, kind: str, device, lead: tuple = ()) -> dict:
    """One block's params; ``lead`` prepends stacked-layer axes."""
    _kind_check(kind)
    p = {"ln1": init_norm(cfg.d_model, cfg.norm, device, lead)}
    if kind in ("attn", "moe"):
        p["attn"] = (attn_mod.init_mla(gen, cfg, device, lead) if cfg.mla
                     else attn_mod.init_attention(gen, cfg, device, lead))
    elif kind == "rec":
        p["rec"] = rglru_mod.init_rglru(gen, cfg, device, lead)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device, lead)
        return p                       # mamba blocks have no separate MLP
    p["ln2"] = init_norm(cfg.d_model, cfg.norm, device, lead)
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, device, lead)
    return p


def init_block_cache(cfg, kind: str, batch: int, s_max: int, dtype, device,
                     lead: tuple = ()):
    _kind_check(kind)
    if kind == "rec":
        return rglru_mod.init_lru_state(cfg, batch, dtype, device, lead)
    if kind == "ssm":
        return ssm_mod.init_ssm_state(cfg, batch, dtype, device, lead)
    if cfg.mla:
        return attn_mod.init_mla_cache(cfg, batch, s_max, dtype, device, lead)
    return attn_mod.init_kv_cache(cfg, batch, s_max, dtype, device, lead)


def _store(cache, new):
    """Write a recurrent mixer's new state into ``cache`` in place (every
    cache write of the port is in place) and return the cache."""
    if cache is None:
        return None
    for dst, src in zip(cache, new):
        dst.copy_(src)
    return cache


def apply_block(params: dict, x, cfg, kind: str, positions, cache=None,
                cache_pos=None, dtype=torch.bfloat16, pad_mask=None):
    """Returns (x, cache, aux_loss); ``aux_loss`` is None but for a MoE
    block (the reference's zeros, which add nothing)."""
    _kind_check(kind)
    # single-step decode for the recurrent mixers; a multi-token call with
    # cache_pos (a resumed prefill) runs their sequence path seeded from
    # the carried state instead
    decode = cache_pos is not None and x.shape[1] == 1
    h = norm(params["ln1"], x, cfg.norm)
    if kind in ("attn", "moe"):
        fn = attn_mod.mla_attention if cfg.mla else attn_mod.attention
        mix, cache = fn(params["attn"], h, cfg, positions, cache, cache_pos,
                        dtype, pad_mask=pad_mask)
    elif kind == "rec":
        mix, new = rglru_mod.rglru_forward(params["rec"], h, cfg, cache,
                                           decode, dtype, pad_mask=pad_mask)
        cache = _store(cache, new)
    else:
        mix, new = ssm_mod.ssm_forward(params["ssm"], h, cfg, cache, decode,
                                       dtype, pad_mask=pad_mask)
        return x + mix, _store(cache, new), None
    x = x + mix
    h2 = norm(params["ln2"], x, cfg.norm)
    if kind == "moe":
        ff, aux = moe_mod.moe_ffn(params["moe"], h2, cfg, dtype)
        return x + ff, cache, aux
    # the residual stream rides the down projection's fused datapath
    # epilogue (bias port) instead of a separate add
    return mlp(params["mlp"], h2, cfg, dtype, residual=x), cache, None


class StackLayout(NamedTuple):
    prefix: tuple          # block kinds applied individually first
    unit: tuple            # repeating unit, stacked
    n_rep: int
    suffix: tuple          # trailing ragged layers


def stack_layout(cfg) -> StackLayout:
    pattern = cfg.pattern()
    k = cfg.first_k_dense if cfg.moe else 0
    prefix, rest = pattern[:k], pattern[k:]
    unit = cfg.block_pattern if cfg.block_pattern else (rest[0],) if rest else ()
    n_rep = len(rest) // len(unit) if unit else 0
    suffix = rest[n_rep * len(unit):]
    if not cfg.scan_layers:
        return StackLayout(pattern, (), 0, ())
    return StackLayout(prefix, unit, n_rep, suffix)


def init_stack(gen, cfg, device) -> dict:
    layout = stack_layout(cfg)
    return {
        "prefix": [init_block(gen, cfg, k, device) for k in layout.prefix],
        "scanned": {f"u{j}": init_block(gen, cfg, kind, device,
                                        (layout.n_rep,))
                    for j, kind in enumerate(layout.unit)},
        "suffix": [init_block(gen, cfg, k, device) for k in layout.suffix],
    }


def init_stack_cache(cfg, batch: int, s_max: int, dtype, device) -> dict:
    layout = stack_layout(cfg)

    def one(kind, lead=()):
        return init_block_cache(cfg, kind, batch, s_max, dtype, device, lead)

    return {"prefix": [one(k) for k in layout.prefix],
            "scanned": {f"u{j}": one(kind, (layout.n_rep,))
                        for j, kind in enumerate(layout.unit)},
            "suffix": [one(k) for k in layout.suffix]}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: every tensor, image and cache leaf
    indexed on its leading axis (views, not copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, CimaImage):
        return tree.layer(i)
    if isinstance(tree, tuple):          # KVCache, SSMState, LRUState
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def _remat(cfg, params: dict, x, cache) -> bool:
    """Checkpoint the stacked layers (``cfg.remat``, the reference's
    ``jax.checkpoint`` around its scan body): only when autograd records
    this pass, and never on a cached (serving) pass."""
    return (cfg.remat and cache is None and torch.is_grad_enabled()
            and (x.requires_grad
                 or any(t.requires_grad for t in leaves(params))))


def _checkpointed(fn, x):
    """``fn(x)`` under ``torch.utils.checkpoint``.  The body runs under
    the overrides and from the ADC-noise counter in effect now, in the
    forward and again in the backward's recomputation (which may run
    after those scopes closed), so the recomputed layer sees the same
    specs and draws the same noise; after the forward the live noise
    scope's counter moves on past the layer's draws."""
    snap = accel_context.snapshot()
    end = [None]

    def body(x_):
        with accel_context.replay(snap) as frame:
            y = fn(x_)
        end[0] = frame[1] if frame is not None else None
        return y

    y = checkpoint(body, x, use_reentrant=False)
    if end[0] is not None:
        accel_context.advance_noise(end[0])
    return y


def apply_stack(params: dict, x, cfg, positions, cache: Optional[dict] = None,
                cache_pos=None, dtype=torch.bfloat16, pad_mask=None):
    """Returns (x, cache, aux_loss); the cache (when given) is updated in
    place, and the MoE blocks' aux losses add up in the reference's order
    (prefix, stacked layers, suffix) from a float32 zero.  Under
    ``cfg.remat`` and autograd each stacked layer is a
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward pass (so its projections launch again there, drawing the
    noise they drew in the forward)."""
    layout = stack_layout(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(kind, p, x, c):
        return apply_block(p, x, cfg, kind, positions, c, cache_pos, dtype,
                           pad_mask=pad_mask)

    def add(total, aux):
        return total if aux is None else total + aux

    remat = _remat(cfg, params["scanned"], x, cache)
    for i, kind in enumerate(layout.prefix):
        x, _, aux = run(kind, params["prefix"][i], x,
                        cache["prefix"][i] if cache is not None else None)
        aux_total = add(aux_total, aux)
    for layer in range(layout.n_rep):
        for j, kind in enumerate(layout.unit):
            key = f"u{j}"
            p = layer_slice(params["scanned"][key], layer)
            if remat:
                x, aux = _checkpointed(
                    lambda x_, p_=p, k_=kind: _no_cache(run(k_, p_, x_, None)),
                    x)
            else:
                c = (layer_slice(cache["scanned"][key], layer)
                     if cache is not None else None)
                x, _, aux = run(kind, p, x, c)
            aux_total = add(aux_total, aux)
    for i, kind in enumerate(layout.suffix):
        x, _, aux = run(kind, params["suffix"][i], x,
                        cache["suffix"][i] if cache is not None else None)
        aux_total = add(aux_total, aux)
    return x, cache, aux_total


def _no_cache(out):
    """A checkpointed block's outputs: (x, aux) without the (absent)
    cache."""
    x, _, aux = out
    return x, aux
