"""Foundational model layers.  Port of ``repro.models.layers``.

Every weight-bearing projection goes through :func:`linear`, which
dispatches via :func:`repro_torch.accel.matmul` under the ``ExecSpec``
its caller resolved from the arch config's policy.  ``spec=None`` marks
projections that are digital by design.  Master parameters are float32;
digital compute casts to the activation dtype, quantized backends
compute in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.accel import ExecSpec, Postreduce, matmul as accel_matmul
from repro_torch.accel.shard import rank_columns
from repro_torch.distributed.autoshard import get_mesh
from repro_torch.core.datapath import ACTIVATIONS


def truncated_normal_init(gen: torch.Generator, shape, stddev: float,
                          device) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev)


def init_linear(gen, d_in: int, d_out: int, device, lead: tuple = (),
                bias: bool = False, stddev: Optional[float] = None) -> dict:
    """A linear layer's params; ``lead`` prepends stacked-copy axes."""
    if stddev is None:
        stddev = d_in ** -0.5
    p = {"w": truncated_normal_init(gen, lead + (d_in, d_out), stddev, device)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=torch.float32,
                             device=device)
    return p


def linear(params: dict, x: torch.Tensor, spec: Optional[ExecSpec] = None,
           dtype=torch.bfloat16, post: Optional[Postreduce] = None,
           local: Optional[str] = None) -> torch.Tensor:
    """x @ w (+ b) through the configured backend.  An installed image
    (key ``"cima"``) rides into dispatch.  A linear bias folds into the
    datapath's bias registers pre-scale, so the fused projection still
    computes ``post((x @ w) + b)``.  ``local`` asks dispatch for a local
    form of a mesh tile (:func:`repro_torch.accel.matmul`); on a local
    column output the plain bias adds the rank's columns."""
    if post is not None and "b" in params:
        b = params["b"]
        pb = b if post.scale is None else b * post.scale
        if post.bias is not None:
            pb = pb + post.bias
        post = dataclasses.replace(post, bias=pb)
    y = accel_matmul(x, params["w"], spec, dtype=dtype,
                     image=params.get("cima"), post=post,
                     local=local).to(dtype)
    if "b" in params and post is None:
        b = params["b"]
        if local == "col":
            b = rank_columns(b, get_mesh())
        y = y + b.to(y.dtype)
    return y


def init_norm(d: int, kind: str, device, lead: tuple = ()) -> dict:
    if kind == "rms":
        return {"scale": torch.ones(lead + (d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(lead + (d,), device=device),
                "bias": torch.zeros(lead + (d,), device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def norm(params: dict, x: torch.Tensor, kind: str,
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * params["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


def init_embedding(gen, vocab: int, d: int, device) -> dict:
    # d**-0.5 keeps tied-head logits at unit variance
    return {"table": truncated_normal_init(gen, (vocab, d), d ** -0.5, device)}


def embed(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16,
          onehot: bool = False) -> torch.Tensor:
    """Token embeddings.  ``onehot`` (``cfg.onehot_embed``) takes them as
    the reference's perf knob does, one-hot rows times the cast table: a
    dot of ``2 * tokens * vocab * d`` FLOPs in place of a gather, the
    same values."""
    table = params["table"]
    if onehot:
        vocab = torch.arange(table.shape[0], device=tokens.device)
        return (tokens[..., None] == vocab).to(dtype) @ table.to(dtype)
    # gather, then cast: the same values as casting the whole table first
    return table[tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor, spec: Optional[ExecSpec] = None,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Tied LM head: x @ table.T, a static-weight MVM whose image installs
    under ``"cima"`` in the embed dict."""
    return accel_matmul(x, params["table"].T, spec, dtype=dtype,
                        image=params.get("cima")).to(torch.float32)


# ---------------------------------------------------------------- rotary

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even), positions: [B, S] or [S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP

def init_mlp(gen, cfg, device, lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"gate": init_linear(gen, d, f, device, lead),
                "up": init_linear(gen, d, f, device, lead),
                "down": init_linear(gen, f, d, device, lead)}
    return {"up": init_linear(gen, d, f, device, lead),
            "down": init_linear(gen, f, d, device, lead)}


def mlp(params: dict, x: torch.Tensor, cfg, dtype=torch.bfloat16,
        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLP block.  With ``cfg.fuse_datapath`` (default) the nonlinearity
    rides the gate/up projection as a fused ``Postreduce(act=...)`` and a
    ``residual`` stream rides the down projection's bias port.  Returns
    ``residual + mlp(x)`` when ``residual`` is given."""
    act = ACTIVATIONS[cfg.act]
    sp = cfg.policy.resolver("mlp")
    fuse = getattr(cfg, "fuse_datapath", True)
    act_post = Postreduce(act=cfg.act) if fuse else None
    if "gate" in params:
        g = linear(params["gate"], x, sp("mlp.gate"), dtype, post=act_post)
        h = (g if fuse else act(g)) * linear(params["up"], x, sp("mlp.up"),
                                             dtype)
    else:
        u = linear(params["up"], x, sp("mlp.up"), dtype, post=act_post)
        h = u if fuse else act(u)
    res_post = (Postreduce(bias=residual)
                if fuse and residual is not None else None)
    y = linear(params["down"], h, sp("mlp.down"), dtype, post=res_post)
    if residual is not None and res_post is None:
        y = residual + y
    return y
