"""Foundational model layers.  Port of ``repro.models.layers``.

Every weight-bearing projection goes through :func:`linear`, which
dispatches via :func:`repro_torch.accel.matmul` under the ``ExecSpec``
its caller resolved from the arch config's policy.  ``spec=None`` marks
projections that are digital by design.  Master parameters are float32;
digital compute casts to the activation dtype, quantized backends
compute in float32.

Inside a tensor-parallel training step (``distributed.autoshard.
tp_mesh``) each weight is the rank's ``"model"`` slice under the state
specs: a column-parallel projection runs as the rank's column tile
(``linear(..., tile="col")``, its input replicated and its output the
rank's columns), a row-parallel one through :func:`row_linear` (the
Megatron row tile where its bits are the unsharded call's, else the
column form; the output whole), the embedding on the rank's vocabulary block
(:func:`embed`, summed over ``"model"``) and the tied head as its
column tile (:func:`unembed`); a table the axis does not divide is used
whole.  The MLP's gate and up are column tiles and its down the
row-parallel projection, the residual riding its bias port once, after
the reduce.  A leaf a rank uses only part of (a mixer's conv weight and
1-D parameters) is made whole by :func:`shared_leaf`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tally
from repro_torch.accel import ExecSpec, Postreduce, matmul as accel_matmul
from repro_torch.accel.context import current_override
from repro_torch.accel.shard import rank_columns
from repro_torch.accel.train_shard import row_form_ok
from repro_torch.distributed.autoshard import (gather, get_mesh, reduce,
                                               sum_grad, tp_mesh, train_mesh)
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
           local: Optional[str] = None,
           tile: Optional[str] = None) -> torch.Tensor:
    """x @ w (+ b) through the configured backend.  An installed image
    (key ``"cima"``) rides into dispatch.  A linear bias folds into the
    datapath's bias registers pre-scale, so the fused projection still
    computes ``post((x @ w) + b)``.  ``local`` asks dispatch for a local
    form of a mesh tile, ``tile`` for a tensor-parallel training step's
    tile of a weight slice (:func:`repro_torch.accel.matmul`); on a
    column output of the rank the plain bias adds the rank's columns."""
    if post is not None and "b" in params:
        b = params["b"]
        pb = b if post.scale is None else b * post.scale
        if post.bias is not None:
            pb = pb + post.bias
        post = dataclasses.replace(post, bias=pb)
    y = accel_matmul(x, params["w"], spec, dtype=dtype,
                     image=params.get("cima"), post=post,
                     local=local, tile=tile).to(dtype)
    if "b" in params and post is None:
        b = params["b"]
        if local == "col":
            b = rank_columns(b, get_mesh())
        elif tile == "col":
            b = rank_columns(b, tp_mesh())
        y = y + b.to(y.dtype)
    return y


def _effective(spec: Optional[ExecSpec]) -> Optional[ExecSpec]:
    """``spec`` under the scoped overrides, as dispatch resolves it."""
    ov = current_override() if spec is not None else None
    return dataclasses.replace(spec, **ov) if ov else spec


def replicated(x: torch.Tensor, spec: Optional[ExecSpec]) -> torch.Tensor:
    """A replicated activation as the input of one projection under
    ``spec`` in a tensor-parallel training step, whose gradient (the
    projection's partial ``dx``, from the rank's share) is summed over
    ``"model"`` (:func:`~repro_torch.distributed.autoshard.sum_grad`).
    On a quantizing backend ``x`` is taken in float32, so the
    straight-through ``dx`` (float32) is summed before autograd casts it
    to ``x``'s dtype and adds the other projections': the unsharded
    step's order, each projection's ``dx`` rounded once.  A digital
    GEMM's ``dx`` already is ``x``'s dtype, and is summed in it."""
    eff = _effective(spec)
    if eff is not None and not eff.is_digital:
        x = x.to(torch.float32)
    return sum_grad(x, "model")


def shared_leaf(t: torch.Tensor, n: int) -> torch.Tensor:
    """A parameter leaf of which a tensor-parallel rank uses only the part
    its share needs (a mixer's conv weight, its 1-D parameters), whole
    on the rank: its ``"model"`` slice gathered where its spec splits it
    (fewer than ``n`` entries on the last dim), else the replicated leaf
    as it is.  Either way the backward sums the ranks' partial gradients
    over ``"model"``, so every rank's copy is the whole gradient."""
    if int(t.shape[-1]) == n:
        return sum_grad(t, "model")
    return gather(t, "model", t.ndim - 1, partial=True)


def row_linear(params: dict, x: torch.Tensor,
               spec: Optional[ExecSpec] = None, dtype=torch.bfloat16,
               post: Optional[Postreduce] = None,
               block: bool = True) -> torch.Tensor:
    """A row-parallel projection (``wo``, ``down``) in a tensor-parallel
    training step: ``params["w"]`` is the rank's rows ``[N/m, M]`` and
    ``x`` the rank's N block of the input (``block``) or the whole,
    replicated input.  The output is whole and replicated.

    Where the rows are whole banks (:func:`~repro_torch.accel.
    train_shard.row_form_ok`) it is the Megatron row tile: the rank's
    block, its partial sums reduced over ``"model"``, then the rescale,
    the bias and ``post`` once.  Elsewhere it is the column form
    (``tile="col-form"``): the block's grid gathered whole, the weight's
    re-laid out as the rank's column tile, the rank's columns computed
    and gathered, ``post`` on the whole output.  Both give the unsharded
    call's bits on the quantizing backends, and both take the row tile's
    straight-through backward on the rank's block and rows."""
    mesh = tp_mesh()
    n_blk = int(params["w"].shape[-2])
    eff = _effective(spec)
    if not block:
        x = replicated(x, spec).narrow(-1, mesh.index("model") * n_blk,
                                       n_blk)
    form = "row" if eff is None or row_form_ok(eff, n_blk) else "col-form"
    return linear(params, x, spec, dtype, post, tile=form)


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
          onehot: bool = False, vocab: Optional[int] = None) -> torch.Tensor:
    """Token embeddings.  ``onehot`` (``cfg.onehot_embed``) takes them as
    the reference's perf knob does, one-hot rows times the cast table: a
    dot of ``2 * tokens * vocab * d`` FLOPs in place of a gather, the
    same values.  In a tensor-parallel training step the table is the
    rank's vocabulary block: the rank embeds the tokens it holds, zero
    elsewhere, and the blocks are summed over ``"model"`` (exact: one
    rank contributes each row); a table of all ``vocab`` rows, which the
    axis does not divide, is used whole."""
    table = params["table"]
    mesh = tp_mesh()
    if mesh is not None and table.shape[0] == vocab:
        mesh = None
    if tally.ACTIVE and train_mesh() is not None:
        tally.report_form("embed", "whole" if mesh is None else "vocab")
    if mesh is not None:
        v = table.shape[0]
        lo = mesh.index("model") * v
        if onehot:
            ids = torch.arange(lo, lo + v, device=tokens.device)
            return reduce((tokens[..., None] == ids).to(dtype)
                          @ table.to(dtype))
        local = tokens.long() - lo
        mine = (local >= 0) & (local < v)
        rows = table[torch.where(mine, local, 0)].to(dtype)
        return reduce(torch.where(mine[..., None], rows,
                                  torch.zeros((), dtype=dtype,
                                              device=rows.device)))
    if onehot:
        vocab = torch.arange(table.shape[0], device=tokens.device)
        return (tokens[..., None] == vocab).to(dtype) @ table.to(dtype)
    # gather, then cast: the same values as casting the whole table first
    return table[tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor, spec: Optional[ExecSpec] = None,
            dtype=torch.bfloat16, tile: Optional[str] = None) -> torch.Tensor:
    """Tied LM head: x @ table.T, a static-weight MVM whose image installs
    under ``"cima"`` in the embed dict.  ``tile="col"`` in a
    tensor-parallel training step, where the table is the rank's
    vocabulary block: the rank's column tile of the head."""
    return accel_matmul(x, params["table"].T, spec, dtype=dtype,
                        image=params.get("cima"),
                        tile=tile).to(torch.float32)


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
    ``residual + mlp(x)`` when ``residual`` is given.  In a
    tensor-parallel training step the rank computes its columns of gate
    and up and its rows of down (:func:`row_linear`)."""
    act = ACTIVATIONS[cfg.act]
    sp = cfg.policy.resolver("mlp")
    fuse = getattr(cfg, "fuse_datapath", True)
    act_post = Postreduce(act=cfg.act) if fuse else None
    tp = tp_mesh() is not None
    tile = "col" if tp else None

    def inp(x, tag):
        return replicated(x, sp(tag)) if tp else x

    if "gate" in params:
        g = linear(params["gate"], inp(x, "mlp.gate"), sp("mlp.gate"), dtype,
                   post=act_post, tile=tile)
        h = (g if fuse else act(g)) * linear(
            params["up"], inp(x, "mlp.up"), sp("mlp.up"), dtype, tile=tile)
    else:
        u = linear(params["up"], inp(x, "mlp.up"), sp("mlp.up"), dtype,
                   post=act_post, tile=tile)
        h = u if fuse else act(u)
    res_post = (Postreduce(bias=residual)
                if fuse and residual is not None else None)
    down = row_linear if tp else linear
    y = down(params["down"], h, sp("mlp.down"), dtype, post=res_post)
    if residual is not None and res_post is None:
        y = residual + y
    return y
