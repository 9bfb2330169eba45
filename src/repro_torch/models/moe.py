"""Mixture-of-Experts with sort-based capacity dispatch.  Port of
``repro.models.moe``.

Tokens are packed into a dense per-expert buffer ``[E, C, d]`` (memory
O(T*k + E*C*d)), the expert FFN runs as three GROUPED ``accel.matmul``
calls over the E experts, each expert with its own quantization scales
and compiled images (the reference's ``jax.vmap`` over the experts; on
the kernel backend one grouped launch a projection), and the results
are gathered back to their tokens.  Top-k routing with optional shared
experts (deepseek-v2: 2 shared + 64 routed top-6; llama4-scout: 1 shared
+ 16 routed top-1) and the Switch-style load-balancing loss.  In a
training step on a ``data x model`` mesh the block routes, drops and
scores over the global batch's tokens and splits the experts over the
model axis (:func:`moe_ffn`).

Three places where torch and JAX differ are pinned to the reference:

* ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
  makes no such promise, so the top k come from a stable descending sort.
* ``jnp.argsort`` is stable; so is the dispatch sort here.
* The reference combines with a bf16 scatter-add, which XLA on the CPU
  applies in sorted-expert order, one bf16 rounding per add.  Here each
  token adds its k contributions in ascending expert order from zero, a
  fixed order on every device (``index_add_`` on CUDA is not).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.accel import Postreduce, matmul as accel_matmul, vmapped
from repro_torch.core.datapath import ACTIVATIONS
from repro_torch.distributed.autoshard import (gather, local_stats,
                                               sum_grad, train_mesh)
from repro_torch.distributed.sharding import expert_block

from .layers import init_linear, linear


def init_moe(gen, cfg, device, lead: tuple = ()) -> dict:
    """One MoE FFN's params; ``lead`` prepends stacked-layer axes (the
    stacked expert weights are [..., E, d, f])."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def normal(shape, std):
        t = torch.randn(lead + shape, generator=gen, device=device)
        return t.mul_(std)

    params = {
        "router": init_linear(gen, d, e, device, lead),
        "w_gate": normal((e, d, f), d ** -0.5),
        "w_up": normal((e, d, f), d ** -0.5),
        "w_down": normal((e, f, d), f ** -0.5),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {"gate": init_linear(gen, d, fs, device, lead),
                            "up": init_linear(gen, d, fs, device, lead),
                            "down": init_linear(gen, fs, d, device, lead)}
    return params


def route(params, xt: torch.Tensor, cfg):
    """Router (f32, digital by design), softmax and top-k with
    renormalised gates: ``(probs [T, E], gate_w [T, k], gate_idx [T,
    k])``, the top k in descending order, the lower expert first on a
    tie (``jax.lax.top_k``'s order)."""
    logits = linear(params["router"], xt, None, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    gate_w, gate_idx = top.values[:, :k], top.indices[:, :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_idx


def capacity(t: int, cfg) -> int:
    """Rows per expert buffer: the reference's Python expression."""
    k, e = cfg.experts_per_tok, cfg.n_experts
    return int(min(t * k, max(1, round(t * k / e * cfg.moe_capacity_factor))))


def dispatch(gate_idx: torch.Tensor, e: int, cap: int):
    """The sort-based dispatch of ``gate_idx`` [T, k] into ``e`` expert
    buffers of ``cap`` rows: ``(order, se, st_, keep, slot)``, the
    stable sort of the T*k assignments by expert, their experts and
    tokens in that order, whether each fits its expert's capacity (slot
    positions in token order within an expert) and its buffer row
    (``e * cap``, the overflow row, for a dropped one)."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    flat_e = gate_idx.reshape(-1)                              # [T*k]
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st_ = flat_e[order], flat_t[order]
    # position of each assignment within its expert's contiguous group
    group_start = torch.searchsorted(se, torch.arange(e, device=dev),
                                     side="left")
    pos = torch.arange(t * k, device=dev) - group_start[se]
    keep = pos < cap                                            # drops
    slot = torch.where(keep, se * cap + pos, e * cap)           # overflow
    return order, se, st_, keep, slot


def moe_ffn(params, x: torch.Tensor, cfg, dtype=torch.bfloat16):
    """x: [B, S, d] -> ([B, S, d], aux_loss).  Expert capacity is shared
    by every token of the batch (pads included): under a tight
    ``moe_capacity_factor`` a token's output depends on its neighbours,
    as in the reference.

    Inside a training step on a mesh (:func:`~repro_torch.distributed.
    autoshard.global_batch`) ``x`` is this rank's rows of the global
    batch, and the block computes what it computes on the whole batch
    (the reference's ``jit`` form, its dispatch buffer and expert
    outputs constrained to the expert axis over ``"tp"``):

    1. the rows are gathered over the dp axes (:func:`~repro_torch.
       distributed.autoshard.gather`: the backward sums the gradient
       over them and keeps this rank's block);
    2. routing, the aux loss, the capacity and the dispatch run on the
       global tokens, the same ops on the same array as on one device;
    3. the rank builds the buffer rows of its experts only
       (:func:`~repro_torch.distributed.sharding.expert_block`: its
       block on ``"model"`` in mode ``"2d"``, every expert in
       ``"fsdp"``) and runs the three grouped matmuls on them with the
       dp reductions off (the buffer is already the global batch's);
    4. in ``"2d"`` the expert outputs are gathered over ``"model"`` on
       the expert axis (backward: this rank's block, no sum), and the
       gathered rows feed the buffer through
       :func:`~repro_torch.distributed.autoshard.sum_grad` over
       ``"model"``, which sums the ranks' expert-partial gradients;
    5. the combine runs for this rank's tokens in the same ascending
       expert order, and the shared experts on the local rows with the
       global per-tensor scale, as a dense FFN does.

    Every dp rank computes its experts over every token: the expert work
    is repeated across the dp axes."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    dev = x.device
    scope = train_mesh()
    xl = x.reshape(b * s, d)                        # this rank's tokens
    xt = xl if scope is None else gather(xl, scope.axes, 0)
    t = xt.shape[0]
    probs, gate_w, gate_idx = route(params, xt, cfg)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    # one-hot by comparison: F.one_hot reads the indices' range to the
    # host on the CPU and runs other ops on each device
    one_hot = gate_idx[..., None] == torch.arange(e, device=dev)
    ce = one_hot.to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(me * ce)

    cap = capacity(t, cfg)
    order, se, st_, keep, slot = dispatch(gate_idx, e, cap)

    # this rank's experts [lo, lo + n): all of them off a mesh
    ep, lo, n = ((), 0, e) if scope is None else expert_block(
        params["w_gate"].shape, scope.mesh, scope.policy)
    if n == e:
        src, own = xt, slot
    else:
        src = sum_grad(xt, ep)
        mine = keep & (se >= lo) & (se < lo + n)
        own = torch.where(mine, slot - lo * cap, n * cap)
    buf = torch.zeros((n * cap + 1, d), dtype=dtype, device=dev)
    buf[own] = src[st_].to(dtype)
    xe = buf[:-1].reshape(n, cap, d)

    # ---- the expert FFN: three grouped dispatches over the n experts,
    # the gate's activation fused into its epilogue (DESIGN.md §10)
    sp = cfg.policy.resolver("moe")
    fuse = getattr(cfg, "fuse_datapath", True)
    act = ACTIVATIONS[cfg.act]
    gate_post = Postreduce(act=cfg.act) if fuse else None
    # an image of all E experts does not match a block of them: dispatch
    # drops it and quantizes the block on the fly (the same bits)
    imgs = params.get("cima") or {}

    def w(name):
        return params[name] if n == e else params[name][lo:lo + n]

    with vmapped(n), (contextlib.nullcontext() if scope is None
                      else local_stats()):
        ge = accel_matmul(xe, w("w_gate"), sp("moe.gate"), dtype=dtype,
                          image=imgs.get("gate"), post=gate_post)
        ue = accel_matmul(xe, w("w_up"), sp("moe.up"), dtype=dtype,
                          image=imgs.get("up"))
        ye = accel_matmul((ge if fuse else act(ge)) * ue, w("w_down"),
                          sp("moe.down"), dtype=dtype,
                          image=imgs.get("down")).to(dtype)
    if n != e:
        ye = gather(ye, ep, 0)

    # ---- combine: each of this rank's tokens' kept contributions, added
    # in ascending expert order from zero in `dtype` (dropped ones add
    # exact zeros)
    ye_flat = torch.cat([ye.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=dtype, device=dev)])
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot                                       # [T*k]
    flat_w = gate_w.reshape(-1)
    tl = b * s
    if scope is not None:
        first = scope.dp_index() * tl
        slot_tk = slot_tk[first * k:(first + tl) * k]
        flat_w = flat_w[first * k:(first + tl) * k]
        gate_idx = gate_idx[first:first + tl]
    contrib = ye_flat[slot_tk] * flat_w[:, None].to(dtype)
    contrib = contrib.reshape(tl, k, d)
    by_expert = torch.argsort(gate_idx, dim=1)                  # [T, k]
    rows = torch.arange(tl, device=dev)
    y = torch.zeros((tl, d), dtype=dtype, device=dev)
    for j in range(k):
        y = y + contrib[rows, by_expert[:, j]]

    if "shared" in params:
        shp = params["shared"]
        sg = linear(shp["gate"], xl, sp("moe.shared.gate"), dtype,
                    post=gate_post)
        h = (sg if fuse else act(sg)) * linear(shp["up"], xl,
                                               sp("moe.shared.up"), dtype)
        y = y + linear(shp["down"], h, sp("moe.shared.down"), dtype)
    return y.reshape(b, s, d), aux
