"""AdamW with decoupled weight decay, global-norm clipping and a
warmup + cosine schedule.  Port of ``repro.optim.adamw``.

Parameters, gradients and moments are trees of tensors
(:mod:`repro_torch.tree`).  The arithmetic is the reference's, in
float32 on the parameters' device: the bias corrections ``b ** count``
and the schedule's cosine in float32, the global norm summed over the
leaves in the reference's (sorted-key) order, and every division by a
constant a division by a device tensor (on CUDA, ``tensor / python
float`` multiplies by the reciprocal, which may round differently).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor          # int32, on the parameters' device


def f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``v`` on ``like``'s device (a true divisor)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def init_opt_state(params) -> OptState:
    device = next(iter(leaves(params)), torch.zeros(())).device
    return OptState(tree_map(torch.zeros_like, params),
                    tree_map(torch.zeros_like, params),
                    torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-dim tensor): linear warmup, then
    cosine down to ``min_lr_frac``."""
    step = step.to(torch.float32)
    warm = torch.clamp_max((step + 1) / f32(max(cfg.warmup_steps, 1), step),
                           1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                             step), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The norm of the whole tree.  With ``specs`` and ``mesh`` the tree
    holds this rank's slices (:func:`~repro_torch.distributed.sharding.
    shard_tree`): each leaf's sum of squares is summed over the axes that
    shard it (a replicated leaf counts once), so every rank gets the full
    tree's norm, its sums in another order."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    if specs is not None:
        from repro_torch.distributed.sharding import sharded_leaf_reduce

        sq = sharded_leaf_reduce(sq, tree, specs, mesh, "sum")
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to at most ``max_norm`` and their norm (``norm``
    when given: the norm of the tree that ``grads`` slices)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp_max(f32(max_norm, norm)
                            / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig,
                  norm=None):
    """One AdamW step.  Returns (new_params, new_state, metrics).
    ``norm``: the gradient's global norm, when ``grads`` are one rank's
    slices of the gradient."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    b1, b2 = cfg.betas
    count = state.count + 1
    lr = schedule(cfg, state.count)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    c1 = 1 - torch.pow(b1, count.to(torch.float32))
    c2 = 1 - torch.pow(b2, count.to(torch.float32))

    def upd(p, m, v):
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        return p - lr * (u + cfg.weight_decay * p)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(mu, nu, count), {"grad_norm": gnorm,
                                                 "lr": lr}
