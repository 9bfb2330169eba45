"""Train and eval steps: gradient accumulation over microbatches,
optional BP/BS gradient compression with error feedback, the AdamW
update.  Port of ``repro.train.step``.

The steps run eagerly.  Every managed projection's forward runs on its
backend (the CUDA kernel on the ``kernel`` backend); the straight-through
backward is plain float32 GEMMs (:mod:`repro_torch.accel.dispatch`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import loss_fn
from repro_torch.optim.adamw import AdamWConfig, apply_updates, f32
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_decompress)
from repro_torch.tree import leaves, tree_map, unflatten

from .state import TrainState

METRICS = ("loss", "ce", "aux", "tokens")


def value_and_grad(fn: Callable, params, *args):
    """``((value, aux), grads)`` of ``fn(params, *args) -> (value, aux)``,
    as ``jax.value_and_grad(has_aux=True)``: the gradient tree has
    ``params``' structure, with zeros for leaves the value does not use.
    ``aux`` comes back detached."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    value, aux = fn(p, *args)
    ps = leaves(p)
    grads = torch.autograd.grad(value, ps, allow_unused=True)
    grads = [torch.zeros_like(q) if g is None else g
             for q, g in zip(ps, grads)]
    aux = tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, aux)
    return (value.detach(), aux), unflatten(params, grads)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def build_train_step(cfg, opt_cfg: AdamWConfig,
                     comp_cfg: Optional[CompressionConfig] = None,
                     microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-dim
    device tensors (``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm``,
    ``lr``)."""
    def grads_of(params, batch):
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch, cfg), params)
        return metrics, grads

    def train_step(state: TrainState, batch: dict):
        if microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                            state.params)
            msum = {k: torch.zeros((), dtype=torch.float32,
                                   device=state.step.device) for k in METRICS}
            for one in _split_microbatches(batch, microbatches):
                metrics, grads = grads_of(state.params, one)
                gsum = tree_map(torch.add, gsum, grads)
                msum = {k: msum[k] + metrics[k] for k in METRICS}
            n = f32(microbatches, state.step)
            grads = tree_map(lambda g: g / n, gsum)
            metrics = {k: v / n for k, v in msum.items()}
        else:
            metrics, grads = grads_of(state.params, batch)

        error = state.error
        if comp_cfg is not None and comp_cfg.enabled:
            grads, error = compress_decompress(grads, error, comp_cfg.bits)

        new_params, new_opt, opt_metrics = apply_updates(
            state.params, grads, state.opt, opt_cfg)
        metrics = {**metrics, **opt_metrics}
        return TrainState(new_params, new_opt, error, state.step + 1), metrics

    return train_step


def build_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step
