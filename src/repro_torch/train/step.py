"""Train and eval steps: gradient accumulation over microbatches,
optional BP/BS gradient compression with error feedback, the AdamW
update.  Port of ``repro.train.step``.

The steps run eagerly.  Every managed projection's forward runs on its
backend (the CUDA kernel on the ``kernel`` backend); the straight-through
backward is plain float32 GEMMs (:mod:`repro_torch.accel.dispatch`).

On a ``data x model`` mesh (:func:`build_train_step` with ``mesh=``) the
step is SPMD over the ranks, each holding its slices of the state under
:func:`~repro_torch.distributed.sharding.state_specs`, and computes what
the single-device step computes on the global batch, as the reference's
step under ``jit`` with state shardings does:

1. gather the parameters from their slices: over every axis, or in a
   tensor-parallel step over the fsdp axes alone;
2. forward and backward on this rank's rows of the global batch (cut by
   ``batch_specs`` over the policy's dp axes) inside
   :func:`~repro_torch.distributed.autoshard.global_batch`, so a
   per-tensor input scale and the loss's token count are the global
   batch's;
3. sum the gradient over the dp axes, leaf by leaf, and keep this rank's
   slices of it (a tensor-parallel leaf's gradient already is the
   rank's ``"model"`` slice);
4. compress the reduced gradient (:func:`~repro_torch.optim.compression.
   compress_sharded`), clip by its global norm, and run AdamW on this
   rank's slices of params, mu and nu.

In mode ``"2d"`` a dense decoder (:func:`~repro_torch.distributed.
sharding.tp_config`, every leaf split on ``"model"`` by its spec) trains
tensor-parallel, as the reference's step under its shardings: each
rank computes with its ``"model"`` slice of every leaf
(:func:`~repro_torch.distributed.sharding.splits_on_model`), its output
columns of the column-parallel projections, its rows of the row-
parallel ones (or their column form), attention on its heads, query
rows or head dims in the reference's mode, and its vocabulary block of
the embedding, the head and the cross entropy (``models.layers``,
``models.attention``, ``models.model.vocab_nll``).  The residual stream
stays replicated on ``"model"``, so every model rank gets the same
gradient of a replicated leaf.  Each block reports the form it ran in
where that form is chosen (:func:`repro_torch.tally.report_form`:
``"embed"``, ``"attn"`` and every projection's policy tag, from
``models.layers``, ``models.attention`` and ``accel.dispatch``); the
step's :class:`StepClock` keeps them, and ``train_step.forms`` holds
the last step's.

The other configs keep the replicated form: the model-axis ranks
compute the same rows on parameters gathered whole, but for the routed
experts: a MoE block gathers its rows over the dp axes, routes, drops
and scores the aux loss over the global tokens, and each rank computes
its block of the experts on ``"model"`` (:func:`~repro_torch.models.
moe.moe_ffn`), so an expert leaf's gradient is whole on its own slice
only, the slice step 3 keeps.  Each microbatch's MoE runs over that
microbatch's global tokens, as the reference's accumulation does.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import tally
from repro_torch.distributed import autoshard
from repro_torch.distributed import sharding as shd
from repro_torch.models import loss_fn
from repro_torch.models.mixer_split import ssd_mode
from repro_torch.optim.adamw import (AdamWConfig, apply_updates, f32,
                                     global_norm)
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_decompress,
                                           compress_sharded)
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

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


def _grads(cfg, params, batches, step: torch.Tensor):
    """``(metrics, grads)`` of ``loss_fn`` on ``params``, averaged over
    ``batches`` (the microbatches; one batch as it is)."""
    def grads_of(batch):
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch, cfg), params)
        return metrics, grads

    if len(batches) == 1:
        return grads_of(batches[0])
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    msum = {k: torch.zeros((), dtype=torch.float32, device=step.device)
            for k in METRICS}
    for one in batches:
        metrics, grads = grads_of(one)
        gsum = tree_map(torch.add, gsum, grads)
        msum = {k: msum[k] + metrics[k] for k in METRICS}
    n = f32(len(batches), step)
    return ({k: v / n for k, v in msum.items()},
            tree_map(lambda g: g / n, gsum))


def build_train_step(cfg, opt_cfg: AdamWConfig,
                     comp_cfg: Optional[CompressionConfig] = None,
                     microbatches: int = 1, mesh=None, shard_policy=None,
                     specs=None):
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-dim
    device tensors (``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm``,
    ``lr``).  With ``mesh`` (and ``shard_policy``) the step takes this
    rank's slices of the state under ``specs`` (the
    :func:`~repro_torch.distributed.sharding.state_specs` of the full
    state) and the global batch; see the module docstring."""
    if mesh is not None:
        return _build_mesh_step(cfg, opt_cfg, comp_cfg, microbatches, mesh,
                                shard_policy, specs)

    def train_step(state: TrainState, batch: dict):
        batches = (_split_microbatches(batch, microbatches)
                   if microbatches > 1 else [batch])
        metrics, grads = _grads(cfg, state.params, batches, state.step)

        error = state.error
        if comp_cfg is not None and comp_cfg.enabled:
            grads, error = compress_decompress(grads, error, comp_cfg.bits)

        new_params, new_opt, opt_metrics = apply_updates(
            state.params, grads, state.opt, opt_cfg)
        metrics = {**metrics, **opt_metrics}
        return TrainState(new_params, new_opt, error, state.step + 1), metrics

    return train_step


class StepClock:
    """Host-clock ms and mesh collectives of a mesh step's phases, one
    dict a step in ``steps``: ``<phase>_ms``, ``<phase>_collectives``,
    ``<phase>_bytes`` and ``<phase>_by_op`` (``"kind/axis/op"`` to
    ``[count, bytes]``, each collective's bytes the larger of its operand
    and its result) for ``gather`` (the parameters), ``compute``
    (forward and backward, with their statistics' reductions and a
    tensor-parallel step's activation collectives), ``reduce`` (the
    gradient) and ``update`` (compression, norm, AdamW).  A CUDA device
    is synchronized at each mark, so a phase's device work lands in
    it.  Between :meth:`start` and :meth:`stop` the clock is an open
    counter of :mod:`repro_torch.tally`, which the mesh reports its
    collectives to and each block its form (``forms``: the block to the
    form it ran in this step)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.steps: list = []
        self.forms: dict = {}
        self._by_op: dict = {}

    def _now(self, device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def add_kernel(self, ops: int, nbytes: int) -> None:
        """(A kernel call: not a phase's collective.)"""

    def add_collective(self, kind: str, axis: str, operand_bytes: int,
                       result_bytes: int, op=None) -> None:
        entry = self._by_op.setdefault(f"{kind}/{axis}/{op}", [0, 0])
        entry[0] += 1
        entry[1] += max(operand_bytes, result_bytes)

    def add_form(self, block: str, form) -> None:
        self.forms[block] = form

    def start(self, device) -> None:
        self.steps.append({})
        self._t = self._now(device)
        self._s = dict(self.mesh.stats)
        self._by_op = {}
        self.forms.clear()
        tally.ACTIVE.append(self)

    def stop(self) -> None:
        if self in tally.ACTIVE:
            tally.ACTIVE.remove(self)

    def mark(self, phase: str, device) -> None:
        t, s = self._now(device), dict(self.mesh.stats)
        step = self.steps[-1]
        step[f"{phase}_ms"] = (t - self._t) * 1e3
        step[f"{phase}_collectives"] = s["collectives"] - \
            self._s["collectives"]
        step[f"{phase}_bytes"] = s["bytes"] - self._s["bytes"]
        step[f"{phase}_by_op"], self._by_op = self._by_op, {}
        self._t, self._s = t, s


def tensor_parallel(cfg, mesh, policy, param_specs, params) -> bool:
    """Does a mesh step of ``cfg`` run tensor-parallel: mode ``"2d"``, a
    ``"model"`` axis wider than 1, a config of the blocks
    :func:`~repro_torch.distributed.sharding.tp_config` admits whose SSD
    mixer, if any, splits on the axis (its heads or head dim), and every
    weight leaf of ``params`` split on ``"model"`` by its spec but those
    the step may use whole (:data:`~repro_torch.distributed.sharding.
    WHOLE_LEAVES`: each rank computes all of such a leaf's output,
    recorded as ``"whole"``, and the gradient of the part it uses is
    summed over ``"model"``).  Any other dim the axis does not divide
    (the LRU width among them, through ``in_x``) keeps the config in the
    replicated form."""
    policy = shd.resolve_policy(policy)
    if policy.is_fsdp or "model" not in mesh.axis_names \
            or mesh.size("model") <= 1 or not shd.tp_config(cfg) \
            or (cfg.ssm_state and ssd_mode(cfg, mesh.size("model")) is None):
        return False
    return all(shd.splits_on_model(spec) or path.endswith(shd.WHOLE_LEAVES)
               for (path, _), spec in zip(
                   leaves_with_path(params),
                   shd.spec_leaves(params, param_specs))
               if path.endswith("['w']") or path.endswith("['table']"))


def _build_mesh_step(cfg, opt_cfg, comp_cfg, microbatches, mesh, policy,
                     specs):
    if specs is None:
        raise ValueError("a train step on a mesh needs the state's specs "
                         "(distributed.state_specs of the full state)")
    dp = shd.dp_axes(mesh, policy)
    dp_size = mesh.size_of(dp)
    clock = StepClock(mesh)
    # a tensor-parallel step gathers over the fsdp axes alone
    over: list = []

    def rows(batch: dict) -> dict:
        """This rank's rows of a (micro)batch of the global batch."""
        b = batch["tokens"].shape[0]
        if b % dp_size:
            raise ValueError(f"batch {b} does not split over the dp axes "
                             f"{dp} ({dp_size} ranks)")
        bspecs = shd.batch_specs(batch, mesh, b, policy)
        return tree_map(lambda t, s: shd.local_slice(t, s, mesh), batch,
                        bspecs)

    def reduced_slices(gl: list, like) -> list:
        """The gradient's leaves ``gl`` summed over the dp axes, leaf by
        leaf in place, and this rank's slice of each (each full leaf
        dropped from ``gl`` as it goes); ``like`` is a tree of the
        parameters' structure."""
        out = []
        for i, spec in enumerate(shd.spec_leaves(like, specs.params)):
            g, gl[i] = mesh.all_reduce_(gl[i].contiguous(), dp), None
            if over[0] is not None:
                g = shd.slice_axes(g, spec, mesh, over[0])
            else:
                g = shd.local_slice(g, spec, mesh)
            out.append(g.clone() if any(a is not None for a in spec)
                       else g)
        return out

    def train_step(state: TrainState, batch: dict):
        device = state.step.device
        if not over:
            over.append(shd.fsdp_axes(mesh, policy) if tensor_parallel(
                cfg, mesh, policy, specs.params, state.params) else None)
        clock.start(device)
        try:
            return step(state, batch, device)
        finally:
            clock.stop()

    def step(state: TrainState, batch: dict, device):
        params = (shd.unshard_tree(state.params, specs.params, mesh)
                  if over[0] is None else
                  shd.gather_tree(state.params, specs.params, mesh, over[0]))
        clock.mark("gather", device)
        batches = (_split_microbatches(batch, microbatches)
                   if microbatches > 1 else [batch])
        with autoshard.global_batch(mesh, policy, tp=over[0] is not None):
            metrics, grads = _grads(cfg, params, [rows(b) for b in batches],
                                    state.step)
        flat = leaves(grads)
        del params, grads
        clock.mark("compute", device)
        grads = unflatten(state.params, reduced_slices(flat, state.params))
        clock.mark("reduce", device)
        error = state.error
        if comp_cfg is not None and comp_cfg.enabled:
            grads, error = compress_sharded(grads, error, comp_cfg.bits,
                                            specs.params, mesh)
        norm = global_norm(grads, specs.params, mesh)
        new_params, new_opt, opt_metrics = apply_updates(
            state.params, grads, state.opt, opt_cfg, norm)
        clock.mark("update", device)
        return (TrainState(new_params, new_opt, error, state.step + 1),
                {**metrics, **opt_metrics})

    train_step.clock = clock
    train_step.forms = clock.forms
    return train_step


def build_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return eval_step
