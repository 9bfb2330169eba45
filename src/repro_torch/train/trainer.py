"""Fault-tolerant training loop.  Port of ``repro.train.trainer``.

* Auto-resume: on start the trainer restores the latest checkpoint and
  continues at its step (deterministic per-step data), so a preempted
  job replays identically.
* Crash safety: checkpoints are atomic and async (:mod:`.checkpoint`);
  ``crash_at_step`` injects a node failure.
* Straggler watchdog: a step slower than ``straggler_factor`` x the
  running median is logged.

The step runs eagerly on ``device`` (``cuda`` unless the caller passes
another); the metrics are read to the host once per step.  On a mesh
every rank of it calls :func:`train`: each holds its slices of the
state (:mod:`.step`), rank 0 logs, checkpoints hold full leaves, and a
job resumes from any mesh shape's checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.distributed import sharding as shd
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.serve.host import host_sync

from . import checkpoint as ckpt_lib
from .state import init_train_state, state_template
from .step import build_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    microbatches: int = 1
    straggler_factor: float = 3.0
    crash_at_step: Optional[int] = None     # fault injection (tests)


class CrashInjected(RuntimeError):
    pass


def train(cfg, data_cfg: DataConfig, opt_cfg: AdamWConfig,
          trainer_cfg: TrainerConfig,
          comp_cfg: Optional[CompressionConfig] = None,
          state_shardings=None, log_fn: Optional[Callable] = None,
          program_manager=None, mesh=None, shard_policy=None,
          device="cuda"):
    """Run (or resume) training.  Returns (final_state, history).

    Parameters come from ``init_params(cfg, data_cfg.seed, device)``.
    ``program_manager`` (a :class:`repro_torch.accel.ProgramManager`) is
    invalidated after every optimizer update: compiled CIMA weight images are snapshots of the
    weights, so a serving or eval consumer sharing the manager rebuilds
    them from the fresh params.  Training itself runs the on-the-fly STE
    path and never installs images.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.ServeMesh`, every rank
    of it calling) and ``shard_policy`` (an explicit
    :class:`~repro_torch.distributed.ShardPolicy`): the state is sharded
    under ``state_shardings``, a spec tree, or when None under
    :func:`~repro_torch.distributed.sharding.state_specs` of the policy.
    Every rank returns its own slices of the final state and the same
    history.
    """
    from repro_torch.models import init_params

    if mesh is None and state_shardings is not None:
        raise ValueError("state_shardings needs the mesh they shard over")
    log = log_fn or (lambda s: print(s, flush=True))
    if mesh is not None and mesh.rank != 0:
        log = lambda s: None                            # noqa: E731

    # ---- init or resume
    latest = ckpt_lib.latest_checkpoint(trainer_cfg.ckpt_dir)
    params = init_params(cfg, data_cfg.seed, device)
    if mesh is None:
        state = init_train_state(params, comp_cfg is not None)
    else:                      # a rank holds its slices, never the moments
        state = state_template(params, comp_cfg is not None)
        if state_shardings is None:
            state_shardings = shd.state_specs(state, mesh, shard_policy)
    start_step = 0
    if latest is not None:
        state, start_step = ckpt_lib.restore(latest, state, state_shardings,
                                             mesh)
        log(f"[trainer] resumed from {latest} at step {start_step}")
    elif mesh is not None:
        state = init_train_state(
            shd.shard_tree(params, state_shardings.params, mesh),
            comp_cfg is not None)
    del params
    step_fn = build_train_step(cfg, opt_cfg, comp_cfg,
                               trainer_cfg.microbatches, mesh=mesh,
                               shard_policy=shard_policy,
                               specs=state_shardings)

    saver = ckpt_lib.AsyncCheckpointer(trainer_cfg.ckpt_dir,
                                       trainer_cfg.keep_ckpts, mesh=mesh,
                                       specs=state_shardings)
    history = []
    durations: list[float] = []
    prefetch = Prefetcher(data_cfg, start_step=start_step, device=device)
    try:
        for step_idx, batch in prefetch:
            if step_idx >= trainer_cfg.total_steps:
                break
            t0 = time.monotonic()
            state, metrics = step_fn(state, batch)
            if program_manager is not None:
                program_manager.invalidate()   # weights moved: images stale
            names = sorted(metrics)
            metrics = dict(zip(names, host_sync(torch.stack(
                [metrics[k].to(torch.float32) for k in names]),
                reason="one read of the step's metrics a step: the "
                "log, the history and the straggler watchdog").tolist()))
            dt = time.monotonic() - t0
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > trainer_cfg.straggler_factor * med:
                log(f"[watchdog] step {step_idx} took {dt:.3f}s "
                    f"({dt/med:.1f}x median) — straggler suspected")
            history.append({"step": step_idx, **metrics})
            if step_idx % trainer_cfg.log_every == 0:
                log(f"[train] step {step_idx} loss={metrics['loss']:.4f} "
                    f"lr={metrics['lr']:.2e} gnorm={metrics['grad_norm']:.3f} "
                    f"({dt*1e3:.0f} ms)")
            next_step = step_idx + 1
            if next_step % trainer_cfg.ckpt_every == 0 \
                    or next_step == trainer_cfg.total_steps:
                saver.save(next_step, state)
            if trainer_cfg.crash_at_step is not None \
                    and next_step == trainer_cfg.crash_at_step:
                saver.wait()
                raise CrashInjected(f"injected crash at step {next_step}")
    finally:
        prefetch.close()
        saver.wait()
    return state, history
