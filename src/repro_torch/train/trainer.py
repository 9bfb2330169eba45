"""Fault-tolerant training loop.  Port of ``repro.train.trainer``.

* Auto-resume: on start the trainer restores the latest checkpoint and
  continues at its step (deterministic per-step data), so a preempted
  job replays identically.
* Crash safety: checkpoints are atomic and async (:mod:`.checkpoint`);
  ``crash_at_step`` injects a node failure.
* Straggler watchdog: a step slower than ``straggler_factor`` x the
  running median is logged.

The step runs eagerly on ``device`` (``cuda`` unless the caller passes
another); the metrics are read to the host once per step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig

from . import checkpoint as ckpt_lib
from .state import init_train_state
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
    path and never installs images.  ``mesh``, ``shard_policy`` and
    ``state_shardings`` come with the port's sharded-training slice.
    """
    if mesh is not None or shard_policy is not None \
            or state_shardings is not None:
        raise NotImplementedError(
            "sharded training comes with the port's sharded-training "
            "slice")
    from repro_torch.models import init_params

    log = log_fn or (lambda s: print(s, flush=True))
    step_fn = build_train_step(cfg, opt_cfg, comp_cfg,
                               trainer_cfg.microbatches)

    # ---- init or resume
    latest = ckpt_lib.latest_checkpoint(trainer_cfg.ckpt_dir)
    state = init_train_state(init_params(cfg, data_cfg.seed, device),
                             comp_cfg is not None)
    start_step = 0
    if latest is not None:
        state, start_step = ckpt_lib.restore(latest, state)
        log(f"[trainer] resumed from {latest} at step {start_step}")

    saver = ckpt_lib.AsyncCheckpointer(trainer_cfg.ckpt_dir,
                                       trainer_cfg.keep_ckpts)
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
            names = sorted(metrics)            # one host read per step
            metrics = dict(zip(names, torch.stack(
                [metrics[k].to(torch.float32) for k in names]).tolist()))
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
