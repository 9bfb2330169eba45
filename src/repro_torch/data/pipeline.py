"""Data pipeline: deterministic synthetic sources and a double-buffered
prefetcher.  Port of ``repro.data.pipeline``.

Batches are a pure function of (seed, step), drawn from numpy's
``SeedSequence([seed, step])`` exactly as the reference draws them, so
every batch is bitwise the reference's and a restarted run replays the
identical stream.  They arrive as torch tensors on the caller's device
(``cuda`` unless the caller passes another).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "lm_synthetic"       # lm_synthetic | cifar_synthetic
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 50304
    seed: int = 0
    frontend_seq: int = 0            # frontend stub: embedding positions
    d_model: int = 0
    image_hw: int = 32
    n_classes: int = 10


def _rng_for_step(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def lm_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Synthetic LM batch with learnable structure: ``next = (3 * cur +
    17) % vocab`` with 10% random jumps.  ``tokens`` [B, S] int32; with
    ``frontend_seq``, ``frontend_embeds`` [B, frontend_seq, d_model]
    float32 (the frontend stub's patch or frame embeddings)."""
    rng = _rng_for_step(cfg, step)
    b, s = cfg.global_batch, cfg.seq_len
    start = rng.integers(0, cfg.vocab, (b, 1))
    jumps = rng.random((b, s)) < 0.1
    noise = rng.integers(0, cfg.vocab, (b, s))
    toks = np.zeros((b, s), np.int64)
    toks[:, 0] = start[:, 0]
    for t in range(1, s):
        nxt = (3 * toks[:, t - 1] + 17) % cfg.vocab
        toks[:, t] = np.where(jumps[:, t], noise[:, t], nxt)
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device)}
    if cfg.frontend_seq:
        emb = rng.standard_normal((b, cfg.frontend_seq, cfg.d_model),
                                  dtype=np.float32) * 0.1
        batch["frontend_embeds"] = torch.from_numpy(emb).to(device)
    return batch


def cifar_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Synthetic 32x32x3 classification data: a fixed per-class template
    (seeded independently of the step) plus noise.  ``images`` [B, 32,
    32, 3] float32, ``labels`` [B] int32."""
    rng = _rng_for_step(cfg, step)
    b = cfg.global_batch
    labels = rng.integers(0, cfg.n_classes, (b,))
    # drawn and discarded, as the reference does, to keep its stream
    rng.standard_normal((cfg.n_classes, cfg.image_hw, cfg.image_hw, 3),
                        dtype=np.float32)
    trng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 999]))
    templates = trng.standard_normal(
        (cfg.n_classes, cfg.image_hw, cfg.image_hw, 3)).astype(np.float32)
    x = templates[labels] + 0.7 * rng.standard_normal(
        (b, cfg.image_hw, cfg.image_hw, 3)).astype(np.float32)
    return {"images": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device)}


def make_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    if cfg.kind == "lm_synthetic":
        return lm_batch(cfg, step, device)
    if cfg.kind == "cifar_synthetic":
        return cifar_batch(cfg, step, device)
    raise ValueError(cfg.kind)


class Prefetcher:
    """Double-buffered background prefetch: batch ``step + 1`` is made
    and moved to ``device`` on a worker thread while ``step`` computes.
    Iterating yields ``(step, batch)`` and raises what the worker raised;
    :meth:`close` stops the worker."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device="cuda"):
        self.cfg = cfg
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, make_batch(self.cfg, step, self.device))
            except Exception as e:   # noqa: BLE001 - re-raised by __next__
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    step += 1
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
