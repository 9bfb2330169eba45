"""Shared figure utilities: CSV emission and device-synchronized timing."""
from __future__ import annotations

import statistics
import time

import torch


def time_call(fn, device, iters: int = 5, warmup: int = 2) -> float:
    """Median wall time (µs) of ``fn()``, each call ending in a
    synchronize of ``device`` when it is a CUDA device."""
    cuda = torch.device(device).type == "cuda"

    def once():
        fn()
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        once()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
