#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's two CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/`` (one ``nvcc`` per source, started together), then

* holds the BP/BS ``cima_mvm`` kernel to its plain torch version on the
  card (the eight ``CIMA_CASES`` shapes of ``tests/test_kernels.py`` and
  the main path's projection shapes), serves full-width olmo-1b (random
  weights from a seed) through ``repro_torch.serve.Engine`` with every
  projection on the kernel, and serves the same prompts again on the
  plain path;
* serves ragged requests on full-width olmo-1b through the slot-level
  ``ContinuousBatcher`` and holds its stats to the schedule its budgets
  fix and its streams to solo ``Engine.generate`` runs;
* holds the flash-attention kernel to its plain version on the
  ``FA_CASES`` shapes, then drives ``kernels.ops.flash_attention`` at the
  full widths of olmo-1b (32k-token prefill), recurrentgemma-9b (local
  attention) and llama3.2-1b (GQA) and times it beside its plain version
  and ``scaled_dot_product_attention``;
* runs the paper's CIFAR-10 Networks A and B (Fig. 11) at full width
  through ``models.cnn.cnn_forward`` on the kernel, holds every layer and
  the logits to the kernel's plain version, times each layer's launch
  beside its bound, and prices a traced forward on the 65 nm chip model
  (``accel.energy_summary``) beside ``core.energy.network_cost`` and the
  paper;
* serves full-width olmo-1b from a program that streams its tail
  (``ServeConfig.cima_chips``), prices a traced decode step on the chip
  model and holds its tokens to the all-resident engine's;
* trains: QAT of full-width Networks A and B (``train.cifar_qat.
  qat_update``, 8 steps of 64 images) and full-width olmo-1b
  (``train.build_train_step``, 3 steps of 8 x 256 tokens, remat on), each
  held step by step to the same steps with the kernel routed to its
  plain version, with Fig. 11's accuracies on held-out synthetic batches;
  and ``train.trainer.train`` on reduced olmo-1b crashes at step 4,
  resumes, and must land on the uninterrupted run's loss;
* draws ADC noise at the 0.85 V corner (sigma 0.3 LSB) through ``bpbs``
  on the card: the code-shift and output-error statistics against the
  analytic ones, determinism in the seed and independence across
  dispatches (``noise``); noise-aware QAT of full-width A and B with the
  noisy Fig. 11 accuracies before and after ``calibrate_bn_stats``
  (``noise_qat``); the reference's 0.85 V acceptance recipe on reduced A
  (``noise_corner``, reported, not gated).  The kernel takes no noise,
  as the Pallas kernel takes none: these paths launch it zero times;
* runs the paper's figure checks (Figs. 7, 8, 10, 11) on the card
  (``repro_torch.figures.run``), their CSV rows on earlier lines.

Each phase prints one JSON line.  The card's name and power limit follow
as ``nvidia-smi`` prints them, then the kernels line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero; so
does a machine without a CUDA device, or a directory without the repo.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# cuBLAS's deterministic workspace, read when its handle is made: the
# olmo-1b training phase runs under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import accel  # noqa: E402
from repro_torch.configs import NETWORK_A, NETWORK_B, get_config  # noqa: E402
from repro_torch.accel.context import fold_seed  # noqa: E402
from repro_torch.core import energy as E  # noqa: E402
from repro_torch.core.adc import SIGMA_LSB_CORNER, adc_convert  # noqa: E402
from repro_torch.core.bpbs import BpbsConfig  # noqa: E402
from repro_torch.core.quant import (Coding, int_range, plane_weights,  # noqa: E402
                                    quantize)
from repro_torch.figures import run as figures_run  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import cima_mvm as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.models.cnn import (cnn_forward, cnn_loss, init_cnn,  # noqa: E402
                                    update_bn_stats)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.optim.qat import calibrate_bn_stats, noise_aware  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Engine, ServeConfig  # noqa: E402
from repro_torch.train import build_train_step, init_train_state  # noqa: E402
from repro_torch.train import cifar_qat, step as train_step  # noqa: E402
from repro_torch.train.cifar_qat import fig11_accuracy, qat_update  # noqa: E402
from repro_torch.train.trainer import CrashInjected, TrainerConfig, train  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

SOURCE = "src/repro_torch/kernels/csrc/cima_mvm.cu"
REPLACES = "src/repro/kernels/cima_mvm.py:41"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:31"
# fused-epilogue tolerance: the kernel's expf/tanhf and the plain
# version's torch silu/gelu may round differently by a few float32 ulps;
# everything else in the epilogue is the same IEEE operation sequence
FUSED_TOL = dict(rtol=1e-6, atol=1e-6)
# data-sheet peaks (dense): device-memory bytes/s, int8 ops/s, bf16 FLOP/s
CARDS = {"sxm": (3.35e12, 1.979e15, 9.89e14),
         "pcie": (2.0e12, 1.513e15, 7.56e14)}
# the eight CIMA_CASES of tests/test_kernels.py:
# (coding, ba, bx, n, m, bank_n)
CIMA_CASES = [
    (Coding.XNOR, 4, 4, 300, 40, 2304), (Coding.XNOR, 1, 1, 256, 32, 2304),
    (Coding.XNOR, 2, 3, 512, 16, 256), (Coding.XNOR, 8, 8, 100, 8, 2304),
    (Coding.XNOR, 4, 2, 2400, 24, 2304), (Coding.AND, 4, 4, 300, 40, 2304),
    (Coding.AND, 2, 2, 512, 16, 128), (Coding.AND, 6, 3, 700, 12, 512),
]
# the main path's projections at full-width olmo-1b: (name, N, M, fused
# silu with per-row scales, launches per forward)
MAIN_SHAPES = [("attn.qkvo", 2048, 2048, False, 64),
               ("mlp.gate", 2048, 8192, True, 16),
               ("mlp.up", 2048, 8192, False, 16),
               ("mlp.down", 8192, 2048, False, 16),
               ("unembed", 2048, 50304, False, 1)]
LAUNCHES_PER_FORWARD = sum(s[4] for s in MAIN_SHAPES)        # 113
# rows of a main-shape launch: decode at batch 4, prefill-sized 128, and a
# training step's 2,048 (LM_BATCH x LM_SEQ)
MAIN_ROWS = (4, 128, 2048)
# kernel instances the main shapes launch: cima_mvm<B_A, m16 tiles> at
# B=4 (one tile) and B=128 (four), flash_bf16<head-dim bucket, kv tile>
MAIN_INSTANCES = {"cima_mvm_kernel<4,1>", "cima_mvm_kernel<4,4>",
                  "flash_bf16_kernel<128,64>", "flash_bf16_kernel<256,32>",
                  "flash_bf16_kernel<64,64>"}
# tests/test_kernels.py's FA_CASES and its long-window case:
# (b, h, hkv, s, d, causal, window, block_q, block_k, dtype)
FA_CASES = [
    (2, 4, 2, 256, 64, True, None, 64, 64, torch.float32),
    (1, 2, 2, 128, 32, False, None, 64, 64, torch.float32),
    (1, 4, 1, 256, 64, True, 96, 64, 64, torch.float32),
    (1, 8, 4, 192, 48, True, None, 64, 64, torch.float32),
    (2, 2, 2, 256, 128, True, None, 128, 128, torch.bfloat16),
    (1, 6, 6, 128, 96, True, None, 64, 64, torch.float32),
    (1, 2, 2, 128, 64, True, 4096, 64, 64, torch.float32),
]
# the reference's own tolerances: online against dense softmax in f32,
# plus one bf16 rounding of the output
FA_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 kernel against plain version, on top of FA_ATOL: both compute in
# f32 and round once to bf16, so an element differs by at most one bf16
# ulp (<= 2**-7 |ref|) where the two f32 values straddle a rounding edge,
# plus f32 summation-order noise (~1e-7) where |ref| is tiny
FA_BF16_RTOL, FA_BF16_ATOL = 2.0 ** -7, 1e-5
# full-width attention shapes of models the repo supports, bf16, B=1,
# causal: (name, H, HKV, D, S, window)
FA_SHAPES = [("olmo-1b prefill_32k", 16, 16, 128, 32768, None),
             ("recurrentgemma-9b local attention", 16, 1, 256, 8192, 2048),
             ("llama3.2-1b GQA", 32, 8, 64, 8192, None)]
# the batcher's traffic: ragged prompts of 8-40 tokens, ragged budgets
BATCH_PROMPTS = (8, 40, 17, 29, 12, 36, 23, 9)
BATCH_BUDGETS = (2, 16, 5, 9, 3, 12, 16, 7)
BATCH_SLOTS = 4
# a stream that leaves solo generate at a step whose top-2 logit gap is
# below this share of the logit scale is a near-tie, not a fault
NEAR_TIE_REL = 1e-3
# the CIFAR networks: 64 synthetic 32x32x3 images a batch, BN running
# statistics from one train=True forward of another 64; the paper's
# Fig. 11 figures (uJ/image, fps) and the network_cost arguments that
# reproduce them (tests/test_core_energy.py)
CIFAR_BATCH = 64
CIFAR_LAUNCHES = 9
CIFAR_PAPER = {"cifar-net-a": (105.2, 23.0), "cifar-net-b": (5.31, 176.0)}
CIFAR_COST = {"cifar-net-a": (E.NETWORK_A, dict(sparsity=0.5)),
              "cifar-net-b": (E.NETWORK_B, dict(sparsity=0.0, readout="abn",
                                                overhead_cycles=149500))}
# QAT of the CIFAR networks as examples/train_cifar_qat.py runs it: batch
# 64 from DataConfig(kind="cifar_synthetic", seed=1), AdamW lr 1e-3,
# warmup 5, no weight decay; Fig. 11's evaluation on 5 held-out batches
QAT_STEPS = 8
QAT_EVAL_BATCHES = 5
# full-width olmo-1b training at examples/train_lm.py's defaults (seq
# 256, batch 8, AdamW lr 3e-4, warmup 20, 200 steps planned)
LM_STEPS = 3
LM_SEQ, LM_BATCH = 256, 8
# the stacked layers' projections run again in the backward pass under
# cfg.remat (olmo-1b's default): 16 x 7 recomputed launches
LM_LAUNCHES_PER_STEP = LAUNCHES_PER_FORWARD + 16 * 7              # 225
# kernel route against plain route, per step's loss and gradient norm:
# bitwise (the forward outputs are bitwise and the backward ops the same,
# run under torch.use_deterministic_algorithms)
# 590kb arrays of the streaming engine: full-width olmo-1b needs 8,978 at
# B_A = 4 (512 a layer, 786 for the unembed), so the tail streams
SERVE_CHIPS = 4096
# ADC noise at the 0.85 V corner.  At fs = 255 (one bank of 255 rows, no
# adaptive range) the clean ADC is exact and a code moves by
# e = round(sigma z): P(e = +-1) = erfc(0.5 / (sigma sqrt 2)) = 0.09558,
# which is also Var(e) (P(|e| = 2) is 6e-7)
NOISE_SIGMA = SIGMA_LSB_CORNER[0.85]
NOISE_P_SHIFT = math.erfc(0.5 / NOISE_SIGMA / math.sqrt(2.0))
NOISE_ROWS, NOISE_N, NOISE_M = 4096, 255, 256
NOISE_SEEDS = (11, 12, 13)        # noisy Fig. 11 evaluations, averaged
NOISE_CAL_BATCHES = 4             # calibrate_bn_stats, as the QAT CLI
CORNER_STEPS, CORNER_BATCH, CORNER_EVAL = 60, 32, 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cima_operands(coding, ba, bx, n, m, batch, seed=0, sparsity=0.3):
    """Integer-grid operands, as tests/test_kernels.py makes them."""
    r = np.random.default_rng(seed)
    lo_x, hi_x = int_range(bx, coding)
    lo_w, hi_w = int_range(ba, coding)
    if coding == Coding.XNOR:
        x = (2 * r.integers(lo_x // 2, hi_x // 2 + 1, (batch, n))
             if bx > 1 else r.choice([-1, 1], (batch, n)))
        w = (2 * r.integers(lo_w // 2, hi_w // 2 + 1, (n, m))
             if ba > 1 else r.choice([-1, 1], (n, m)))
    else:
        x = r.integers(lo_x, hi_x + 1, (batch, n))
        w = r.integers(lo_w, hi_w + 1, (n, m))
    if not (coding == Coding.XNOR and bx == 1):
        x = x * (r.random((batch, n)) > sparsity)
    return (torch.tensor(x, dtype=torch.float32, device="cuda"),
            torch.tensor(w, dtype=torch.float32, device="cuda"))


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls of the device time between CUDA events
    recorded around each call."""
    for i in range(warmup):
        fn(i)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (a, b) in enumerate(ev):
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` run ``reps`` times back to back: the
    stream is held by a spin kernel while the host enqueues the calls, so
    CUDA events around them see no host gaps.  A per-call event pair
    (``median_ms``) also times the host's launch path when the call is
    shorter than it."""
    fn(0)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e7))      # ~10 ms of spinning at 2 GHz
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = CARDS["pcie" if "pcie" in name.lower() else "sxm"]
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         peak_bytes_per_s=peaks[0], peak_int8_ops_per_s=peaks[1],
         peak_bf16_flop_per_s=peaks[2])
    print(smi, flush=True)
    return name, peaks


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of every kernel instance in an
    ``nvcc -Xptxas -v`` log, as ``[{"kernel": "name<args>", ...}]``."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(cima_mvm_kernel|flash_bf16_kernel|flash_f32_kernel)"
                          r"I((?:Li\d+E)+)", m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else m.group(1))
            cur = {"kernel": name, "registers": None, "spill_bytes": 0}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return rows


def phase_build():
    """One nvcc per kernel source, all started together; then each
    instance's registers and spills from the -Xptxas -v logs.  The
    instances the main shapes launch must not spill."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sources = [root / SOURCE, root / FA_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    K._library()
    FA._library()
    seconds = time.perf_counter() - t0
    report = [r for lib in built
              for r in ptxas_report(lib.with_suffix(".log").read_text())]
    for r in report:
        if r["kernel"] in MAIN_INSTANCES:
            check(r["spill_bytes"] == 0, f"{r['kernel']} spills "
                  f"{r['spill_bytes']} bytes")
    check(MAIN_INSTANCES <= {r["kernel"] for r in report},
          f"instances missing from the build logs: {MAIN_INSTANCES}")
    emit("build", seconds=seconds,
         libraries=[str(lib.relative_to(root)) for lib in built],
         instances=report)


def phase_cima_cases() -> float:
    """The kernel against its plain version on the CIMA_CASES shapes:
    bitwise without the epilogue, FUSED_TOL with it."""
    worst = 0.0
    n_cmp = 0
    for case in CIMA_CASES:
        coding, ba, bx, n, m, bank_n = case
        x, w = cima_operands(coding, ba, bx, n, m, batch=5)
        for variant in ({}, {"adaptive_range": True}, {"ideal_adc": True}):
            cfg = BpbsConfig(ba=ba, bx=bx, coding=coding, bank_n=bank_n,
                             **variant)
            xs, nu, _ = K.prepare_inputs(x, cfg)
            ws, fs = K.prepare_weights(w, cfg)
            ref = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg)
            y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
            torch.cuda.synchronize()
            check(torch.equal(y, ref), f"kernel != plain on {case} {variant}")
            n_cmp += 1
        cfg = BpbsConfig(ba=ba, bx=bx, coding=coding, bank_n=bank_n)
        xs, nu, _ = K.prepare_inputs(x, cfg)
        ws, fs = K.prepare_weights(w, cfg)
        g = torch.Generator(device="cuda").manual_seed(n)
        for act in (None, "relu", "gelu", "silu", "sign", "identity"):
            for rows, by_bits in ((1, None), (5, 16), (5, 32)):
                es = torch.rand(rows, m, generator=g, device="cuda") * 1e-3
                pb = torch.randn(m, generator=g, device="cuda")
                y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, es, pb, act,
                                      by_bits)
                ref = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, es,
                                                  pb, act, by_bits)
                torch.cuda.synchronize()
                check(torch.allclose(y, ref, **FUSED_TOL),
                      f"fused kernel != plain on {case} {act} {by_bits}")
                worst = max(worst, float((y - ref).abs().max()))
                n_cmp += 1
    emit("kernel_vs_plain_cima_cases", comparisons=n_cmp, max_abs_err=worst,
         fused_tolerance=FUSED_TOL)
    return worst


def bound_ms(b, n, m, cfg, fused, peaks, extra_bytes=0):
    """Least time for the card: the larger of bytes over the memory rate
    (each input read once, the output written once; ``fused``: per-row
    scales, ``extra_bytes``: other epilogue registers) and int8 plane
    operations (two per multiply-add) over the int8 peak."""
    n_banks = -(-n // cfg.bank_n)
    nbytes = (n * cfg.ba * m + b * cfg.bx * n + 4 * b * n_banks
              + 4 * n_banks + 4 * b * m + (4 * b * m if fused else 0)
              + extra_bytes)
    ops = 2 * b * cfg.bx * cfg.ba * n * m
    t_bytes, t_ops = nbytes / peaks[0], ops / peaks[1]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_main_shapes(peaks):
    """The main path's projection shapes at B=4 (decode) and B=128
    (prefill rows): equality with the plain version, then device times of
    the kernel (back to back, ``device_ms``), the plain version and, for
    context only, torch.matmul of the integer grids (the ideal-ADC
    product, not the same function)."""
    cfg = BpbsConfig(ba=4, bx=4)
    rows = {}
    worst = 0.0
    for name, n, m, fused, per_fwd in MAIN_SHAPES:
        for b in MAIN_ROWS:
            g = torch.Generator(device="cuda").manual_seed(n * 7 + m + b)
            x = torch.randn(b, n, generator=g, device="cuda")
            w = torch.randn(n, m, generator=g, device="cuda") * n ** -0.5
            qx = quantize(x, cfg.bx, cfg.coding, per_row=True)
            qw = quantize(w, cfg.ba, cfg.coding, axis=1)
            xs, nu, _ = K.prepare_inputs(qx.q.to(torch.int8), cfg)
            ws, fs = K.prepare_weights(qw.q, cfg)
            epi = ((qx.scale * qw.scale.reshape(1, -1)).contiguous(), None,
                   "silu", None) if fused else (None, None, None, None)
            y = K.cima_mvm_planes(xs, ws, nu, fs, cfg, *epi)
            ref = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg, *epi)
            torch.cuda.synchronize()
            if fused:
                check(torch.allclose(y, ref, **FUSED_TOL),
                      f"fused kernel != plain on {name} B={b}")
            else:
                check(torch.equal(y, ref), f"kernel != plain on {name} B={b}")
            err = float((y - ref).abs().max())
            worst = max(worst, err)
            # rotate weight copies (>= 128 MB in all) so the 50 MB L2 cannot
            # hold the planes between launches, as in a real forward pass
            copies = [ws] + [ws.clone() for _ in
                             range(max(0, -(-(128 << 20) // ws.numel()) - 1))]
            t_kernel = device_ms(lambda i: K.cima_mvm_planes(
                xs, copies[i % len(copies)], nu, fs, cfg, *epi))
            t_plain = median_ms(lambda i: K.cima_mvm_planes_reference(
                xs, copies[i % len(copies)], nu, fs, cfg, *epi), reps=5,
                warmup=1)
            xq, wq = qx.q.to(torch.float32), qw.q
            t_mm = median_ms(lambda i: torch.matmul(xq, wq), reps=10)
            bms, by, nbytes, n_ops = bound_ms(b, n, m, cfg, fused, peaks)
            rows[(name, b)] = dict(ms=t_kernel, plain_ms=t_plain,
                                   bound_ms=bms, bound_by=by)
            mt, tb, cs = K.launch_shape(b, n, m, cfg, K._sm_count(0))
            emit("main_shape", name=name, b=b, n=n, m=m,
                 fused_silu_per_row=fused, launches_per_forward=per_fwd,
                 max_abs_err=err, kernel_ms=t_kernel, plain_ms=t_plain,
                 bound_ms=bms, bound_by=by, times_bound=t_kernel / bms,
                 achieved_tb_per_s=nbytes / t_kernel / 1e9,
                 achieved_int8_tops=n_ops / t_kernel / 1e9,
                 m16_tiles=mt, batch_rows_per_block=tb, cluster=cs,
                 matmul_ideal_adc_context_ms=t_mm)
            del copies
    return rows, worst


def device_profile(step, t_step_ms: float, steps: int = 3) -> dict:
    """Device work of ``step`` (called ``steps`` times) from a
    torch.profiler trace: the union of the device kernels' time intervals
    per step, its share of the unprofiled step time ``t_step_ms``, the
    device kernels per step, and the five kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy_ms = busy_us / 1e3 / steps if kernels else None
    cima_ms = sum(t for n, t in by_name.items() if "cima_mvm" in n)
    return dict(
        steps=steps, device_kernels_per_step=len(kernels) / steps,
        device_busy_ms_per_step=busy_ms,
        cima_mvm_ms_per_step=cima_ms / 1e3 / steps,
        device_idle_share=(None if busy_ms is None
                           else 1.0 - busy_ms / t_step_ms),
        top_kernels_ms_per_step=[(n[:80], t / 1e3 / steps) for n, t in top])


def decode_profile(engine, tok, cache, t_decode: float, steps: int = 3):
    """Device work in a decode step (``device_profile`` of ``steps``
    greedy steps)."""
    state = [tok, cache]

    def step():
        out, state[1] = engine.decode(state[0], state[1])
        state[0] = torch.argmax(out, -1)

    return device_profile(step, t_decode * 1e3, steps)


def greedy_agreement(a: np.ndarray, b: np.ndarray) -> int:
    return int((a == b).sum())


def phase_serve(peaks):
    """Full-width olmo-1b served through the kernel, then the plain path."""
    cfg = get_config("olmo-1b").with_accel("kernel", ba=4, bx=4)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    scfg = ServeConfig(max_seq=256, max_new_tokens=16)
    t0 = time.perf_counter()
    engine = Engine(params, cfg, scfg, device="cuda")
    torch.cuda.synchronize()
    t_program = time.perf_counter() - t0
    check(engine.program is not None
          and len(engine.program.images) == 8, "program images missing")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=g,
                            device="cuda")

    # the main path: counts at 0 just before, read just after
    K.cima_mvm_planes.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate(prompts)
    t_generate = time.perf_counter() - t0
    launches = K.cima_mvm_planes.launches
    steps = engine.last_decode_steps
    check(tokens.shape == (4, 16), f"tokens shape {tokens.shape}")
    check(((tokens >= 0) & (tokens < cfg.vocab)).all(), "token out of vocab")
    check(steps == 15, f"{steps} decode steps, expected 15")
    check(launches == LAUNCHES_PER_FORWARD * (1 + steps),
          f"{launches} kernel launches for {1 + steps} forwards")

    # timed prefill and decode steps, counted per forward
    K.cima_mvm_planes.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine.prefill(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(K.cima_mvm_planes.launches == LAUNCHES_PER_FORWARD,
          f"prefill launched {K.cima_mvm_planes.launches}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    tok = torch.argmax(logits, -1)
    step_s = []
    for _ in range(15):
        K.cima_mvm_planes.launches = 0
        t0 = time.perf_counter()
        out, cache = engine.decode(tok, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(K.cima_mvm_planes.launches == LAUNCHES_PER_FORWARD,
              f"decode step launched {K.cima_mvm_planes.launches}")
        tok = torch.argmax(out, -1)
    t_decode = statistics.median(step_s)
    profile = decode_profile(engine, tok, cache, t_decode)
    emit("serve_kernel", config="olmo-1b", layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab, batch=4,
         prompt=32, new_tokens=16, max_seq=256, init_params_s=t_init,
         program_build_s=t_program, generate_s=t_generate,
         generate_tokens_per_s=4 * 16 / t_generate, prefill_ms=t_prefill * 1e3,
         decode_ms_per_step=t_decode * 1e3,
         decode_tokens_per_s=4 / t_decode,
         kernel_launches_generate=launches,
         launches_per_forward=LAUNCHES_PER_FORWARD,
         tokens=tokens.tolist())
    emit("decode_profile", **profile)

    # the plain path on the same engine and image: no kernel launches
    K.cima_mvm_planes.launches = 0
    with accel.override(backend="bpbs"):
        plain_logits, _ = engine.prefill(prompts)
        plain_tokens = engine.generate(prompts)
    check(K.cima_mvm_planes.launches == 0, "the plain path launched kernels")
    diff = float((logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    # the fused silu and the bf16 casts after it may round differently on
    # the two paths; a wrong kernel moves logits by their own magnitude
    check(diff <= 0.05 * scale, f"prefill logits differ by {diff} "
          f"(max |logit| {scale})")
    emit("serve_plain_vs_kernel", prefill_logits_max_abs_diff=diff,
         prefill_logits_max_abs=scale, tolerance_rel=0.05,
         greedy_tokens_agree=greedy_agreement(tokens, plain_tokens),
         greedy_tokens_total=int(tokens.size))
    return launches


def replay_schedule(budgets, n_slots: int, cap) -> dict:
    """The batcher's stats as its admission loop fixes them when no
    request stops early: a host-side replay of ContinuousBatcher.run with
    budgets in place of sampled tokens."""
    pending = list(budgets)
    left = [0] * n_slots             # tokens still to decode per slot
    stats = {"decode_steps": 0, "slot_steps": 0, "prefills": 0,
             "generated_tokens": 0}
    while True:
        admitted = 0
        for i in range(n_slots):
            while (left[i] == 0 and pending
                   and (cap is None or admitted < cap)):
                budget = pending.pop(0)
                if budget <= 0:
                    continue
                stats["prefills"] += 1
                stats["generated_tokens"] += 1
                admitted += 1
                left[i] = budget - 1
        active = sum(1 for n in left if n)
        if not active:
            if pending:
                continue
            return stats
        stats["decode_steps"] += 1
        stats["slot_steps"] += active
        stats["generated_tokens"] += active
        left = [max(0, n - 1) for n in left]


def top2_gap(engine, prompt, tokens, step: int):
    """The top-2 logit gap and max |logit| of a solo run of ``prompt`` at
    ``step`` (0 = the prefill), teacher-forced on ``tokens``."""
    logits, cache = engine.prefill(
        torch.as_tensor(prompt[None], device="cuda"))
    for t in range(step):
        logits, cache = engine.decode(
            torch.as_tensor(tokens[t:t + 1], device="cuda"), cache)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def phase_serve_batcher():
    """Full-width olmo-1b through the slot-level continuous batcher:
    ragged prompts and budgets, no EOS."""
    cfg = get_config("olmo-1b").with_accel("kernel", ba=4, bx=4)
    scfg = ServeConfig(max_seq=256, max_new_tokens=16, eos_id=-1)
    cb = ContinuousBatcher(init_params(cfg, 0, device="cuda"), cfg, scfg,
                           BATCH_SLOTS, device="cuda")
    r = np.random.default_rng(2)
    prompts = [r.integers(0, cfg.vocab, (n,)) for n in BATCH_PROMPTS]
    rids = [cb.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BATCH_BUDGETS)]
    torch.cuda.synchronize()

    # the batcher's path: counts at 0 just before, read just after
    K.cima_mvm_planes.launches = 0
    t0 = time.perf_counter()
    results = cb.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.cima_mvm_planes.launches
    stats = dict(cb.stats)
    want = replay_schedule(BATCH_BUDGETS, BATCH_SLOTS,
                           scfg.max_admit_per_step)
    check(stats == want, f"batcher stats {stats} != schedule {want}")
    forwards = stats["decode_steps"] + stats["prefills"]
    check(launches == LAUNCHES_PER_FORWARD * forwards,
          f"{launches} cima_mvm launches for {forwards} forwards")
    for rid, m in zip(rids, BATCH_BUDGETS):
        check(len(results[rid]) == m, f"request {rid}: {len(results[rid])} "
              f"tokens for a budget of {m}")
        check(all(0 <= t < cfg.vocab for t in results[rid]),
              f"request {rid}: token out of vocab")

    # every stream against a solo Engine.generate of the same request
    equal = total = 0
    near_ties = []
    for rid, p, m in zip(rids, prompts, BATCH_BUDGETS):
        solo = cb.engine.generate(torch.as_tensor(p[None], device="cuda"),
                                  request_ids=[rid])[0][:m].tolist()
        got = results[rid]
        equal += sum(a == b for a, b in zip(got, solo))
        total += m
        if got != solo:
            step = next(t for t, (a, b) in enumerate(zip(got, solo))
                        if a != b)
            gap, scale = top2_gap(cb.engine, p, solo, step)
            tie = dict(request=rid, step=step, batcher=got[step],
                       solo=solo[step], top2_gap=gap, logit_scale=scale)
            print(f"chip_smoke: near-tie check {tie}", flush=True)
            check(gap < NEAR_TIE_REL * scale,
                  f"request {rid} leaves solo generate at step {step} "
                  f"with a top-2 gap of {gap} (logit scale {scale})")
            near_ties.append(tie)
    emit("serve_batcher", config="olmo-1b", slots=BATCH_SLOTS,
         prompt_lengths=list(BATCH_PROMPTS), budgets=list(BATCH_BUDGETS),
         max_admit_per_step=scfg.max_admit_per_step, **stats,
         slot_utilisation=stats["slot_steps"] / (stats["decode_steps"]
                                                 * BATCH_SLOTS),
         run_s=seconds, tokens_per_s=stats["generated_tokens"] / seconds,
         cima_mvm_launches=launches, launches_per_forward=LAUNCHES_PER_FORWARD,
         tokens_equal_to_solo=equal, tokens_total=total,
         near_ties=near_ties)


def fa_errors(o, ref):
    """(max |o - ref|, max of |o - ref| / (FA_BF16_RTOL |ref| +
    FA_BF16_ATOL)): a bf16 output passes when the first is within
    FA_ATOL and the second within 1."""
    diff = (o.float() - ref.float()).abs()
    limit = FA_BF16_RTOL * ref.float().abs() + FA_BF16_ATOL
    return float(diff.max()), float((diff / limit).max())


def check_bf16(o, ref, what: str) -> tuple:
    err, ratio = fa_errors(o, ref)
    check(err <= FA_ATOL[torch.bfloat16] and ratio <= 1.0,
          f"flash kernel != plain on {what}: max abs err {err}, max "
          f"err/limit {ratio}")
    return err, ratio


def phase_flash_cases() -> float:
    """The flash kernel against its plain version on FA_CASES."""
    worst = dict.fromkeys(FA_ATOL, 0.0)
    worst_ratio = 0.0
    for case in FA_CASES:
        b, h, hkv, s, d, causal, window, bq, bk, dtype = case
        r = np.random.default_rng(1)
        q, k, v = (torch.tensor(r.normal(size=shape), dtype=dtype,
                                device="cuda")
                   for shape in ((b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        o = FA.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        ref = FA.flash_attention_reference(q, k, v, causal, window)
        torch.cuda.synchronize()
        check(o.dtype == dtype and o.shape == q.shape,
              f"flash output {o.dtype} {tuple(o.shape)} on {case}")
        if dtype == torch.bfloat16:
            err, ratio = check_bf16(o, ref, str(case))
            worst_ratio = max(worst_ratio, ratio)
        else:
            err = float((o - ref).abs().max())
            check(err <= FA_ATOL[dtype], f"flash kernel != plain on "
                  f"{case}: max abs err {err}")
        worst[dtype] = max(worst[dtype], err)
    emit("flash_cases", cases=len(FA_CASES),
         max_abs_err={str(k): v for k, v in worst.items()},
         atol={str(k): v for k, v in FA_ATOL.items()},
         bf16_max_err_over_limit=worst_ratio,
         bf16_limit=f"{FA_BF16_RTOL}*|ref| + {FA_BF16_ATOL}")
    return max(worst.values())


def visible_pairs(s: int, window) -> int:
    """Unmasked (query, key) pairs of causal attention over ``s`` tokens
    with an optional window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(h, hkv, d, s, window, peaks):
    """Least time for the card: the larger of q, k, v read once and the
    output written once over the memory rate, and 4*D operations per
    visible pair per head over the bf16 tensor-core rate."""
    nbytes = 2 * d * s * (2 * h + 2 * hkv)
    ops = 4 * d * visible_pairs(s, window) * h
    t_bytes, t_ops = nbytes / peaks[0], ops / peaks[2]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def phase_flash_main_shapes(peaks):
    """ops.flash_attention at full width, then per shape: the kernel
    against its plain version head by head (every head), and device times
    of the kernel, the plain version (summed over heads) and SDPA."""
    inputs = []
    for name, h, hkv, d, s, window in FA_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s + d)
        inputs.append([torch.randn(1, n, s, d, generator=g, device="cuda",
                                   dtype=torch.bfloat16)
                       for n in (h, hkv, hkv)])
    torch.cuda.synchronize()
    # the kernel's path: counts at 0 just before, read just after
    FA.flash_attention.launches = 0
    outs = [ops.flash_attention(q, k, v, causal=True, window=shape[5])
            for shape, (q, k, v) in zip(FA_SHAPES, inputs)]
    torch.cuda.synchronize()
    launches = FA.flash_attention.launches
    check(launches == len(FA_SHAPES), f"{launches} flash launches for "
          f"{len(FA_SHAPES)} calls")
    rows = []
    for (name, h, hkv, d, s, window), (q, k, v), o in zip(FA_SHAPES, inputs,
                                                          outs):
        check(bool(torch.isfinite(o).all()), f"non-finite output on {name}")
        g = h // hkv
        err, ratio, plain_ms = 0.0, 0.0, 0.0
        for head in range(h):
            qh = q[:, head:head + 1]
            kh, vh = (t[:, head // g:head // g + 1] for t in (k, v))
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            ref = FA.flash_attention_reference(qh, kh, vh, True, window)
            b.record()
            torch.cuda.synchronize()
            plain_ms += a.elapsed_time(b)
            e, r = check_bf16(o[:, head:head + 1], ref,
                              f"{name} head {head}")
            err, ratio = max(err, e), max(ratio, r)
            del ref
        # rotate input copies (>= 128 MB in all) so L2 starts cold
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
        copies = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                                for _ in range(-(-(128 << 20) // nbytes) - 1)]
        reps = 5 if s > 10000 else 15
        t_kernel = median_ms(lambda i: FA.flash_attention(
            *copies[i % len(copies)], causal=True, window=window), reps=reps)
        mask = None
        if window is not None:
            ar = torch.arange(s, device="cuda")
            mask = (ar[:, None] >= ar[None, :]) & (ar[None, :]
                                                   > ar[:, None] - window)

        def sdpa(i):
            qc, kc, vc = copies[i % len(copies)]
            return torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        t_lib = median_ms(sdpa, reps=reps)
        bms, by, n_ops = flash_bound(h, hkv, d, s, window, peaks)
        row = dict(name=name, heads=h, kv_heads=hkv, head_dim=d, seq=s,
                   window=window, dtype="bfloat16", max_abs_err=err,
                   max_err_over_limit=ratio,
                   ms=t_kernel, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, operations=n_ops,
                   times_bound=t_kernel / bms,
                   achieved_tflop_per_s=n_ops / t_kernel / 1e9,
                   library_ms=t_lib,
                   library=("scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True)" if mask is None else
                            "scaled_dot_product_attention(attn_mask=dense "
                            "bool causal-window mask, enable_gqa=True)"),
                   plain="head by head, summed")
        emit("flash_main_shape", **row)
        rows.append(row)
        del copies, mask
    emit("flash_planted_faults", **planted_faults(inputs, outs))
    del inputs, outs
    torch.cuda.empty_cache()
    return rows, launches


def planted_faults(inputs, outs) -> dict:
    """The bf16 limit must reject faults that show only at full width.
    The kernel's output is held to plain versions with a fault planted:
    on olmo-1b 32k (head 0, last 128 queries) one 64-key tile in the
    middle is dropped; on recurrentgemma-9b (head 0) the window is one
    key shorter.  Each must exceed the limit (max err/limit > 1)."""
    (q, k, v), o = inputs[0], outs[0]
    s, d = q.shape[2], q.shape[3]
    rows = torch.arange(s - 128, s, device="cuda")
    cols = torch.arange(s, device="cuda")
    dropped = (cols >= s // 2) & (cols < s // 2 + 64)
    mask = (rows[:, None] >= cols[None, :]) & ~dropped[None, :]
    sc = (q[0, 0, -128:].float() * (1.0 / d ** 0.5)) @ k[0, 0].float().T
    sc = torch.where(mask, sc, FA.NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    ref = ((p @ v[0, 0].float()) / p.sum(-1, keepdim=True)).bfloat16()
    _, tile = fa_errors(o[0, 0, -128:], ref)
    (q, k, v), o = inputs[1], outs[1]
    window = FA_SHAPES[1][5]
    ref = FA.flash_attention_reference(q[:, :1], k, v, True, window - 1)
    _, edge = fa_errors(o[:, :1], ref)
    faults = {"olmo-1b 32k, one kv tile dropped": tile,
              f"recurrentgemma-9b, window {window - 1}": edge}
    for what, ratio in faults.items():
        check(ratio > 1.0, f"planted fault ({what}) passes the bf16 limit: "
              f"max err/limit {ratio}")
    return {"max_err_over_limit": faults}


@contextlib.contextmanager
def routed_launches(fn, keep=True):
    """Route the kernel backend's ``cima_mvm_planes`` calls to ``fn`` (the
    kernel's wrapper or its plain version, on the same device) and, with
    ``keep``, record each call's arguments and output, in call order."""
    launch, calls = K.cima_mvm_planes, []

    def record(*args):
        out = fn(*args)
        if keep:
            calls.append((args, out))
        return out

    # the kernel's wrapper counts on whatever the module's name holds
    record.launches = launch.launches
    K.cima_mvm_planes = record
    try:
        yield calls
    finally:
        K.cima_mvm_planes = launch
        launch.launches = record.launches


def cifar_layer_kernel(args, out, peaks):
    """One layer's launch, as the forward made it (``args``, ``out``): the
    output held to the plain version on the same arguments, then both
    timed."""
    xs, ws, nu, fs, cfg, escale, pbias, act, by_bits = args
    rows, n, m = xs.shape[0], xs.shape[2], ws.shape[2]
    ref = K.cima_mvm_planes_reference(*args)
    torch.cuda.synchronize()
    check(torch.allclose(out, ref, **FUSED_TOL),
          f"fused kernel != plain at {n}x{m}, {rows} rows")
    err = float((out - ref).abs().max())
    # weights rotated over >= 128 MB, as a forward finds them: cold in L2
    copies = [ws] + [ws.clone() for _ in
                     range(max(0, -(-(128 << 20) // ws.numel()) - 1))]
    rest = args[2:]
    t_kernel = device_ms(lambda i: K.cima_mvm_planes(
        xs, copies[i % len(copies)], *rest), reps=10)
    t_plain = median_ms(lambda i: K.cima_mvm_planes_reference(
        xs, copies[i % len(copies)], *rest), reps=3, warmup=1)
    epilogue = sum(4 * t.numel() for t in (escale, pbias)
                   if torch.is_tensor(t))
    bms, by, nbytes, n_ops = bound_ms(rows, n, m, cfg, False, peaks,
                                      extra_bytes=epilogue)
    mt, tb, cs = K.launch_shape(rows, n, m, cfg, K._sm_count(0))
    del copies
    return dict(rows=rows, n=n, m=m, ba=cfg.ba, bx=cfg.bx, act=act,
                max_abs_err=err, bitwise=bool(torch.equal(out, ref)),
                ms=t_kernel, plain_ms=t_plain, bound_ms=bms, bound_by=by,
                times_bound=t_kernel / bms,
                achieved_tb_per_s=nbytes / t_kernel / 1e9,
                achieved_int8_tops=n_ops / t_kernel / 1e9,
                m16_tiles=mt, batch_rows_per_block=tb, cluster=cs)


def phase_cifar(peaks, nets=(NETWORK_A, NETWORK_B), batch=CIFAR_BATCH):
    """The paper's CIFAR-10 networks at full width on the kernel, from a
    seed: BN running statistics from one train=True forward, then the
    eval forward (the main path), held to the kernel's plain version
    layer by layer; per-layer launches timed beside their bounds; the
    forward timed; a traced forward priced on the 65 nm chip model."""
    rows, launches, worst = [], 0, 0.0
    for k, net in enumerate(nets):
        g = torch.Generator(device="cuda").manual_seed(100 + k)
        params = init_cnn(k, net, device="cuda")
        train = torch.randn(batch, 32, 32, 3, generator=g, device="cuda")
        _, stats = cnn_forward(params, train, net, train=True)
        params = update_bn_stats(params, stats)
        images = torch.randn(batch, 32, 32, 3, generator=g, device="cuda")
        torch.cuda.synchronize()

        # the main path: counts at 0 just before, read just after; each
        # launch's arguments and output are kept for the checks below
        launch = K.cima_mvm_planes
        launch.launches = 0
        with routed_launches(launch) as calls:
            logits = cnn_forward(params, images, net)
        torch.cuda.synchronize()
        n_launch = launch.launches
        check(n_launch == CIFAR_LAUNCHES == len(calls),
              f"{net.name}: {n_launch} cima_mvm launches a forward")
        launches += n_launch
        check(tuple(logits.shape) == (batch, net.n_classes)
              and bool(torch.isfinite(logits).all()),
              f"{net.name}: logits {tuple(logits.shape)} not finite")

        # the same forward on the kernel's plain version
        with routed_launches(K.cima_mvm_planes_reference) as plain:
            plain_logits = cnn_forward(params, images, net)
        check(launch.launches == n_launch and len(plain) == CIFAR_LAUNCHES,
              f"{net.name}: the plain version launched the kernel")
        check(torch.allclose(logits, plain_logits, **FUSED_TOL),
              f"{net.name}: logits differ from the plain version by "
              f"{float((logits - plain_logits).abs().max())}")
        same_pred = int((logits.argmax(-1) == plain_logits.argmax(-1)).sum())
        check(same_pred == batch, f"{net.name}: {batch - same_pred} "
              "predictions differ from the plain version")
        hidden_equal = [bool(torch.equal(a[1], b[1]))
                        for a, b in zip(calls[:-1], plain[:-1])]
        if net.readout == "abn":
            check(all(hidden_equal), f"{net.name}: hidden activations "
                  f"differ from the plain version: {hidden_equal}")
        del plain
        # the other plain path: the bpbs backend rounds the rescale and
        # the folded BN in another order, so a requantized activation may
        # move by one grid step; a wrong kernel moves logits by their size
        with accel.override(backend="bpbs"):
            bpbs_logits = cnn_forward(params, images, net)
        bpbs_diff = float((logits - bpbs_logits).abs().max())
        scale = float(bpbs_logits.abs().max())
        check(bpbs_diff <= 0.05 * scale, f"{net.name}: logits differ from "
              f"the bpbs backend by {bpbs_diff} (max |logit| {scale})")

        layers = []
        for i, (args, out) in enumerate(calls):
            row = cifar_layer_kernel(args, out, peaks)
            worst = max(worst, row["max_abs_err"])
            layers.append(dict(layer=i, **row))
            emit("cifar_layer", net=net.name, **layers[-1])
        del calls
        t_fwd = median_ms(lambda i: cnn_forward(params, images, net), reps=10)
        profile = device_profile(lambda: cnn_forward(params, images, net),
                                 t_fwd)
        with routed_launches(K.cima_mvm_planes_reference) as plain:
            t_plain = median_ms(lambda i: (plain.clear(), cnn_forward(
                params, images, net)), reps=3, warmup=1)
        with accel.trace(vdd=0.85) as tr:
            cnn_forward(params, images, net)
        es = accel.energy_summary(tr, readout=net.readout)
        cost_net, cost_kw = CIFAR_COST[net.name]
        cost = E.network_cost(cost_net, net.ba, net.bx, vdd=0.85, **cost_kw)
        paper_uj, paper_fps = CIFAR_PAPER[net.name]
        row = dict(
            net=net.name, batch=batch, ba=net.ba, bx=net.bx,
            readout=net.readout, layers=len(net.layers),
            cima_mvm_launches=n_launch,
            logits_max_abs_err_vs_plain=float(
                (logits - plain_logits).abs().max()),
            predictions_equal_to_plain=same_pred,
            hidden_activations_equal_to_plain=hidden_equal,
            logits_max_abs_diff_vs_bpbs_backend=bpbs_diff,
            predictions_equal_to_bpbs_backend=int(
                (logits.argmax(-1) == bpbs_logits.argmax(-1)).sum()),
            ms_per_batch=t_fwd, images_per_s=batch / t_fwd * 1e3,
            plain_ms_per_batch=t_plain,
            kernel_ms_sum=sum(r["ms"] for r in layers),
            kernel_plain_ms_sum=sum(r["plain_ms"] for r in layers),
            kernel_bound_ms_sum=sum(r["bound_ms"] for r in layers),
            forward_profile=profile,
            chip_model={
                "what": "65 nm chip cost model (core.energy), not the card",
                "vdd": es["vdd"],
                "uj_per_image": es["total_pj"] / batch / 1e6,
                "fps": E.F_CLK[es["vdd"]] / (es["total_cycles"] / batch),
                "input_sparsity": es["input_sparsity"],
                "plane_skip": es["plane_skip"],
                "network_cost_uj_per_image": cost["energy_uj"],
                "network_cost_fps": cost["fps"],
                "paper_uj_per_image": paper_uj, "paper_fps": paper_fps})
        emit("cifar_networks", **row)
        rows.append(dict(row, layer_rows=layers))
        del params, images, train, logits
        torch.cuda.empty_cache()
    return rows, launches, worst


def host_syncs(fn) -> list:
    """Where ``fn`` synchronises with the device, as torch's sync debug
    mode reports it: one ``file:line`` per synchronising call (the mode's
    one-time note that it is a prototype is not one)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def phase_serve_energy(arch="olmo-1b", chips=SERVE_CHIPS, cfg=None):
    """Full-width olmo-1b from a program that streams its tail: a traced
    decode step priced on the chip model, then tokens and an untraced
    decode step held to the all-resident engine."""
    cfg = cfg or get_config(arch).with_accel("kernel", ba=4, bx=4)
    params = init_params(cfg, 0, device="cuda")
    engines = {
        name: Engine(params, cfg, ServeConfig(max_seq=256, max_new_tokens=8,
                                              cima_chips=c), device="cuda")
        for name, c in (("streamed", chips), ("resident", None))}
    streamed = engines["streamed"]
    summary = streamed.program.summary()
    check(summary["streamed"], f"nothing streams at {chips} chips")
    check(engines["resident"].program.summary()["streamed"] == [],
          "the all-resident program streams")
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (4, 32), generator=g,
                            device="cuda")
    logits, cache = streamed.prefill(prompts)
    tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()

    # the traced path: counts at 0 just before, read just after
    K.cima_mvm_planes.launches = 0
    with accel.trace(vdd=1.2) as tr:
        streamed.decode(tok, cache)
    torch.cuda.synchronize()
    launches = K.cima_mvm_planes.launches
    check(launches == LAUNCHES_PER_FORWARD,
          f"traced decode launched {launches}")
    check(len(tr) == LAUNCHES_PER_FORWARD, f"{len(tr)} records a forward")
    loaded = sorted({r.tag for r in tr if r.loads})
    check(loaded == sorted(set(summary["streamed"])),
          f"loads on {loaded}, streamed {summary['streamed']}")
    check(sum(r.load_prologue for r in tr) == 1, "not one prologue")
    check(sum(r.loads * r.load_segments for r in tr)
          == streamed.program.reload_segments_per_pass(),
          "traced reloads differ from the program's schedule")
    es = accel.energy_summary(tr)
    # the JAX package traces its layer stack inside a scan, where it
    # measures no sparsity: its figure is the same records' with the
    # measured fields cleared (the uniform assumption, 0)
    es_ref = accel.energy_summary(
        [dataclasses.replace(r, sparsity=None, planes_skipped=None,
                             planes_total=None) for r in tr], vdd=tr.vdd)

    gen = {name: e.generate(prompts) for name, e in engines.items()}
    check(np.array_equal(gen["streamed"], gen["resident"]),
          "streamed tokens differ from the all-resident engine's")
    # an untraced decode step after a warm one, on each engine
    syncs, step_launches = {}, {}
    for name, e in engines.items():
        logits, cache = e.prefill(prompts)
        out, cache = e.decode(torch.argmax(logits, -1), cache)
        tok = torch.argmax(out, -1)
        torch.cuda.synchronize()
        K.cima_mvm_planes.launches = 0
        syncs[name] = host_syncs(lambda: e.decode(tok, cache))
        torch.cuda.synchronize()
        step_launches[name] = K.cima_mvm_planes.launches
    check(step_launches["streamed"] == LAUNCHES_PER_FORWARD,
          f"untraced decode launched {step_launches['streamed']}")
    check(len(syncs["streamed"]) == len(syncs["resident"]),
          f"host syncs of an untraced decode step: {syncs}")
    check(len(host_syncs(lambda: tok.sum().item())) == 1,
          "the sync detector does not see an .item()")
    emit("serve_energy", config=arch, cima_chips=chips, batch=4,
         tiles_total=summary["tiles_total"],
         tiles_resident=summary["tiles_resident"],
         streamed=summary["streamed"],
         reload_cycles_per_pass=summary["reload_cycles_per_pass"],
         traced_records=len(tr), traced_launches=launches,
         load_prologues=sum(r.load_prologue for r in tr),
         chip_model={
             "what": "65 nm chip cost model (core.energy), not the card",
             "vdd": es["vdd"], "total_pj": es["total_pj"],
             "total_cycles": es["total_cycles"],
             "load_cycles": es["load_cycles"],
             "load_cycles_hidden": es["load_cycles_hidden"],
             "load_cycles_exposed": es["load_cycles_exposed"],
             "uj_per_token": es["total_pj"] / 4 / 1e6,
             "input_sparsity": es["input_sparsity"],
             "plane_skip": es["plane_skip"],
             "as_the_jax_package_reports_it": {
                 "what": "measured sparsity and plane skip cleared, as "
                         "the reference's scanned decode records them",
                 "total_pj": es_ref["total_pj"],
                 "total_cycles": es_ref["total_cycles"],
                 "uj_per_token": es_ref["total_pj"] / 4 / 1e6}},
         tokens_equal_to_resident=int((gen["streamed"]
                                       == gen["resident"]).sum()),
         tokens_total=int(gen["resident"].size),
         untraced_decode_launches=step_launches["streamed"],
         untraced_decode_host_syncs=syncs)
    del engines, params
    torch.cuda.empty_cache()
    return launches


def snapshot(tree) -> list:
    """The leaves of a parameter tree, detached copies, in tree order."""
    return [t.detach().clone() for t in leaves(tree)]


@contextlib.contextmanager
def backward_marks(module, name: str):
    """Wrap the loss function ``module.name`` that a training step calls:
    each loss it returns under autograd reads the kernel's launch count
    in a hook that fires as its backward pass starts.  Yields the list of
    those counts, one per backward, so a step's launches split into its
    forward's and its backward's."""
    loss_of, marks = getattr(module, name), []

    def marked(*args, **kw):
        loss, aux = loss_of(*args, **kw)
        if loss.requires_grad:
            loss.register_hook(
                lambda g: marks.append(K.cima_mvm_planes.launches))
        return loss, aux

    setattr(module, name, marked)
    try:
        yield marks
    finally:
        setattr(module, name, loss_of)


def timed_fwd_bwd(loss_of, params, reps: int = 3) -> tuple:
    """Median host-clock ms of a forward under autograd and of its
    backward pass, each ending in a synchronize."""
    fwd, bwd = [], []
    for _ in range(reps):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_of(p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, leaves(p), allow_unused=True)
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
        del p, loss
    return statistics.median(fwd), statistics.median(bwd)


def gap_sources(params, held_out, batches, net) -> dict:
    """Fig. 11's accuracies of one set of parameters on ``held_out``,
    taken apart to find where a chip-vs-ideal gap comes from: the kernel
    and ``bpbs`` (the chip model's independent torch path, which shares
    none of the kernel's glue), each with its per-bank ADC and with
    ``ideal_adc``; the ideal integer model and float; and the kernel and
    ideal model again with the running BN statistics replaced by the
    mean of the training batches' own statistics."""
    acc = {bk: fig11_accuracy(params, held_out, net, bk)
           for bk in ("kernel", "bpbs", "digital_int", "digital")}
    with accel.override(ideal_adc=True):
        for bk in ("kernel", "bpbs"):
            acc[f"{bk}_ideal_adc"] = fig11_accuracy(params, held_out, net, bk)
    with torch.no_grad():
        stats = [cnn_loss(params, b, net)[1]["bn_stats"] for b in batches]
    calibrated = {"layers": [
        {**p, "bn_mean": torch.stack([s[i][0] for s in stats]).mean(0),
         "bn_var": torch.stack([s[i][1] for s in stats]).mean(0)}
        for i, p in enumerate(params["layers"])]}
    for bk in ("kernel", "digital_int"):
        acc[f"{bk}_bn_calibrated"] = fig11_accuracy(calibrated, held_out,
                                                    net, bk)
    return acc


def phase_train_cifar(nets=(NETWORK_A, NETWORK_B), batch=CIFAR_BATCH,
                      steps=QAT_STEPS):
    """QAT of the paper's CIFAR networks at full width on the kernel
    (``train.cifar_qat.qat_update``, the main path), then the same steps
    with the kernel routed to its plain version: losses, parameters and
    running BN statistics equal after every step.  Launches of a step's
    forward and backward counted apart, the step timed and profiled, and
    Fig. 11's accuracies on held-out batches under the kernel, the ideal
    integer model and float."""
    data_cfg = DataConfig(kind="cifar_synthetic", global_batch=batch, seed=1)
    batches = [make_batch(data_cfg, s, "cuda") for s in range(steps)]
    held_out = [make_batch(data_cfg, 10_000 + i, "cuda")
                for i in range(QAT_EVAL_BATCHES)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps,
                          weight_decay=0.0)
    rows, total = [], 0
    for net in nets:
        params = init_cnn(0, net, device="cuda")
        opt = init_opt_state(params)
        torch.cuda.synchronize()

        # the main path: counts at 0 just before, read just after
        K.cima_mvm_planes.launches = 0
        traj, losses, step_ms, per_step = [], [], [], []
        with backward_marks(cifar_qat, "cnn_loss") as marks:
            for b in batches:
                n0 = K.cima_mvm_planes.launches
                t0 = time.perf_counter()
                params, opt, m = qat_update(params, opt, b, net, opt_cfg)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                n1 = K.cima_mvm_planes.launches
                per_step.append({"forward": marks[-1] - n0,
                                 "backward": n1 - marks[-1]})
                losses.append(m["loss"])
                traj.append(snapshot(params))
        launches = K.cima_mvm_planes.launches
        total += launches
        check(len(marks) == steps, f"{net.name}: {len(marks)} backward "
              f"passes in {steps} QAT steps")
        check(per_step == [{"forward": CIFAR_LAUNCHES, "backward": 0}] * steps,
              f"{net.name}: cima_mvm launches per QAT step {per_step}")
        losses = torch.stack(losses).tolist()
        check(all(np.isfinite(losses)), f"{net.name}: loss {losses}")

        # the same steps on the kernel's plain version
        plain = init_cnn(0, net, device="cuda")
        popt = init_opt_state(plain)
        worst, equal = 0.0, True
        with routed_launches(K.cima_mvm_planes_reference, keep=False):
            for s, b in enumerate(batches):
                plain, popt, pm = qat_update(plain, popt, b, net, opt_cfg)
                equal &= float(pm["loss"]) == losses[s]
                for a, c in zip(snapshot(plain), traj[s]):
                    equal &= bool(torch.equal(a, c))
                    worst = max(worst, float((a - c).abs().max()))
        check(K.cima_mvm_planes.launches == launches,
              f"{net.name}: the plain route launched the kernel")
        check(equal, f"{net.name}: QAT on the kernel differs from its "
              f"plain version (max abs {worst})")
        del traj, plain, popt

        t_fwd, t_bwd = timed_fwd_bwd(
            lambda p: cnn_loss(p, batches[0], net)[0], params)
        t_step = statistics.median(step_ms[1:])
        state = [params, opt]

        def one_step():
            state[0], state[1], _ = qat_update(state[0], state[1], batches[0],
                                               net, opt_cfg)

        profile = device_profile(one_step, t_step, steps=2)
        acc = gap_sources(params, held_out, batches, net)
        row = dict(
            net=net.name, batch=batch, steps=steps, ba=net.ba, bx=net.bx,
            readout=net.readout, cima_mvm_launches=launches,
            launches_per_step=per_step[0], loss_first=losses[0], loss_last=losses[-1], losses=losses,
            equal_to_plain_route=equal, max_abs_diff_vs_plain_route=worst,
            ms_per_step_median=t_step, ms_per_step=step_ms,
            images_per_s=batch / t_step * 1e3,
            forward_ms=t_fwd, backward_ms=t_bwd, step_profile=profile,
            fig11_accuracy_synthetic=acc,
            chip_vs_ideal_gap=abs(acc["kernel"] - acc["digital_int"]),
            chip_vs_ideal_gap_bn_calibrated=abs(
                acc["kernel_bn_calibrated"]
                - acc["digital_int_bn_calibrated"]),
            note="synthetic class-template data, not CIFAR-10")
        emit("train_cifar", **row)
        rows.append(row)
        del params, opt, state
        torch.cuda.empty_cache()
    return rows, total


def lm_run(cfg, batches, opt_cfg, route=None):
    """``LM_STEPS`` train steps of full-width olmo-1b from seed 0: per step
    the loss, gradient norm, kernel launches (the forward's and, remat's
    recomputation included, the backward's) and host-clock ms.  ``route``
    routes the kernel's launches to another function."""
    state = init_train_state(init_params(cfg, 0, device="cuda"))
    step_fn = build_train_step(cfg, opt_cfg)
    scope = (routed_launches(route, keep=False) if route is not None
             else contextlib.nullcontext())
    out = []
    torch.cuda.synchronize()
    with scope, backward_marks(train_step, "loss_fn") as marks:
        for b in batches:
            n0 = K.cima_mvm_planes.launches
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            n1 = K.cima_mvm_planes.launches
            out.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                            launches=n1 - n0,
                            launches_forward=marks[-1] - n0,
                            launches_backward_remat=n1 - marks[-1],
                            loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"])))
    check(len(marks) == len(batches),
          f"olmo-1b: {len(marks)} backward passes in {len(batches)} steps")
    return state, out


def phase_train_lm():
    """Full-width olmo-1b trained on the kernel (``build_train_step`` with
    AdamW, remat on: the main path), then the same steps with the kernel
    routed to its plain version; loss and gradient norm of each step
    compared bitwise, both runs under torch.use_deterministic_algorithms.
    Launches per step, ms, tokens/s, peak device memory, and a profiled
    step."""
    torch.use_deterministic_algorithms(True)
    try:
        return train_lm()
    finally:
        torch.use_deterministic_algorithms(False)


def train_lm():
    cfg = get_config("olmo-1b").with_accel("kernel", ba=4, bx=4)
    data_cfg = DataConfig(seq_len=LM_SEQ, global_batch=LM_BATCH,
                          vocab=cfg.vocab, seed=0)
    batches = [make_batch(data_cfg, s, "cuda") for s in range(LM_STEPS)]
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=200)
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before, read just after
    K.cima_mvm_planes.launches = 0
    state, steps = lm_run(cfg, batches, opt_cfg)
    launches = K.cima_mvm_planes.launches
    peak = torch.cuda.max_memory_allocated()
    split = [(s["launches_forward"], s["launches_backward_remat"])
             for s in steps]
    check(split == [(LAUNCHES_PER_FORWARD,
                     LM_LAUNCHES_PER_STEP - LAUNCHES_PER_FORWARD)] * LM_STEPS,
          f"olmo-1b train step launches (forward, backward) {split}")
    check(all(np.isfinite([s["loss"] for s in steps])),
          f"olmo-1b losses {steps}")
    n_params = sum(t.numel() for t in leaves(state.params))

    t_fwd, t_bwd = timed_fwd_bwd(lambda p: loss_fn(p, batches[0], cfg)[0],
                                 state.params, reps=2)
    t_step = statistics.median(s["ms"] for s in steps[1:])
    step_fn = build_train_step(cfg, opt_cfg)
    holder = [state]

    def one_step():
        holder[0], _ = step_fn(holder[0], batches[0])

    profile = device_profile(one_step, t_step, steps=1)
    del state, holder
    torch.cuda.empty_cache()

    before = K.cima_mvm_planes.launches
    _, plain = lm_run(cfg, batches, opt_cfg, route=K.cima_mvm_planes_reference)
    check(K.cima_mvm_planes.launches == before,
          "the plain route launched the kernel")
    for a, b in zip(steps, plain):
        for k in ("loss", "grad_norm"):
            check(a[k] == b[k],
                  f"olmo-1b {k} on the kernel {a[k]} vs plain {b[k]}")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    emit("train_lm", config="olmo-1b", layers=cfg.n_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab, seq=LM_SEQ,
         batch=LM_BATCH, remat=cfg.remat, parameters=n_params,
         cima_mvm_launches=launches,
         launches_per_step={"forward": split[0][0],
                            "backward_remat": split[0][1]},
         steps=steps, plain_route=plain, equal_to_plain_route_bitwise=True,
         ms_per_step_median=t_step,
         tokens_per_s=LM_SEQ * LM_BATCH / t_step * 1e3,
         forward_ms=t_fwd, backward_ms=t_bwd, step_profile=profile,
         max_memory_allocated_bytes=peak, device_memory_bytes=total_mem)
    torch.cuda.empty_cache()
    return launches


def phase_trainer_resume():
    """``train()`` on reduced olmo-1b with the kernel backend, into a
    directory under build/: an uninterrupted 6-step run, then a run that
    crashes at step 4 and resumes; the final loss must be the
    uninterrupted run's and the history must resume at step 4.  A
    ProgramManager passed in counts one invalidation per step."""
    cfg = get_config("olmo-1b").reduced().with_accel("kernel", ba=4, bx=4)
    data_cfg = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab,
                          seed=11)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    per_step = cfg.n_layers * 7 + 1
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    quiet = lambda s: None                              # noqa: E731
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        def tcfg(name, crash=None):
            return TrainerConfig(total_steps=6, ckpt_dir=f"{tmp}/{name}",
                                 ckpt_every=2, log_every=100,
                                 crash_at_step=crash)

        # the main path: counts at 0 just before, read just after
        K.cima_mvm_planes.launches = 0
        _, ref = train(cfg, data_cfg, opt_cfg, tcfg("ref"), log_fn=quiet)
        launches = K.cima_mvm_planes.launches
        check(launches == 6 * per_step, f"trainer launched {launches}")
        pm = accel.ProgramManager(cfg)
        crashed = False
        try:
            train(cfg, data_cfg, opt_cfg, tcfg("crash", 4), log_fn=quiet,
                  program_manager=pm)
        except CrashInjected:
            crashed = True
        check(crashed, "no injected crash")
        check(pm.invalidations == 4,
              f"{pm.invalidations} invalidations in 4 steps")
        _, res = train(cfg, data_cfg, opt_cfg, tcfg("crash"), log_fn=quiet)
    check(res[0]["step"] == 4, f"resumed at step {res[0]['step']}")
    check(ref[-1]["step"] == res[-1]["step"] == 5, "runs end at step 5")
    check(res[-1]["loss"] == ref[-1]["loss"],
          f"resumed final loss {res[-1]['loss']} vs {ref[-1]['loss']}")
    emit("trainer_resume", config="olmo-1b reduced", backend="kernel",
         steps=6, crash_at_step=4, resumed_at_step=res[0]["step"],
         final_loss=res[-1]["loss"], uninterrupted_final_loss=ref[-1]["loss"],
         losses=[h["loss"] for h in ref],
         invalidations_in_4_steps=pm.invalidations,
         cima_mvm_launches=launches, launches_per_step=per_step)
    return launches


def phase_noise():
    """ADC noise of ``bpbs`` on the card at ``NOISE_SIGMA``: one bank of
    255 rows (fs = 255, the clean ADC exact).  The code shift at the ADC
    over 2^20 integer popcounts against P(e = +-1); the error of ``y`` in
    the integer domain, ``2 sum wx wa e`` over the 16 plane pairs, whose
    variance is ``4 Var(e) sum wx^2 sum wa^2`` (within 5%); the same seed
    bitwise equal, two dispatches of one scope uncorrelated (|corr| <
    5/sqrt(n)).  No kernel launches; noisy and clean dispatch times."""
    r = np.random.default_rng(0)
    x = torch.tensor(r.normal(size=(NOISE_ROWS, NOISE_N)),
                     dtype=torch.float32, device="cuda")
    w = torch.tensor(r.normal(size=(NOISE_N, NOISE_M)), dtype=torch.float32,
                     device="cuda")
    spec = accel.ExecSpec(backend="bpbs", ba=4, bx=4, bank_n=NOISE_N,
                          adc_sigma_lsb=NOISE_SIGMA)
    clean = dataclasses.replace(spec, adc_sigma_lsb=0.0)

    # the path: counts at 0 just before, read just after
    K.cima_mvm_planes.launches = 0
    y0 = accel.matmul(x, w, clean)
    with accel.adc_noise(5):
        y1 = accel.matmul(x, w, spec)
        y2 = accel.matmul(x, w, spec)
    with accel.adc_noise(5):
        y1_again = accel.matmul(x, w, spec)
    launches = K.cima_mvm_planes.launches
    check(launches == 0, f"noisy bpbs launched the kernel {launches} times")

    p = torch.tensor(r.integers(20, 236, 1 << 20), dtype=torch.float32,
                     device="cuda")
    shift = adc_convert(p, 255.0, sigma_lsb=NOISE_SIGMA,
                        generator=torch.Generator(device="cuda").manual_seed(1)
                        ) - p
    n_p = shift.numel()
    p_shift = float(torch.sum(shift.abs() == 1)) / n_p
    var_e = float(torch.mean(shift ** 2))
    sd = math.sqrt(NOISE_P_SHIFT * (1 - NOISE_P_SHIFT) / n_p)
    check(abs(p_shift - NOISE_P_SHIFT) < 5 * sd,
          f"P(e = +-1) {p_shift} vs {NOISE_P_SHIFT}")

    qx = quantize(x, 4, Coding.XNOR)
    qw = quantize(w, 4, Coding.XNOR, axis=1)
    s = qx.scale * qw.scale.reshape(1, -1)
    e1, e2 = (((y - y0) / s).ravel() for y in (y1, y2))
    pred = 4.0 * NOISE_P_SHIFT * float(np.sum(
        plane_weights(4, Coding.XNOR) ** 2)) ** 2
    meas = float(torch.mean(e1 ** 2))
    corr = float(torch.corrcoef(torch.stack([e1, e2]))[0, 1])
    check(torch.equal(y1, y1_again), "same seed, different noise")
    check(not torch.equal(y1, y2), "two dispatches drew the same noise")
    check(abs(meas / pred - 1.0) < 0.05,
          f"noise variance {meas} vs analytic {pred}")
    check(abs(corr) < 5.0 / math.sqrt(e1.numel()),
          f"noise of two dispatches correlates: {corr}")

    def noisy(i):
        accel.matmul(x, w, spec)

    with accel.adc_noise(6):
        t_noisy = median_ms(noisy, reps=10)
    t_clean = median_ms(lambda i: accel.matmul(x, w, clean), reps=10)
    emit("noise", sigma_lsb=NOISE_SIGMA, rows=NOISE_ROWS, n=NOISE_N,
         m=NOISE_M, ba=4, bx=4, full_scale=255.0,
         code_shift_samples=n_p, p_shift_measured=p_shift,
         p_shift_analytic=NOISE_P_SHIFT, var_e_measured=var_e,
         y_error_var_measured=meas, y_error_var_analytic=pred,
         measured_over_analytic=meas / pred,
         corr_two_dispatches=corr, same_seed_bitwise=True,
         cima_mvm_launches=launches,
         bpbs_noisy_ms=t_noisy, bpbs_clean_ms=t_clean)


def noisy_loss(params, batch, net, seed: int = 0):
    """The noise-aware QAT loss (``qat_update``'s with ``noise_sigma``):
    ``cnn_loss`` on ``bpbs`` under ``noise_aware``."""
    with noise_aware(seed, NOISE_SIGMA):
        return cnn_loss(params, batch, net,
                        backend=cifar_qat.NOISY_BACKEND)[0]


def noisy_accuracy(params, batches, net) -> tuple:
    """Fig. 11 accuracy on ``bpbs`` with live noise: the mean over
    ``NOISE_SEEDS`` and each seed's."""
    per = [fig11_accuracy(params, batches, net, cifar_qat.NOISY_BACKEND,
                          NOISE_SIGMA, k) for k in NOISE_SEEDS]
    return sum(per) / len(per), per


def phase_noise_qat(nets=(NETWORK_A, NETWORK_B), batch=CIFAR_BATCH,
                    steps=QAT_STEPS):
    """Noise-aware QAT of full-width A and B at ``NOISE_SIGMA``
    (``qat_update`` with ``noise_sigma``: the loss forward on ``bpbs``
    under ``noise_aware``, seeded per step), 8 steps of 64 images: no
    kernel launch and no NOISELESS warning in the steps, ms per step,
    forward and backward apart, a profiled step; then Fig. 11 on the
    held-out batches: the kernel and ``digital_int`` noiseless, ``bpbs``
    noisy before and after ``calibrate_bn_stats``."""
    data_cfg = DataConfig(kind="cifar_synthetic", global_batch=batch, seed=1)
    batches = [make_batch(data_cfg, s, "cuda") for s in range(steps)]
    held_out = [make_batch(data_cfg, 10_000 + i, "cuda")
                for i in range(QAT_EVAL_BATCHES)]
    cal_batches = [make_batch(data_cfg, 20_000 + i, "cuda")
                   for i in range(NOISE_CAL_BATCHES)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps,
                          weight_decay=0.0)
    for net in nets:
        params = init_cnn(0, net, device="cuda")
        opt = init_opt_state(params)
        torch.cuda.synchronize()

        # the path: counts at 0 just before, read just after
        K.cima_mvm_planes.launches = 0
        step_ms, losses = [], []
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*NOISELESS")
            for s, b in enumerate(batches):
                t0 = time.perf_counter()
                params, opt, m = qat_update(params, opt, b, net, opt_cfg,
                                            NOISE_SIGMA, fold_seed(0, s))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"])
        launches = K.cima_mvm_planes.launches
        check(launches == 0, f"{net.name}: noisy QAT launched the kernel "
              f"{launches} times")
        losses = torch.stack(losses).tolist()
        check(all(np.isfinite(losses)), f"{net.name}: loss {losses}")
        t_step = statistics.median(step_ms[1:])
        t_fwd, t_bwd = timed_fwd_bwd(
            lambda p: noisy_loss(p, batches[0], net), params)
        state = [params, opt]

        def one_step():
            state[0], state[1], _ = qat_update(state[0], state[1], batches[0],
                                               net, opt_cfg, NOISE_SIGMA, 0)

        profile = device_profile(one_step, t_step, steps=2)
        del state
        acc = {bk: fig11_accuracy(params, held_out, net, bk)
               for bk in ("kernel", "digital_int")}
        acc["bpbs_noisy"], per = noisy_accuracy(params, held_out, net)
        cal = calibrate_bn_stats(params, cal_batches, net, 7, NOISE_SIGMA)
        acc["bpbs_noisy_calibrated"], per_cal = noisy_accuracy(cal, held_out,
                                                               net)
        emit("noise_qat", net=net.name, batch=batch, steps=steps,
             sigma_lsb=NOISE_SIGMA, backend=cifar_qat.NOISY_BACKEND,
             cima_mvm_launches=launches, losses=losses,
             ms_per_step_median=t_step, ms_per_step=step_ms,
             images_per_s=batch / t_step * 1e3, forward_ms=t_fwd,
             backward_ms=t_bwd, step_profile=profile,
             fig11_accuracy_synthetic=acc, noise_seeds=NOISE_SEEDS,
             bpbs_noisy_per_seed=per, bpbs_noisy_calibrated_per_seed=per_cal,
             calibration_batches=NOISE_CAL_BATCHES,
             note="synthetic class-template data, not CIFAR-10")
        del params, opt, cal
        torch.cuda.empty_cache()


def phase_noise_corner():
    """The reference's 0.85 V acceptance recipe on the card
    (``tests/test_sparsity_noise.py::test_cifar_accuracy_holds_at_085v_
    corner``): reduced Network A, 60 noise-aware QAT steps of 32 images
    at lr 3e-3, BN calibrated under noise on 8 batches, accuracy on 8
    held-out batches noiseless and noisy (mean of 3 seeds).  The port's
    own init and synthetic data leave the reference's 1% margin open, so
    it is reported, not gated; the steps launch no kernel."""
    net = NETWORK_A.reduced()
    data_cfg = DataConfig(kind="cifar_synthetic", global_batch=CORNER_BATCH,
                          seed=1)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=CORNER_STEPS,
                          weight_decay=0.0)
    params = init_cnn(0, net, device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K.cima_mvm_planes.launches = 0
    for s in range(CORNER_STEPS):
        params, opt, m = qat_update(params, opt,
                                    make_batch(data_cfg, s, "cuda"), net,
                                    opt_cfg, NOISE_SIGMA, fold_seed(0, s))
    loss = float(m["loss"])
    launches = K.cima_mvm_planes.launches
    t_train = time.perf_counter() - t0
    check(launches == 0, f"noisy QAT launched the kernel {launches} times")
    check(np.isfinite(loss), f"loss {loss}")
    held_out = [make_batch(data_cfg, 10_000 + i, "cuda")
                for i in range(CORNER_EVAL)]
    cal = calibrate_bn_stats(
        params, [make_batch(data_cfg, 20_000 + i, "cuda")
                 for i in range(CORNER_EVAL)], net, 7, NOISE_SIGMA)
    clean = fig11_accuracy(params, held_out, net, cifar_qat.NOISY_BACKEND)
    noisy, per = noisy_accuracy(params, held_out, net)
    calibrated, per_cal = noisy_accuracy(cal, held_out, net)
    emit("noise_corner", net=net.name, vdd=0.85, sigma_lsb=NOISE_SIGMA,
         steps=CORNER_STEPS, batch=CORNER_BATCH, final_loss=loss,
         train_seconds=t_train, cima_mvm_launches=launches,
         accuracy_noiseless=clean, accuracy_noisy_uncalibrated=noisy,
         accuracy_noisy_calibrated=calibrated,
         noisy_per_seed=per, noisy_calibrated_per_seed=per_cal,
         reference_margin=0.01,
         within_reference_margin=calibrated >= clean - 0.01,
         note="reported, not gated: synthetic data, the port's init")


def phase_figures():
    """``repro_torch.figures.run`` on the card: every figure's paper
    assertions pass; its CSV rows print above this phase's line."""
    t0 = time.perf_counter()
    K.cima_mvm_planes.launches = 0
    failures = figures_run.run_all("cuda")
    check(not failures, f"figure checks failed: {failures}")
    emit("figures", device="cuda", figures=[m.__name__ for m in
                                            figures_run.FIGURES],
         failures=failures, cima_mvm_launches=K.cima_mvm_planes.launches,
         seconds=time.perf_counter() - t0)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, peaks = phase_device()
    phase_build()
    err_cases = phase_cima_cases()
    rows, err_main = phase_main_shapes(peaks)
    launches = phase_serve(peaks)
    phase_serve_batcher()
    fa_err = phase_flash_cases()
    fa_rows, fa_launches = phase_flash_main_shapes(peaks)
    cifar_rows, cifar_launches, cifar_err = phase_cifar(peaks)
    phase_serve_energy()
    qat_rows, qat_launches = phase_train_cifar()
    lm_launches = phase_train_lm()
    trainer_launches = phase_trainer_resume()
    phase_noise()
    phase_noise_qat()
    phase_noise_corner()
    phase_figures()
    # one decode step's worth of launches at B=4, from the per-shape times
    step = {k: sum(rows[(s[0], 4)][k] * s[4] for s in MAIN_SHAPES)
            for k in ("ms", "plain_ms", "bound_ms")}
    step_bound_by = ("bytes" if all(rows[(s[0], 4)]["bound_by"] == "bytes"
                                    for s in MAIN_SHAPES) else "operations")
    # one olmo-1b training step's launches at 2,048 rows: the forward's and,
    # under remat, the stacked layers' again (every shape but the unembed)
    train = {k: sum(rows[(s[0], 2048)][k] * s[4] * (1 if s[0] == "unembed"
                                                    else 2)
                    for s in MAIN_SHAPES)
             for k in ("ms", "plain_ms", "bound_ms")}
    fa32k = fa_rows[0]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "cima_mvm", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": (launches + cifar_launches + qat_launches + lm_launches
                     + trainer_launches),
        "max_abs_err": max(err_cases, err_main, cifar_err),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step_bound_by,
        "library_ms": None,
        "per": "one decode step's 113 launches at B=4; launches: the "
               "16-forward generate, one CIFAR Network A and B forward (9 "
               "each), 8 QAT steps of each (9 each), 3 olmo-1b train steps "
               "(225 each) and the reduced trainer's 6 steps (29 each); "
               "the noisy paths (noise, noise_qat, noise_corner) run bpbs "
               "and launch it 0 times",
        "train_step_ms": train["ms"], "train_step_plain_ms": train["plain_ms"],
        "train_step_bound_ms": train["bound_ms"],
        "qat_launches_per_step": {r["net"]: r["launches_per_step"]
                                  for r in qat_rows},
        "cifar_ms_per_forward": {r["net"]: r["kernel_ms_sum"]
                                 for r in cifar_rows},
        "cifar_plain_ms_per_forward": {r["net"]: r["kernel_plain_ms_sum"]
                                       for r in cifar_rows},
        "cifar_bound_ms_per_forward": {r["net"]: r["kernel_bound_ms_sum"]
                                       for r in cifar_rows}}, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": fa_launches,
        "max_abs_err": max([fa_err] + [r["max_abs_err"] for r in fa_rows]),
        "ms": fa32k["ms"], "plain_ms": fa32k["plain_ms"],
        "bound_ms": fa32k["bound_ms"], "bound_by": fa32k["bound_by"],
        "library_ms": fa32k["library_ms"],
        "per": "one olmo-1b 32k-token causal prefill attention (B=1, "
               "H=16, D=128, bf16)"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
