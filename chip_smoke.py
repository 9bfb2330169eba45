#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc``
into ``build/``, holds the kernel to its plain torch version on the card
(the eight ``CIMA_CASES`` shapes of ``tests/test_kernels.py`` and the main
path's projection shapes), then serves full-width olmo-1b (random weights
from a seed) through ``repro_torch.serve.Engine`` with every projection
on the kernel, and serves the same prompts again on the plain path.

Each phase prints one JSON line.  The card's name and power limit follow
as ``nvidia-smi`` prints them, then the kernels line, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero; so
does a machine without a CUDA device, or a directory without the repo.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import accel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bpbs import BpbsConfig  # noqa: E402
from repro_torch.core.quant import Coding, int_range, quantize  # noqa: E402
from repro_torch.kernels import cima_mvm as K  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

SOURCE = "src/repro_torch/kernels/csrc/cima_mvm.cu"
REPLACES = "src/repro/kernels/cima_mvm.py:41"
# fused-epilogue tolerance: the kernel's expf/tanhf and the plain
# version's torch silu/gelu may round differently by a few float32 ulps;
# everything else in the epilogue is the same IEEE operation sequence
FUSED_TOL = dict(rtol=1e-6, atol=1e-6)
# data-sheet peaks (dense): device-memory bytes/s and int8 ops/s
CARDS = {"sxm": (3.35e12, 1.979e15), "pcie": (2.0e12, 1.513e15)}
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
         peak_bytes_per_s=peaks[0], peak_int8_ops_per_s=peaks[1])
    print(smi, flush=True)
    return name, peaks


def phase_build():
    t0 = time.perf_counter()
    lib = K.build()
    K._library()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(Path(__file__).resolve().parent)))


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
            y = K.cima_mvm_planes(xs, ws, nu, fs, cfg)
            ref = K.cima_mvm_planes_reference(xs, ws, nu, fs, cfg)
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


def bound_ms(b, n, m, cfg, fused, peaks):
    """Least time for the card: the larger of bytes over the memory rate
    (each input read once, the output written once) and int8 plane
    operations (two per multiply-add) over the int8 peak."""
    n_banks = -(-n // cfg.bank_n)
    nbytes = (n * cfg.ba * m + b * cfg.bx * n + 4 * b * n_banks
              + 4 * n_banks + 4 * b * m + (4 * b * m if fused else 0))
    ops = 2 * b * cfg.bx * cfg.ba * n * m
    t_bytes, t_ops = nbytes / peaks[0], ops / peaks[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_main_shapes(peaks):
    """The main path's projection shapes at B=4 (decode) and B=128
    (prefill rows): equality with the plain version, then device times of
    the kernel, the plain version and, for context only, torch.matmul of
    the integer grids (the ideal-ADC product, not the same function)."""
    cfg = BpbsConfig(ba=4, bx=4)
    rows = {}
    worst = 0.0
    for name, n, m, fused, per_fwd in MAIN_SHAPES:
        for b in (4, 128):
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
            t_kernel = median_ms(lambda i: K.cima_mvm_planes(
                xs, copies[i % len(copies)], nu, fs, cfg, *epi), reps=25)
            t_plain = median_ms(lambda i: K.cima_mvm_planes_reference(
                xs, copies[i % len(copies)], nu, fs, cfg, *epi), reps=5,
                warmup=1)
            xq, wq = qx.q.to(torch.float32), qw.q
            t_mm = median_ms(lambda i: torch.matmul(xq, wq), reps=10)
            bms, by = bound_ms(b, n, m, cfg, fused, peaks)
            rows[(name, b)] = dict(ms=t_kernel, plain_ms=t_plain,
                                   bound_ms=bms, bound_by=by)
            emit("main_shape", name=name, b=b, n=n, m=m,
                 fused_silu_per_row=fused, launches_per_forward=per_fwd,
                 max_abs_err=err, kernel_ms=t_kernel, plain_ms=t_plain,
                 bound_ms=bms, bound_by=by,
                 matmul_ideal_adc_context_ms=t_mm)
            del copies
    return rows, worst


def decode_profile(engine, tok, cache, t_decode: float, steps: int = 3):
    """Device work in a decode step, from a torch.profiler trace of
    ``steps`` steps: the union of the device kernels' time intervals per
    step, its share of the unprofiled step time, the device kernels per
    step, and the five kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            out, cache = engine.decode(tok, cache)
            tok = torch.argmax(out, -1)
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
    return dict(
        steps=steps, device_kernels_per_step=len(kernels) / steps,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=(None if busy_ms is None
                           else 1.0 - busy_ms / (t_decode * 1e3)),
        top_kernels_ms_per_step=[(n[:80], t / 1e3 / steps) for n, t in top])


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


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, peaks = phase_device()
    phase_build()
    err_cases = phase_cima_cases()
    rows, err_main = phase_main_shapes(peaks)
    launches = phase_serve(peaks)
    # one decode step's worth of launches at B=4, from the per-shape times
    step = {k: sum(rows[(s[0], 4)][k] * s[4] for s in MAIN_SHAPES)
            for k in ("ms", "plain_ms", "bound_ms")}
    step_bound_by = ("bytes" if all(rows[(s[0], 4)]["bound_by"] == "bytes"
                                    for s in MAIN_SHAPES) else "operations")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "cima_mvm", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err_cases, err_main),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step_bound_by,
        "library_ms": None,
        "per": "one decode step's 113 launches at B=4"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
