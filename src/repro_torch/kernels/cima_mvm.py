"""The CIMU's BP/BS mixed-signal MVM as a hand-written CUDA kernel.

Port of ``repro.kernels.cima_mvm``.  The kernel itself is
``csrc/cima_mvm.cu`` (its header says what it replaces, what bounds it
and how it is laid out); this module holds

* the input/weight glue that stays plain torch ops, as it stays XLA ops
  outside the Pallas kernel in the reference (:func:`prepare_inputs`,
  :func:`prepare_weights`, :func:`bank_full_scales`);
* :func:`cima_mvm_planes`, the wrapper: on CUDA tensors it launches the
  kernel (or raises), on CPU tensors it runs
  :func:`cima_mvm_planes_reference`, the plain torch version of the same
  function.  Operands with a leading group axis (the MoE experts, which
  the reference runs through the Pallas kernel under ``jax.vmap``) take
  one grouped launch, each group computed as its own 2-D product;
* the binding: :mod:`._build` compiles the source into ``build/`` at the
  repo root on first use, and ``ctypes`` binds its plain C launcher.

A ``meta`` call (the dry run, :mod:`repro_torch.launch.dryrun`) checks
the operands as a launch does and returns the output's shape without
values.  Inside a :class:`~repro_torch.roofline.hlo_stats.StepCounter`
a launch and a ``meta`` call each report the kernel's int8 plane
operations and bytes (:mod:`repro_torch.tally`); outside one they
report nothing.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tally
from repro_torch.core.bpbs import (BpbsConfig, gemm_adc_epilogue,
                                   input_planes, weight_planes)
from repro_torch.core.datapath import ACTIVATIONS, saturate
from repro_torch.core.quant import Coding

from . import _build

SOURCE = _build.CSRC / "cima_mvm.cu"
# activation codes of the kernel's fused epilogue (enum Act in the source)
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "sign": 4,
             "identity": 5}

_LIB: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------- binding

def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        fn = lib.cima_mvm_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 23 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain glue

def prepare_inputs(x_q: torch.Tensor, cfg: BpbsConfig, grouped: bool = False):
    """Input bit planes ``xs`` [B, BX, N] int8 and per-bank unmasked-row
    counts ``nu`` [B, n_banks] f32 (the reshaping buffer and sparsity
    controller roles); also returns the leading shape of ``x_q``.  With
    ``grouped`` the first axis of ``x_q`` [G, ..., N] is the group:
    ``xs`` [G, B, BX, N], ``nu`` [G, B, n_banks] (each group counting its
    own rows) and the leading shape without G."""
    if grouped:
        g = x_q.shape[0]
        xs, nu, lead = prepare_inputs(x_q.reshape(-1, x_q.shape[-1]), cfg)
        return (xs.reshape((g, -1) + xs.shape[1:]),
                nu.reshape((g, -1) + nu.shape[1:]), tuple(x_q.shape[1:-1]))
    lead = tuple(x_q.shape[:-1])
    n = x_q.shape[-1]
    planes, mask = input_planes(x_q.reshape(-1, n), cfg)   # [B,N,BX], [B,N]
    xs = planes.permute(0, 2, 1).to(torch.int8).contiguous()
    n_banks = -(-n // cfg.bank_n)
    mask_p = F.pad(mask, (0, n_banks * cfg.bank_n - n))
    nu = mask_p.reshape(-1, n_banks, cfg.bank_n).sum(-1).to(torch.float32)
    return xs, nu.contiguous(), lead


@functools.lru_cache(maxsize=64)
def _bank_sizes(n: int, bank_n: int, device: torch.device) -> torch.Tensor:
    n_banks = -(-n // bank_n)
    sizes = np.minimum(np.full(n_banks, bank_n),
                       n - np.arange(n_banks) * bank_n)
    return torch.as_tensor(sizes, dtype=torch.float32, device=device)


def bank_full_scales(n: int, cfg: BpbsConfig,
                     device="cuda") -> torch.Tensor:
    """Static ADC full scale per bank: the bank's (possibly ragged last)
    row count [n_banks] f32.  Never written to by callers."""
    return _bank_sizes(int(n), int(cfg.bank_n), torch.device(device))


# weight elements decomposed into float32 planes at a time: the planes
# of deepseek-v2-lite's 2,048 x 102,400 lm_head (or a rank's 32 experts)
# would take 3.4 GB (1.5 GB) at once, three copies deep, and a
# 4,096 x 256,000 unembed's 17 GB
PLANE_ELEMENTS = 2048 * 8192


def int8_planes(w_q: torch.Tensor, cfg: BpbsConfig) -> torch.Tensor:
    """The weight bit planes of ``w_q`` [..., N, M] as int8 [..., N, BA,
    M]; a weight of more than PLANE_ELEMENTS elements is decomposed a
    block of output columns at a time (elementwise: the same bits)."""
    m = w_q.shape[-1]
    cols = max(1, PLANE_ELEMENTS * m // max(w_q.numel(), 1))
    if cols >= m:
        return weight_planes(w_q, cfg).transpose(-1, -2).to(
            torch.int8).contiguous()
    ws = torch.empty(w_q.shape[:-1] + (cfg.ba, m), dtype=torch.int8,
                     device=w_q.device)
    for c in range(0, m, cols):
        ws[..., c:c + cols] = weight_planes(w_q[..., c:c + cols],
                                            cfg).transpose(-1, -2)
    return ws


def prepare_weights(w_q: torch.Tensor, cfg: BpbsConfig):
    """Weight bit planes ``ws`` [N, BA, M] int8 (:func:`int8_planes`, the
    layout a compiled :class:`~repro_torch.accel.program.CimaImage`
    stores; [G, N, BA, M] for grouped ``w_q`` [G, N, M]) and the bank
    full scales."""
    return int8_planes(w_q, cfg), bank_full_scales(w_q.shape[-2], cfg,
                                                   w_q.device)


# -------------------------------------------------------- the plain version

def _epilogue_operand(v, rows: int, m: int, device,
                      groups: int = 0) -> torch.Tensor:
    """A scale/bias register operand as a contiguous f32 [1, M] (per
    column) or [B, M] (per row) tensor; for a grouped call (``groups``
    > 0) a 3-D operand [G, 1 or B, M] keeps its group axis (one set of
    registers per group) and anything else is shared by every group."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if groups and v.ndim == 3:
        if v.shape[0] != groups or v.shape[1] not in (1, rows):
            raise ValueError(f"epilogue operand {tuple(v.shape)}; the "
                             f"kernel takes [{groups}, 1 or {rows}, {m}]")
        return v.expand(groups, v.shape[1], m).contiguous()
    if v.ndim >= 2:
        v = v.reshape(-1, v.shape[-1])
        v = v.expand(v.shape[0], m)
        if v.shape[0] not in (1, rows):
            raise ValueError(f"epilogue operand has {v.shape[0]} rows; the "
                             f"kernel takes 1 or {rows}")
    else:
        v = v.reshape(-1).expand(m).reshape(1, m)
    return v.contiguous()


def _fused(escale, pbias, act, by_bits) -> bool:
    return (escale is not None or pbias is not None or bool(act)
            or bool(by_bits))


def cima_mvm_planes_reference(xs: torch.Tensor, ws: torch.Tensor,
                              nu: torch.Tensor, fs: torch.Tensor,
                              cfg: BpbsConfig, escale=None, pbias=None,
                              act: Optional[str] = None,
                              by_bits: Optional[int] = None) -> torch.Tensor:
    """Plain torch version of the kernel, in the kernel's own order: per
    bank one exact f32 product over all plane pairs (exact with TF32 off:
    every partial sum is a small integer), the ADC epilogue, the
    shift-accumulate of the bank's pairs (kx outer, ka inner) added to the
    running output, then the optional fused Postreduce.  Grouped operands
    (a leading G on all but ``fs``) run as one batch of the same torch
    ops, each group in the order of its own 2-D call."""
    lead = tuple(xs.shape[:-3])                  # () or (G,)
    b, bx, n = xs.shape[-3:]
    m = ws.shape[-1]
    wx, wa = cfg.wx, cfg.wa
    xf = xs.to(torch.float32)
    y = torch.zeros(lead + (b, m), dtype=torch.float32, device=xs.device)
    for k in range(nu.shape[-1]):
        s, e = k * cfg.bank_n, min((k + 1) * cfg.bank_n, n)
        x2 = xf[..., s:e].reshape(lead + (b * bx, e - s))
        w2 = ws[..., s:e, :, :].to(torch.float32).reshape(
            lead + (e - s, cfg.ba * m))
        d = (x2 @ w2).reshape(lead + (b, bx, cfg.ba, m))
        d_hat = gemm_adc_epilogue(d, nu[..., k].reshape(lead + (b, 1, 1, 1)),
                                  fs[k], cfg)
        acc = torch.zeros(lead + (b, m), dtype=torch.float32,
                          device=xs.device)
        for kx in range(bx):
            for ka in range(cfg.ba):
                acc = acc + float(wx[kx] * wa[ka]) * d_hat[..., kx, ka, :]
        y = y + acc
    if _fused(escale, pbias, act, by_bits):
        g = lead[0] if lead else 0
        es = (1.0 if escale is None
              else _epilogue_operand(escale, b, m, y.device, g))
        pb = (0.0 if pbias is None
              else _epilogue_operand(pbias, b, m, y.device, g))
        y = y * es + pb
        if act and lead:
            # group by group: torch's CPU activations round an element by
            # where it falls in their vectorised loop, so each group goes
            # through it as its 2-D call does (G launches of one op)
            y = torch.stack([ACTIVATIONS[act](yg) for yg in y])
        elif act:
            y = ACTIVATIONS[act](y)
        if by_bits:
            y = saturate(y, by_bits)
    return y


# ------------------------------------------------------------- the wrapper

TILE_M = 64       # output columns of a block (TM in the source)
CHUNK_ROWS = 64   # bank rows of a pipeline stage (KC in the source)
CLUSTER_SIZE_MAX = 4


@functools.lru_cache(maxsize=256)
def launch_shape(b: int, n: int, m: int, cfg: BpbsConfig, sms: int,
                 groups: int = 1):
    """The kernel's tiling for a [B, N] x [N, M] call (``groups`` of them
    in a grouped launch) on a card with ``sms`` SMs: ``(mt, tb, cs)``.  A
    block owns ``mt`` m16 tiles of A rows (1, 2 or 4: the fewest that hold
    all B*B_X rows, at most 4, and 1 for B_A > 4), ``tb = 16*mt // B_X``
    whole batch rows, and splits each bank
    over a cluster of ``cs`` blocks: the largest of 1, 2 and 4 that keeps
    the grid within two blocks per SM and at least two chunks of the
    largest bank per block, counting every group's blocks.  Cached: a
    forward asks for a few shapes only."""
    mt = 1
    if cfg.ba <= 4:
        while mt < 4 and b > 16 * mt // cfg.bx:
            mt *= 2
    tb = 16 * mt // cfg.bx
    blocks = groups * -(-m // TILE_M) * -(-b // tb)
    chunks = -(-min(cfg.bank_n, n) // CHUNK_ROWS)
    cs = 1
    while (cs < CLUSTER_SIZE_MAX and blocks * 2 * cs <= 2 * sms
           and chunks >= 4 * cs):
        cs *= 2
    return mt, tb, cs


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# gridDim.z carries the groups of a grouped launch
MAX_GROUPS = 65535


def _check_launch(xs, ws, nu, fs, cfg: BpbsConfig, act) -> None:
    dev = xs.device
    g = int(xs.ndim == 4)           # a grouped call's leading axis
    for name, t, dt, nd in (("xs", xs, torch.int8, 3 + g),
                            ("ws", ws, torch.int8, 3 + g),
                            ("nu", nu, torch.float32, 2 + g),
                            ("fs", fs, torch.float32, 1)):
        if t.device != dev:
            raise ValueError(f"cima_mvm: {name} is on {t.device}, xs on {dev}")
        if t.dtype != dt or t.ndim != nd:
            raise ValueError(f"cima_mvm: {name} must be {nd}-D {dt}, got "
                             f"{t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cima_mvm: {name} must be contiguous")
    if g and not (ws.shape[0] == nu.shape[0] == xs.shape[0]
                  and 1 <= xs.shape[0] <= MAX_GROUPS):
        raise ValueError(f"cima_mvm: groups of xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)} and nu {tuple(nu.shape)} must "
                         f"match and lie in 1..{MAX_GROUPS}")
    b, bx, n = xs.shape[-3:]
    n_banks = -(-n // cfg.bank_n)
    if not (1 <= cfg.bx <= 8 and 1 <= cfg.ba <= 8):
        raise ValueError(f"cima_mvm: B_X, B_A must be in 1..8, got "
                         f"{cfg.bx}, {cfg.ba}")
    if bx != cfg.bx or ws.shape[-3] != n or ws.shape[-2] != cfg.ba:
        raise ValueError(f"cima_mvm: xs {tuple(xs.shape)} / ws "
                         f"{tuple(ws.shape)} do not match B_X={cfg.bx}, "
                         f"B_A={cfg.ba}")
    if tuple(nu.shape[-2:]) != (b, n_banks) or tuple(fs.shape) != (n_banks,):
        raise ValueError(f"cima_mvm: nu {tuple(nu.shape)} / fs "
                         f"{tuple(fs.shape)}; want ({b}, {n_banks}) / "
                         f"({n_banks},)")
    if not 1 <= cfg.adc_bits <= 24:
        raise ValueError(f"cima_mvm: adc_bits must be in 1..24, got "
                         f"{cfg.adc_bits}")
    if act not in ACT_CODES:
        raise ValueError(f"cima_mvm: unknown activation {act!r}")
    if (-(-ws.shape[-1] // TILE_M) * CLUSTER_SIZE_MAX > 65535
            or n >= 2 ** 31 or ws.numel() >= 2 ** 62):
        raise ValueError("cima_mvm: shape out of the kernel's range")


def cima_mvm_planes(xs: torch.Tensor, ws: torch.Tensor, nu: torch.Tensor,
                    fs: torch.Tensor, cfg: BpbsConfig, escale=None,
                    pbias=None, act: Optional[str] = None,
                    by_bits: Optional[int] = None) -> torch.Tensor:
    """BP/BS MVM on pre-decomposed planes: ``xs`` [B, BX, N] int8,
    ``ws`` [N, BA, M] int8, ``nu`` [B, n_banks] f32, ``fs`` [n_banks] f32
    -> [B, M] f32.  ``escale``/``pbias``/``act``/``by_bits`` arm the fused
    datapath epilogue (``escale``/``pbias`` per column or per row).
    :func:`launch_shape` picks the kernel's tiling; every tiling gives the
    same bits.

    Grouped: ``xs`` [G, B, BX, N], ``ws`` [G, N, BA, M], ``nu``
    [G, B, n_banks] (``fs`` shared; ``escale``/``pbias`` [G, 1 or B, M]
    per group, or shared) -> [G, B, M] in ONE launch; each group's result
    is the 2-D call's on that group's operands, bit for bit.

    CUDA tensors launch the kernel (counted in ``cima_mvm_planes.launches``)
    or raise; CPU tensors run :func:`cima_mvm_planes_reference`; ``meta``
    tensors return an empty ``meta`` output.  Inside a step counter a
    launch and a ``meta`` call report their work (:func:`_report`).
    Like the Pallas kernel, it draws no ADC noise (``adc_sigma_lsb > 0``
    warns)."""
    if xs.device.type == "cpu":
        return cima_mvm_planes_reference(xs, ws, nu, fs, cfg, escale, pbias,
                                         act, by_bits)
    if xs.device.type not in ("cuda", "meta"):
        raise ValueError(f"cima_mvm: no kernel for device {xs.device}")
    _check_launch(xs, ws, nu, fs, cfg, act)
    if cfg.adc_sigma_lsb:
        warnings.warn("cima_mvm kernel: adc_sigma_lsb > 0 requested; the "
                      "kernel draws no noise and runs NOISELESS",
                      RuntimeWarning, stacklevel=2)
    groups = xs.shape[0] if xs.ndim == 4 else 0
    b, _, n = xs.shape[-3:]
    m = ws.shape[-1]
    lead = (groups,) if groups else ()
    out = torch.empty(lead + (b, m), dtype=torch.float32, device=xs.device)
    fused = _fused(escale, pbias, act, by_bits)
    es = pb = None
    if fused and escale is not None:
        es = _epilogue_operand(escale, b, m, xs.device, groups)
    if fused and pbias is not None:
        pb = _epilogue_operand(pbias, b, m, xs.device, groups)
    if xs.device.type == "meta":
        if tally.ACTIVE:
            _report(cfg, (xs, ws, nu, fs, es, pb, out))
        return out
    es_g, pb_g = (int(t is not None and t.ndim == 3) for t in (es, pb))
    mt, tb, cs = launch_shape(b, n, m, cfg, _sm_count(xs.device.index or 0),
                              max(groups, 1))
    vec_x = int(n % 16 == 0 and cfg.bank_n % 16 == 0
                and xs.data_ptr() % 16 == 0)
    vec_w = int(m % 16 == 0 and ws.data_ptr() % 16 == 0)
    rc = _library().cima_mvm_launch(
        xs.data_ptr(), ws.data_ptr(), nu.data_ptr(), fs.data_ptr(),
        es.data_ptr() if es is not None else None,
        pb.data_ptr() if pb is not None else None,
        out.data_ptr(), b, n, m, cfg.bx, cfg.ba, cfg.bank_n,
        int(cfg.coding == Coding.AND), int(cfg.adaptive_range),
        int(cfg.ideal_adc), cfg.adc_bits, int(fused),
        int(es is not None and es.shape[-2] > 1),
        int(pb is not None and pb.shape[-2] > 1),
        ACT_CODES[act], int(by_bits or 0), mt, tb, cs, vec_x, vec_w,
        max(groups, 1), es_g, pb_g,
        torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cima_mvm kernel launch failed: cudaError {rc}")
    cima_mvm_planes.launches += 1
    if tally.ACTIVE:
        _report(cfg, (xs, ws, nu, fs, es, pb, out))
    return out


cima_mvm_planes.launches = 0


def _report(cfg: BpbsConfig, operands) -> None:
    """Report one call to the open counters: ``2 * G * B * B_X * N * B_A
    * M`` int8 plane operations (each plane pair's dot over every row of
    every bank) and the bytes of every operand and the output, each read
    or written once."""
    xs, ws = operands[0], operands[1]
    g = xs.shape[0] if xs.ndim == 4 else 1
    b, bx, n = xs.shape[-3:]
    tally.report_kernel(2 * g * b * bx * n * cfg.ba * ws.shape[-1],
                        sum(t.numel() * t.element_size() for t in operands
                            if t is not None))


# ------------------------------------------------------------ entry points

def cima_mvm(x_q: torch.Tensor, w_q: torch.Tensor, cfg: BpbsConfig,
             escale=None, pbias=None, act: Optional[str] = None,
             by_bits: Optional[int] = None) -> torch.Tensor:
    """BP/BS MVM on integer-grid operands: [..., N] x [N, M] -> [..., M];
    grouped, [G, ..., N] x [G, N, M] -> [G, ..., M] in one launch."""
    xs, nu, _ = prepare_inputs(x_q, cfg, grouped=w_q.ndim == 3)
    ws, fs = prepare_weights(w_q, cfg)
    y = cima_mvm_planes(xs, ws, nu, fs, cfg, escale, pbias, act, by_bits)
    return y.reshape(tuple(x_q.shape[:-1]) + (w_q.shape[-1],))


def cima_mvm_from_planes(x_q: torch.Tensor, ws: torch.Tensor,
                         cfg: BpbsConfig, escale=None, pbias=None,
                         act: Optional[str] = None,
                         by_bits: Optional[int] = None) -> torch.Tensor:
    """Weight-stationary entry: ``ws`` [N, BA, M] int8 planes from a
    compiled image (grouped: [G, N, BA, M] with ``x_q`` [G, ..., N]); only
    the inputs are decomposed per call."""
    xs, nu, _ = prepare_inputs(x_q, cfg, grouped=ws.ndim == 4)
    fs = bank_full_scales(ws.shape[-3], cfg, ws.device)
    y = cima_mvm_planes(xs, ws, nu, fs, cfg, escale, pbias, act, by_bits)
    return y.reshape(tuple(x_q.shape[:-1]) + (ws.shape[-1],))
