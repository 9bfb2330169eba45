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
  function;
* the binding: :mod:`._build` compiles the source into ``build/`` at the
  repo root on first use, and ``ctypes`` binds its plain C launcher.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain glue

def prepare_inputs(x_q: torch.Tensor, cfg: BpbsConfig):
    """Input bit planes ``xs`` [B, BX, N] int8 and per-bank unmasked-row
    counts ``nu`` [B, n_banks] f32 (the reshaping buffer and sparsity
    controller roles); also returns the leading shape of ``x_q``."""
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


def prepare_weights(w_q: torch.Tensor, cfg: BpbsConfig):
    """Weight bit planes ``ws`` [N, BA, M] int8 (the layout a compiled
    :class:`~repro_torch.accel.program.CimaImage` stores) and the bank
    full scales."""
    ws = weight_planes(w_q, cfg).permute(0, 2, 1).to(torch.int8).contiguous()
    return ws, bank_full_scales(w_q.shape[0], cfg, w_q.device)


# -------------------------------------------------------- the plain version

def _epilogue_operand(v, rows: int, m: int, device) -> torch.Tensor:
    """A scale/bias register operand as a contiguous f32 [1, M] (per
    column) or [B, M] (per row) tensor."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
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
    running output, then the optional fused Postreduce."""
    b, bx, n = xs.shape
    m = ws.shape[2]
    wx, wa = cfg.wx, cfg.wa
    xf = xs.to(torch.float32)
    y = torch.zeros((b, m), dtype=torch.float32, device=xs.device)
    for k in range(nu.shape[1]):
        s, e = k * cfg.bank_n, min((k + 1) * cfg.bank_n, n)
        x2 = xf[:, :, s:e].reshape(b * bx, e - s)
        w2 = ws[s:e].to(torch.float32).reshape(e - s, cfg.ba * m)
        d = (x2 @ w2).reshape(b, bx, cfg.ba, m)
        d_hat = gemm_adc_epilogue(d, nu[:, k].reshape(b, 1, 1, 1), fs[k], cfg)
        acc = torch.zeros((b, m), dtype=torch.float32, device=xs.device)
        for kx in range(bx):
            for ka in range(cfg.ba):
                acc = acc + float(wx[kx] * wa[ka]) * d_hat[:, kx, ka]
        y = y + acc
    if _fused(escale, pbias, act, by_bits):
        es = 1.0 if escale is None else _epilogue_operand(escale, b, m, y.device)
        pb = 0.0 if pbias is None else _epilogue_operand(pbias, b, m, y.device)
        y = y * es + pb
        if act:
            y = ACTIVATIONS[act](y)
        if by_bits:
            y = saturate(y, by_bits)
    return y


# ------------------------------------------------------------- the wrapper

TILE_M = 64       # output columns of a block (TM in the source)
CHUNK_ROWS = 64   # bank rows of a pipeline stage (KC in the source)
CLUSTER_SIZE_MAX = 4


@functools.lru_cache(maxsize=256)
def launch_shape(b: int, n: int, m: int, cfg: BpbsConfig, sms: int):
    """The kernel's tiling for a [B, N] x [N, M] call on a card with
    ``sms`` SMs: ``(mt, tb, cs)``.  A block owns ``mt`` m16 tiles of A rows
    (1, 2 or 4: the fewest that hold all B*B_X rows, at most 4, and 1 for
    B_A > 4), ``tb = 16*mt // B_X`` whole batch rows, and splits each bank
    over a cluster of ``cs`` blocks: the largest of 1, 2 and 4 that keeps
    the grid within two blocks per SM and at least two chunks of the
    largest bank per block.  Cached: a forward asks for a few shapes only."""
    mt = 1
    if cfg.ba <= 4:
        while mt < 4 and b > 16 * mt // cfg.bx:
            mt *= 2
    tb = 16 * mt // cfg.bx
    blocks = -(-m // TILE_M) * -(-b // tb)
    chunks = -(-min(cfg.bank_n, n) // CHUNK_ROWS)
    cs = 1
    while (cs < CLUSTER_SIZE_MAX and blocks * 2 * cs <= 2 * sms
           and chunks >= 4 * cs):
        cs *= 2
    return mt, tb, cs


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_launch(xs, ws, nu, fs, cfg: BpbsConfig, act) -> None:
    dev = xs.device
    for name, t, dt, nd in (("xs", xs, torch.int8, 3), ("ws", ws, torch.int8, 3),
                            ("nu", nu, torch.float32, 2),
                            ("fs", fs, torch.float32, 1)):
        if t.device != dev:
            raise ValueError(f"cima_mvm: {name} is on {t.device}, xs on {dev}")
        if t.dtype != dt or t.ndim != nd:
            raise ValueError(f"cima_mvm: {name} must be {nd}-D {dt}, got "
                             f"{t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cima_mvm: {name} must be contiguous")
    b, bx, n = xs.shape
    n_banks = -(-n // cfg.bank_n)
    if not (1 <= cfg.bx <= 8 and 1 <= cfg.ba <= 8):
        raise ValueError(f"cima_mvm: B_X, B_A must be in 1..8, got "
                         f"{cfg.bx}, {cfg.ba}")
    if bx != cfg.bx or ws.shape[0] != n or ws.shape[1] != cfg.ba:
        raise ValueError(f"cima_mvm: xs {tuple(xs.shape)} / ws "
                         f"{tuple(ws.shape)} do not match B_X={cfg.bx}, "
                         f"B_A={cfg.ba}")
    if tuple(nu.shape) != (b, n_banks) or tuple(fs.shape) != (n_banks,):
        raise ValueError(f"cima_mvm: nu {tuple(nu.shape)} / fs "
                         f"{tuple(fs.shape)}; want ({b}, {n_banks}) / "
                         f"({n_banks},)")
    if not 1 <= cfg.adc_bits <= 24:
        raise ValueError(f"cima_mvm: adc_bits must be in 1..24, got "
                         f"{cfg.adc_bits}")
    if act not in ACT_CODES:
        raise ValueError(f"cima_mvm: unknown activation {act!r}")
    if (-(-ws.shape[2] // TILE_M) * CLUSTER_SIZE_MAX > 65535
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

    CUDA tensors launch the kernel (counted in ``cima_mvm_planes.launches``)
    or raise; CPU tensors run :func:`cima_mvm_planes_reference`.  Like the
    Pallas kernel, it draws no ADC noise (``adc_sigma_lsb > 0`` warns)."""
    if xs.device.type == "cpu":
        return cima_mvm_planes_reference(xs, ws, nu, fs, cfg, escale, pbias,
                                         act, by_bits)
    if xs.device.type != "cuda":
        raise ValueError(f"cima_mvm: no kernel for device {xs.device}")
    _check_launch(xs, ws, nu, fs, cfg, act)
    if cfg.adc_sigma_lsb:
        warnings.warn("cima_mvm kernel: adc_sigma_lsb > 0 requested; the "
                      "kernel draws no noise and runs NOISELESS",
                      RuntimeWarning, stacklevel=2)
    b, _, n = xs.shape
    m = ws.shape[2]
    out = torch.empty((b, m), dtype=torch.float32, device=xs.device)
    fused = _fused(escale, pbias, act, by_bits)
    es = pb = None
    if fused and escale is not None:
        es = _epilogue_operand(escale, b, m, xs.device)
    if fused and pbias is not None:
        pb = _epilogue_operand(pbias, b, m, xs.device)
    mt, tb, cs = launch_shape(b, n, m, cfg, _sm_count(xs.device.index or 0))
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
        int(es is not None and es.shape[0] > 1),
        int(pb is not None and pb.shape[0] > 1),
        ACT_CODES[act], int(by_bits or 0), mt, tb, cs, vec_x, vec_w,
        torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cima_mvm kernel launch failed: cudaError {rc}")
    cima_mvm_planes.launches += 1
    return out


cima_mvm_planes.launches = 0


# ------------------------------------------------------------ entry points

def cima_mvm(x_q: torch.Tensor, w_q: torch.Tensor, cfg: BpbsConfig,
             escale=None, pbias=None, act: Optional[str] = None,
             by_bits: Optional[int] = None) -> torch.Tensor:
    """BP/BS MVM on integer-grid operands: [..., N] x [N, M] -> [..., M]."""
    xs, nu, lead = prepare_inputs(x_q, cfg)
    ws, fs = prepare_weights(w_q, cfg)
    y = cima_mvm_planes(xs, ws, nu, fs, cfg, escale, pbias, act, by_bits)
    return y.reshape(lead + (w_q.shape[1],))


def cima_mvm_from_planes(x_q: torch.Tensor, ws: torch.Tensor,
                         cfg: BpbsConfig, escale=None, pbias=None,
                         act: Optional[str] = None,
                         by_bits: Optional[int] = None) -> torch.Tensor:
    """Weight-stationary entry: ``ws`` [N, BA, M] int8 planes from a
    compiled image; only the inputs are decomposed per call."""
    xs, nu, lead = prepare_inputs(x_q, cfg)
    fs = bank_full_scales(ws.shape[0], cfg, ws.device)
    y = cima_mvm_planes(xs, ws, nu, fs, cfg, escale, pbias, act, by_bits)
    return y.reshape(lead + (ws.shape[2],))
