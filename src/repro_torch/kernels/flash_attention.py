"""Online-softmax (flash) attention as a hand-written CUDA kernel.

Port of ``repro.kernels.flash_attention``.  The kernel itself is
``csrc/flash_attention.cu`` (its header says what it replaces, what bounds
it and how it is laid out); this module holds

* :func:`flash_attention`, the wrapper: on CUDA tensors it launches the
  kernel (counted in ``flash_attention.launches``) or raises, on CPU
  tensors it runs :func:`flash_attention_reference`;
* :func:`flash_attention_reference`, the plain torch version of the
  kernel's function.

Positions are TOP-LEFT aligned, as in the Pallas kernel: query row ``r``
is at position ``r`` and key ``c`` at ``c``.  ``kernels.ref.attention_ref``
aligns the last query to the last key instead; the two agree only when
``Sq == Sk``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 256
NEG_INF = -1e30

_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             device) -> torch.Tensor:
    """[Sq, Sk] bool: key ``c`` visible to query ``r`` (top-left aligned)."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qi >= kj)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain torch version of the kernel: dense f32 scores of the scaled
    queries, masked to -1e30, ``p = mask ? exp(s - max) : 0`` and
    ``(p @ v) / max(sum p, 1e-30)`` (a row that sees no key is 0), in
    ``q``'s dtype.  ``q`` [B, H, Sq, D], ``k``/``v`` [B, HKV, Sk, D]."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32).reshape(b, hkv, g, sq, d) * scale
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k.to(torch.float32))
    mask = _visible(sq, sk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.to(torch.float32)) / l
    return o.reshape(b, h, sq, d).to(q.dtype)


def _check_launch(q, k, v) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {dev}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{t.ndim}-D")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the "
                             f"kernel takes float32 or bfloat16, all alike")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, h, _, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside "
                         f"1..{MAX_HEAD_DIM}")
    if max(b, h) > 65535 or max(q.numel(), k.numel()) >= 2 ** 62:
        raise ValueError("flash_attention: shape out of the kernel's range")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of ``q`` [B, H, Sq, D] over ``k``/``v`` [B, HKV, Sk, D]
    -> [B, H, Sq, D] in ``q``'s dtype, with GQA (kv head ``h // (H /
    HKV)``), causal masking and a sliding ``window`` on top-left aligned
    positions.

    ``block_q``/``block_k`` are the reference's tile sizes.  They do not
    change the result; ``block_k`` keeps the reference's rule that the kv
    length may be padded to a multiple of it only for causal
    self-attention (``Sq == Sk``), so the port refuses what it refuses.

    CUDA tensors launch the kernel (counted in
    ``flash_attention.launches``) or raise; CPU tensors run
    :func:`flash_attention_reference`."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    assert h % hkv == 0, "GQA requires heads % kv_heads == 0"
    skp = -(-sk // block_k) * block_k
    assert skp == sk or (causal and sq == sk), (
        "kv padding requires causal self-attention (else pass seq_k % "
        "block_k == 0)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, window, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_launch(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the mask only compares positions in [0, Sq) and [0, Sk): a window
    # clamped to that range gives the same mask without int32 overflow
    w = 0 if window is None else max(min(int(window), sq + 1), -(sk + 1))
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, sk, d, float(scale), int(bool(causal)),
        int(window is not None), w, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
