"""Bit-plane quantization codings for the BP/BS scheme (paper Fig. 4).

Port of ``repro.core.quant``.  Two codings, exactly as in the paper:

* ``AND``  — 2's complement: plane weights ``[1, 2, ..., 2^(B-2),
  -2^(B-1)]`` over ``{0,1}`` bits.
* ``XNOR`` — ``{-1,+1}`` bits with plane weights ``[2^(B-2), ..., 2, 1,
  1]``; the grid is the even integers in ``[-2^(B-1), 2^(B-1)]``.

All plane tensors put the plane index in the LAST axis.  Rounding is
``torch.round`` (half to even, as ``jnp.round``), so every grid is
bitwise-equal to the reference on the same float32 inputs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class Coding(str, enum.Enum):
    XNOR = "xnor"
    AND = "and"


def plane_weights(bits: int, coding: Coding) -> np.ndarray:
    """Significance weight of each bit plane (float64 numpy, length ``bits``)."""
    coding = Coding(coding)
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    if bits == 1:
        return np.array([1.0])
    if coding == Coding.XNOR:
        return np.array([2.0 ** k for k in range(bits - 2, -1, -1)] + [1.0])
    return np.array([2.0 ** k for k in range(bits - 1)] + [-(2.0 ** (bits - 1))])


def int_range(bits: int, coding: Coding) -> tuple[int, int]:
    """Inclusive integer grid range representable by the coding."""
    coding = Coding(coding)
    if coding == Coding.XNOR:
        if bits == 1:
            return (-1, 1)
        return (-(2 ** (bits - 1)), 2 ** (bits - 1))  # even integers only
    if bits == 1:
        return (0, 1)
    return (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1)


def n_levels(bits: int, coding: Coding) -> int:
    """Number of distinct grid values the coding represents."""
    if Coding(coding) == Coding.XNOR:
        return 2 if bits == 1 else 2 ** (bits - 1) + 1
    return 2 ** bits


@dataclasses.dataclass
class QTensor:
    """A quantized tensor: ``value ~= q * scale`` with ``q`` on the coding grid."""

    q: torch.Tensor       # integer-valued (float32 or int8)
    scale: torch.Tensor   # broadcastable scale
    bits: int
    coding: Coding

    @property
    def dequant(self) -> torch.Tensor:
        return self.q * self.scale


def quantize(x: torch.Tensor, bits: int, coding: Coding,
             axis: Optional[int] = None, eps: float = 1e-12,
             per_row: bool = False, across=None) -> QTensor:
    """Symmetric per-tensor, per-axis (``axis`` kept) or per-row (one scale
    per leading index, reduced over the last axis) quantization onto the
    coding grid.  ``per_row`` and ``axis`` are mutually exclusive.

    ``across`` (a :class:`~repro_torch.distributed.autoshard.BatchStats`)
    makes the statistic span ranks that each hold an equal block of the
    rest of ``x``: the amax is the maximum over them (the same in any
    order), the XNOR 1-bit mean their summed total over the global
    element count (another summation order than one rank's mean)."""
    coding = Coding(coding)
    if per_row and axis is not None:
        raise ValueError("quantize: per_row and axis are mutually exclusive")
    ax = x.abs()

    def _reduce(fn):
        if per_row:
            return fn(ax, dim=-1, keepdim=True)
        if axis is None:
            return fn(ax)
        dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        return fn(ax, dim=dims, keepdim=True)

    if coding == Coding.XNOR and bits == 1:
        if across is None:
            mean = _reduce(torch.mean)
        else:
            total = across.sum(_reduce(torch.sum))
            count = ax.numel() // max(total.numel(), 1) * across.size
            mean = total / torch.full_like(total, float(count))
        scale = torch.clamp_min(mean, eps)
        return QTensor(torch.where(x >= 0, 1.0, -1.0), scale, bits, coding)
    amax = _reduce(torch.amax)
    amax = torch.clamp_min(amax if across is None else across.max(amax), eps)
    if coding == Coding.XNOR:
        half = 2.0 ** (bits - 2)
        scale = amax / (2.0 * half)
        level = torch.clamp(torch.round(x / (2.0 * scale)), -half, half)
        return QTensor(2.0 * level, scale, bits, coding)
    if bits == 1:
        scale = amax
        return QTensor(torch.clamp(torch.round(x / scale), 0, 1), scale,
                       bits, coding)
    qmax = 2.0 ** (bits - 1) - 1
    qmin = -(2.0 ** (bits - 1))
    scale = amax / (2.0 ** (bits - 1))
    return QTensor(torch.clamp(torch.round(x / scale), qmin, qmax), scale,
                   bits, coding)


def int_to_planes(q: torch.Tensor, bits: int, coding: Coding) -> torch.Tensor:
    """Decompose integers on the coding grid into bit planes: values in
    {0,1} (AND) or {-1,+1} (XNOR), shape ``q.shape + (bits,)``, float32."""
    coding = Coding(coding)
    q = q.to(torch.float32)
    if coding == Coding.XNOR:
        if bits == 1:
            return torch.where(q >= 0, 1.0, -1.0)[..., None]
        big = 2.0 ** (bits - 1)
        u = (q + big) / 2.0                       # in [0, 2^(B-1)]
        top = u >= big
        e = top.to(torch.float32)                 # second LSB-weight plane
        rem = torch.where(top, big - 1.0, u - e)  # u == big -> all-ones
        planes = []
        for k in range(bits - 2, -1, -1):
            w = 2.0 ** k
            b = torch.floor(rem / w)
            rem = rem - b * w
            planes.append(b)
        planes.append(e)
        return 2.0 * torch.stack(planes, dim=-1) - 1.0
    if bits == 1:
        return torch.clamp(q, 0, 1)[..., None]
    rem = q + 2.0 ** (bits - 1)                   # unsigned B-bit value
    msb = torch.floor(rem / (2.0 ** (bits - 1)))
    sign_bit = 1.0 - msb
    rem = rem - msb * (2.0 ** (bits - 1))
    low = []
    for k in range(bits - 2, -1, -1):
        w = 2.0 ** k
        b = torch.floor(rem / w)
        rem = rem - b * w
        low.append(b)
    low.reverse()                                 # LSB-first: weights 1, 2, ...
    return torch.stack(low + [sign_bit], dim=-1)


def planes_to_int(planes: torch.Tensor, bits: int, coding: Coding) -> torch.Tensor:
    """Inverse of :func:`int_to_planes` (weighted recombination)."""
    w = torch.as_tensor(plane_weights(bits, coding), dtype=torch.float32,
                        device=planes.device)
    return torch.sum(planes * w, dim=-1)
