"""BP/BS gradient compression with error feedback.  Port of
``repro.optim.compression`` (single process).

Gradients are symmetrically quantized to ``bits`` per leaf (round half
to even, as ``jnp.round``) before the data-parallel reduction, and the
local quantization residual is fed back into the next step's gradient.
The collective form (``compress_psum`` over mesh axes) comes with the
port's sharded-training slice (the mesh serves already:
:mod:`repro_torch.accel.shard`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, tree_map, unflatten

from .adamw import f32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    enabled: bool = True


def init_error_state(params):
    return tree_map(torch.zeros_like, params)


def _quantize_leaf(g: torch.Tensor, bits: int):
    """Symmetric per-leaf quantization.  Returns (q, scale)."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) / f32(qmax, g)
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax)
    return q, scale


def compress_psum(grads, error, axis_names, bits: int = 8):
    """Quantize-dequantize with error feedback.  Returns (reduced_grads,
    new_error).  Only the single-process form (no ``axis_names``) is
    ported."""
    if axis_names:
        raise NotImplementedError(
            "compress_psum over mesh axes comes with the port's "
            "sharded-training slice")

    def one(g, e):
        gc = g + e                       # error feedback
        _, scale = _quantize_leaf(gc, bits)
        q = torch.clamp(torch.round(gc / scale), -(2.0 ** (bits - 1)),
                        2.0 ** (bits - 1) - 1)
        deq = q * scale
        return deq, gc - deq             # reduced (one replica), residual

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def compress_decompress(grads, error, bits: int = 8):
    """Single-process form: what each replica applies locally."""
    return compress_psum(grads, error, axis_names=(), bits=bits)
