"""BP/BS gradient compression with error feedback.  Port of
``repro.optim.compression``.

Gradients are symmetrically quantized to ``bits`` per leaf (round half
to even, as ``jnp.round``) before the data-parallel reduction, and the
local quantization residual is fed back into the next step's gradient.
:func:`compress_psum` over mesh axes is the collective form (the scale's
maximum and the integer payload's sum over the axes, as the reference's
``pmax``/``psum`` under ``shard_map``); :func:`compress_sharded` is
:func:`compress_decompress` of a full gradient computed on one rank's
slices of it, as the mesh training step applies it.
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


def _scale_of(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`_quantize_leaf`'s scale from a leaf's amax."""
    return torch.clamp_min(amax, 1e-12) / f32(2.0 ** (bits - 1) - 1, amax)


def _requantize(gc: torch.Tensor, scale: torch.Tensor, bits: int):
    """``(q, deq)`` of ``gc`` on the grid of ``scale``."""
    q = torch.clamp(torch.round(gc / scale), -(2.0 ** (bits - 1)),
                    2.0 ** (bits - 1) - 1)
    return q, q * scale


def compress_psum(grads, error, axis_names, bits: int = 8, mesh=None):
    """Quantized reduction with error feedback.  Returns (reduced_grads,
    new_error).  Over ``axis_names`` of ``mesh`` each leaf's scale is the
    maximum over the ranks, the integer payload is summed over them and
    the result is the ranks' mean; the residual stays local.  Without
    ``axis_names`` it is the single-process form."""
    if axis_names:
        if mesh is None:
            raise ValueError("compress_psum over mesh axes needs their mesh")
        axis_names = tuple(axis_names)

    def one(g, e):
        gc = g + e                       # error feedback
        _, scale = _quantize_leaf(gc, bits)
        if axis_names:                   # consistent scale across replicas
            scale = mesh.all_reduce(scale, axis_names, op="max")
        q, deq = _requantize(gc, scale, bits)
        if not axis_names:
            return deq, gc - deq         # reduced (one replica), residual
        red = mesh.all_reduce(q, axis_names) * scale
        return red / f32(mesh.size_of(axis_names), red), gc - deq

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def compress_decompress(grads, error, bits: int = 8):
    """Single-process form: what each replica applies locally."""
    return compress_psum(grads, error, axis_names=(), bits=bits)


def compress_sharded(grads, error, bits: int, specs, mesh):
    """:func:`compress_decompress` of a full gradient and error tree, on
    this rank's slices of both (spec tree ``specs``): each leaf's scale
    is the maximum of its slices' over the axes that shard it, so every
    element lands where the full form puts it, bit for bit."""
    from repro_torch.distributed.sharding import sharded_leaf_reduce

    gcs = [g + e for g, e in zip(leaves(grads), leaves(error))]
    amax = sharded_leaf_reduce(
        [torch.amax(torch.abs(gc)) for gc in gcs], grads, specs, mesh,
        "max")
    out = [_requantize(gc, _scale_of(a, bits), bits)
           for gc, a in zip(gcs, amax)]
    return (unflatten(grads, [deq for _, deq in out]),
            unflatten(grads, [gc - deq for gc, (_, deq) in zip(gcs, out)]))
