"""Mesh-sharded ("multi-chip") execution of compiled CIMA programs.  Port
of ``repro.accel.shard``.

One 65nm chip aligns storage and compute across its 16 banks; this
module does the same across the ranks of a
:class:`~repro_torch.launch.mesh.ServeMesh`: a compiled
:class:`~repro_torch.accel.program.CimaImage` whose ``partition`` says
how its bit planes split over the ``"model"`` axis runs as one tile per
rank (DESIGN.md §9):

* ``"col"`` (column-parallel): every rank holds ``m/devices`` output
  columns of all rows.  The input is replicated, each rank evaluates its
  own columns (bank grid, ADC epilogue, rescale and datapath epilogue all
  local) and the columns are gathered over the model group.
* ``"row"`` (row-parallel): every rank holds ``n/devices`` contraction
  rows of all columns.  Each rank takes its N range of the input, runs
  its local banks *and its own ADC epilogue* (each chip digitizes its own
  column sums, the physical multi-chip behaviour) and the integer-valued
  float32 partial sums are combined with one ``all_reduce`` over the
  model group (exact: small integers sum the same in any order).  The
  rescale and the datapath epilogue run after it.

Input quantization is global: the per-tensor or per-row scale is
computed from the whole activation on every rank identically, before any
split, so sharding never changes the operand grid.

Two local forms serve attention on the rank's own heads
(``models.attention.head_split``), asked for by ``local``:

* ``"col"``: the column tile's output stays on the rank (no model-axis
  gather): the rank's heads of q, k or v.
* ``"row"``: the input already is the rank's N range (its heads of the
  attention output), so nothing is sliced; the per-row (or per-tensor)
  amax of that block is reduced with ``max`` over the model group before
  the grid is set, so the grid is still the whole input's.  One
  all-reduce of a scale takes the place of the three gathers of q, k
  and v.

The ``"data"`` axis composes orthogonally: when it is wider than 1 and
divides the activation's leading (batch) dim, each data shard computes
its slice of the rows (after quantization) and the rows are gathered
over the data group.  Under :func:`~repro_torch.distributed.autoshard.
manual` ``("data")`` the activation already is this data shard's rows
(the serving engine's decode) and nothing more splits or gathers.

On the ``kernel`` backend the local body is the BP/BS kernel
``cima_mvm.cu`` on the rank's ``[N_loc, B_A, M_loc]`` planes (its plain
version on CPU tensors): its bank grid *is* the per-device tile.

Each rank's ADC noise (``bpbs`` at ``adc_sigma_lsb > 0``) comes from a
generator seeded from the dispatch's generator and the rank's model
coordinate, and its data coordinate where data shards hold different
rows, as the reference's ``fold_in`` of the axis indices: distinct chips
draw independent noise, which matches the reference only in
distribution.

Trace semantics: :func:`~repro_torch.accel.dispatch.matmul` records ONE
logical :class:`~repro_torch.accel.context.MvmRecord` (the full ``n, m``
with ``devices``/``partition``) before calling in; nothing here records,
so a sharded trace's counts and loads equal the unsharded trace's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.bpbs import (bpbs_matmul_planes,
                                   bpbs_matmul_planes_reference)
from repro_torch.core.quant import QTensor
from repro_torch.distributed.autoshard import in_manual, model_block

from .backends import apply_post, kernel_from_planes, quantize_input, rescale
from .context import fold_seed
from .program import tile_bounds

SHARD_BACKENDS = ("digital_int", "bpbs", "bpbs_ref", "kernel")


def _data_axis(mesh, x_shape) -> Optional[str]:
    """``"data"`` iff this call splits its batch rows over the mesh's data
    axis: a data axis wider than 1 that the code around does not already
    run split (``manual("data")``), an activation with a leading batch
    dim (ndim >= 2) that it divides.  Placement only, never numerics."""
    if "data" not in mesh.axis_names or in_manual("data"):
        return None
    d = int(dict(mesh.shape)["data"])
    if d <= 1 or len(x_shape) < 2 or x_shape[0] % d != 0:
        return None
    return "data"


def _rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This data shard's block of ``t``'s leading dim."""
    lo, hi = tile_bounds(t.shape[0], mesh.size("data"), mesh.index("data"))
    return t[lo:hi]


def _image_tile(image, mesh) -> tuple:
    """``(ws, wq, scale)`` of this rank's tile: the image's own arrays
    when it was compiled as that tile, else a slice of the whole image
    (the same bits)."""
    k = mesh.index("model")
    if image.tile is not None:
        if image.tile != k:
            raise ValueError(f"image {image.path!r} holds tile {image.tile}, "
                             f"this rank is model index {k}")
        return image.ws, image.wq, image.scale
    if image.partition == "row":
        lo, hi = tile_bounds(image.n, image.devices, k)
        return image.ws[..., lo:hi, :, :], image.wq[..., lo:hi, :], \
            image.scale
    lo, hi = tile_bounds(image.m, image.devices, k)
    scale = image.scale[..., lo:hi] if image.per_channel else image.scale
    return image.ws[..., lo:hi], image.wq[..., lo:hi], scale


def _local_operand(a, part: str, m: int, mesh, lead, rows: int):
    """An epilogue operand on this rank: its rows of a leading batch dim
    when the rows split over "data", its columns of a last dim of ``m``
    under "col"; anything else (scalars, per-tensor scales, operands of
    a "row" tile, applied after the all-reduce) whole."""
    if a is None or not torch.is_tensor(a):
        return a
    if lead is not None and a.ndim >= 2 and a.shape[0] == rows:
        a = _rows(a, mesh)
    if part == "col" and a.ndim and a.shape[-1] == m:
        lo, hi = tile_bounds(m, mesh.size("model"), mesh.index("model"))
        a = a[..., lo:hi]
    return a


def rank_columns(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``t``'s last dim over the model axis: an
    operand added to a local column tile's output (a linear bias)."""
    lo, hi = tile_bounds(t.shape[-1], mesh.size("model"), mesh.index("model"))
    return t[..., lo:hi]


def _rank_generator(generator, mesh, lead):
    """The rank's own noise generator: the dispatch's seed folded with the
    model index and, where data shards hold different rows, the data
    index."""
    if generator is None:
        return None
    seed = fold_seed(generator.initial_seed(), mesh.index("model"))
    if lead is not None or in_manual("data"):
        seed = fold_seed(seed, mesh.index("data"))
    return torch.Generator(device=generator.device).manual_seed(seed)


def sharded_program_matmul(x: torch.Tensor, spec, image, mesh,
                           generator: Optional[torch.Generator] = None,
                           post=None,
                           local: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` from a partitioned compiled image, one tile per rank.

    ``image.partition`` is ``"col"`` or ``"row"`` and
    ``mesh.shape["model"] == image.devices`` (the dispatcher checks).
    Returns float32, the same contract as the on-the-fly backends.
    ``local`` (the image's partition, or None) selects the local form:
    a ``"col"`` tile's columns stay on the rank, a ``"row"`` tile takes
    ``x`` as the rank's N range.

    ``post`` (a :class:`~repro_torch.core.datapath.Postreduce`) runs where
    the chip applies it: column tiles rescale and post-reduce their own
    columns with their register slices (fused into the kernel where it
    is per column, as the unsharded kernel backend fuses it); row tiles
    apply the rescale and the epilogue right after the all-reduce."""
    part = image.partition
    if part not in ("col", "row"):
        raise ValueError(f"image {image.path!r} is not partitioned")
    if spec.backend not in SHARD_BACKENDS:
        raise ValueError(
            f"backend {spec.backend!r} has no sharded execution path; "
            f"mesh-partitioned images support {', '.join(SHARD_BACKENDS)}")
    if local not in (None, part):
        raise ValueError(f"image {image.path!r} is a {part!r} tile: no "
                         f"local {local!r} form")
    # the global grid: before any split, or over a local row input's
    # blocks by the max of their amax
    qx = quantize_input(x, spec, split=model_block(mesh)
                        if local == "row" else None)
    lead = _data_axis(mesh, qx.q.shape)
    rows = int(qx.q.shape[0]) if qx.q.ndim >= 2 else 0
    q, xsc = qx.q, qx.scale
    if lead is not None:
        q = _rows(q, mesh)
        xsc = _local_operand(xsc, "row", 0, mesh, lead, rows)
    ws, wq, wsc = _image_tile(image, mesh)
    m = image.m
    if part == "row" and local is None:
        lo, hi = tile_bounds(image.n, image.devices, mesh.index("model"))
        q = q[..., lo:hi]
    if post is not None:
        post = dataclasses.replace(
            post, scale=_local_operand(post.scale, part, m, mesh, lead, rows),
            bias=_local_operand(post.bias, part, m, mesh, lead, rows))
    cfg = spec.bpbs()
    # the integer result of this rank's tile, or for a column tile on the
    # kernel its rescaled and post-reduced output
    if spec.backend == "kernel" and part == "col":
        y = kernel_from_planes(QTensor(q, xsc, spec.bx, spec.coding), ws,
                               wsc, spec, post)
    elif spec.backend == "kernel":
        from repro_torch.kernels import ops as kernel_ops

        y = kernel_ops.cima_mvm_from_planes(q, ws, cfg)
    elif spec.backend == "digital_int":
        y = torch.einsum("...n,nm->...m", q.to(torch.float32),
                         wq.to(torch.float32))
    elif spec.backend == "bpbs":
        y = bpbs_matmul_planes(q, ws.to(torch.float32), cfg,
                               _rank_generator(generator, mesh, lead))
    else:
        y = bpbs_matmul_planes_reference(q, ws.to(torch.float32), cfg)
    if part == "row":
        y = mesh.all_reduce(y, "model")
    if not (spec.backend == "kernel" and part == "col"):
        y = apply_post(rescale(y, xsc, wsc, spec), post, spec)
    if part == "col" and local is None:
        y = mesh.all_gather(y, "model", dim=-1)
    if lead is not None:
        y = mesh.all_gather(y, "data", dim=0)
    return y
