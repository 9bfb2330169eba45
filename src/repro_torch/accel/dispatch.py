"""The single matmul entry point every managed projection goes through.
Port of ``repro.accel.dispatch``.

``matmul`` resolves the effective spec (applying any scoped
:func:`~repro_torch.accel.context.override`), validates a compiled weight
``image`` against it, records one :class:`MvmRecord` inside a
:func:`~repro_torch.accel.context.trace` scope (with the image's reload
schedule and the measured input sparsity and all-zero planes), takes the
call's ADC-noise generator from an open
:func:`~repro_torch.accel.context.adc_noise` scope and calls the
registered backend.

Non-digital backends get straight-through-estimator (STE) gradients: the
backward pass is that of the plain float GEMM (``dx = g wᵀ``,
``dw = Σ x ⊗ g`` in float32), which is what quantization-aware training
of the paper's CIFAR networks uses.  Those GEMMs follow the process's
TF32 setting, which torch leaves off; the reference holds them to
float32 products.  When autograd records the call, a
``post`` epilogue runs unfused after the STE matmul, under autograd, as
the reference differentiates matmul-then-epilogue; otherwise (serving
under ``inference_mode``, or nothing requires grad) the backend runs it
fused, as before.

A **grouped** call (``w`` [G, N, M], ``x`` [G, ..., N], an image stacked
[G, ...]) is G independent products in one dispatch: what the reference
computes by ``jax.vmap`` over the MoE experts.  Each group keeps its own
input and weight scales, its own image slice and the shared epilogue, so
the result equals a loop of 2-D dispatches over the groups bit for bit.
A backend marked ``grouped`` (the kernel: one grouped launch) takes the
whole call; any other runs group by group.  Under autograd the forward
stays that one dispatch and the backward is the float GEMM per group
(``dx_g = g_g w_gᵀ``, ``dw_g = x_gᵀ g_g``); a grouped input that is an
``expand``ed view (whisper's encoder output over its decoder layers)
gets its ``dx`` summed by the view's own backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tally
from repro_torch.analysis.sanitize import active as _san_active
from repro_torch.core.quant import quantize
from repro_torch.core.sparsity import (count_zero_planes, element_mask,
                                       sparsity_fraction)

from .context import (ExecContext, MvmRecord, current_override,
                      current_pad_mask, next_noise_generator, record,
                      streamed_load_seen, tracing)
from .registry import get_backend
from .spec import ExecSpec


def _guard_out(y: torch.Tensor, spec: ExecSpec) -> torch.Tensor:
    """Sanitizer NaN/Inf guard on the dispatch output (on the kernel
    backend: the launch's own result, its fused epilogue included)."""
    san = _san_active()
    if san is not None:
        san.check_finite(y, f"accel.matmul[{spec.tag or spec.backend}] "
                            f"output")
    return y


def _strip_pad(x: torch.Tensor) -> torch.Tensor:
    """Drop positions an ambient :func:`~repro_torch.accel.context.
    pad_positions` scope marks as padding before measuring sparsity
    (left-pad zeros are no exploitable sparsity); a mask whose shape
    does not prefix-match ``x`` (the unembed's last-token slice) is
    ignored."""
    mask = current_pad_mask()
    if mask is None:
        return x
    if mask.ndim >= x.ndim or tuple(x.shape[:mask.ndim]) != \
            tuple(mask.shape):
        return x
    return x[mask.to(device=x.device, dtype=torch.bool)]


def _measured_sparsity(spec: ExecSpec, x: torch.Tensor) -> Optional[float]:
    """The zero fraction of the input quantized onto the spec's grid: the
    broadcasts the AND-logic controller gates (paper Fig. 6b)."""
    if spec.backend == "digital":
        return None
    qx = quantize(_strip_pad(x), spec.bx, spec.coding,
                  per_row=spec.x_per_row)
    return float(sparsity_fraction(element_mask(qx.q)))


def _measured_planes(spec: ExecSpec, x: torch.Tensor) \
        -> tuple[Optional[int], Optional[int]]:
    """``(planes_skipped, planes_total)``: all-zero (bank, input-plane)
    serial steps at the spec's banking.  Pad positions stay in: the skip
    predicate sees the padded batch."""
    if spec.backend == "digital" or not spec.skip_zero_planes:
        return None, None
    qx = quantize(x, spec.bx, spec.coding, per_row=spec.x_per_row)
    return count_zero_planes(qx.q, spec.bpbs())


def _record_mvm(spec: ExecSpec, x: torch.Tensor, w: torch.Tensor,
                image=None, post=None, local: Optional[str] = None) \
        -> None:
    """One :class:`MvmRecord` into every open trace.  Outside a trace it
    does nothing: the measurements read counts back to the host, and the
    serving path must not pay for them.  A grouped call records one
    group's shape and rows (the caller's :func:`~repro_torch.accel.
    context.vmapped` scales them) and measures no sparsity, as the
    reference sees tracers under ``vmap``.  A local row input
    (``local="row"``) holds only the rank's N range: its record keeps
    the logical shape and calls and measures no sparsity either, since
    measuring the whole input would take a collective that only the
    ranks inside a trace issue."""
    if not tracing():
        return
    grouped = w.ndim == 3
    unmeasured = grouped or local == "row"
    streamed = image is not None and not image.resident
    overlap = streamed and image.overlap
    # the first streamed load of a pass has no compute to hide behind;
    # checked against the innermost trace before this record lands
    prologue = 1 if (overlap and not streamed_load_seen()) else 0
    skipped, total = ((None, None) if unmeasured
                      else _measured_planes(spec, x))
    calls = int(math.prod(x.shape[int(grouped):-1]))
    from repro_torch.distributed.autoshard import in_manual, mesh_axis_size

    if in_manual("data"):
        # the data shards' rows together: the record stays logical
        calls *= mesh_axis_size("data")
    record(MvmRecord(
        tag=spec.tag, backend=spec.backend,
        n=int(w.shape[-2]), m=int(w.shape[-1]), ba=spec.ba, bx=spec.bx,
        calls=calls,
        program=image is not None,
        loads=1 if streamed else 0,
        load_segments=image.segments if streamed else 0,
        stream_overlap=overlap,
        load_prologue=prologue,
        devices=image.devices if image is not None else 1,
        partition=(image.partition or "") if image is not None else "",
        data_shards=(max(image.data_shards, 1) if image is not None
                     else 1),
        post_ops=post.n_ops() if post is not None else 0,
        sparsity=None if unmeasured else _measured_sparsity(spec, x),
        planes_skipped=skipped,
        planes_total=total))


def _shard_mesh(image):
    """The ambient mesh, iff it matches the image's compiled partition
    and its model axis is not already manual.  An image that holds one
    tile cannot run without its mesh."""
    if image is None or image.partition is None or image.devices <= 1:
        return None
    from repro_torch.distributed.autoshard import get_mesh, in_manual

    mesh = get_mesh()
    if mesh is None or in_manual("model") \
            or "model" not in mesh.axis_names \
            or int(dict(mesh.shape)["model"]) != image.devices:
        mesh = None
    if mesh is None and image.tile is not None:
        raise RuntimeError(
            f"image {image.path!r} holds tile {image.tile} of "
            f"{image.devices}: run it under its mesh (distributed.use_mesh, "
            f"as the serving engine does)")
    return mesh


def _sharded(image, mesh, local=None):
    """A backend-shaped call of the mesh-partitioned program path."""
    from .shard import sharded_program_matmul

    def fn(x, w, spec, ctx):
        return sharded_program_matmul(x, spec, image, mesh,
                                      generator=ctx.generator, post=ctx.post,
                                      local=local)
    return fn


def _train_tile(tile: str, image, local):
    """The backend call of a tensor-parallel training step's ``tile``
    (:mod:`repro_torch.accel.train_shard`) on the step's mesh."""
    from repro_torch.distributed.autoshard import tp_mesh

    from .train_shard import tile_backend

    mesh = tp_mesh()
    if mesh is None or image is not None or local is not None:
        raise ValueError(f"tile={tile!r} runs inside a tensor-parallel "
                         f"training step (global_batch(..., tp=True)) on a "
                         f"weight slice, without an image or a local form")
    return tile_backend(tile, mesh)


def _report_form(spec: ExecSpec, w: torch.Tensor,
                 tile: Optional[str]) -> None:
    """Inside a mesh training step, the form this projection runs in
    (``tile``, or ``"whole"``) and the ``[N, M]`` of the weight its
    backend multiplies (a column form's re-laid-out column tile), to the
    open counters (:func:`repro_torch.tally.report_form`)."""
    from repro_torch.distributed.autoshard import tp_mesh, train_mesh

    if train_mesh() is None:
        return
    n, m = (int(d) for d in w.shape[-2:])
    if tile == "col-form":
        parts = tp_mesh().size("model")
        n, m = n * parts, m // parts
    tally.report_form(spec.tag or spec.backend,
                      {"form": tile or "whole", "tile": [n, m]})


def _check_width(x: torch.Tensor, w: torch.Tensor, image, mesh,
                 local: Optional[str]) -> None:
    """A local form runs only as its image's tile on the image's mesh,
    and only outside autograd; the input is ``n / devices`` wide in the
    local row form and ``n`` wide everywhere else."""
    n = int(w.shape[-2])
    if local is not None:
        if local not in ("col", "row"):
            raise ValueError(f"local must be 'col', 'row' or None, got "
                             f"{local!r}")
        if mesh is None or image.partition != local or w.ndim != 2:
            raise ValueError(
                f"local={local!r} needs a 2-D call on a {local!r}-"
                f"partitioned image under its mesh; got image "
                f"{getattr(image, 'path', None)!r} partition "
                f"{getattr(image, 'partition', None)!r}"
                f"{'' if mesh is not None else ' and no matching mesh'}")
        if _records_grad(x, w):
            raise ValueError(f"local={local!r} runs under inference only")
        if local == "row":
            n //= image.devices
    if int(x.shape[-1]) != n:
        raise ValueError(
            f"input width {int(x.shape[-1])} against a weight of "
            f"{int(w.shape[-2])} rows: " + (
                f"the local row form takes this rank's {n}" if local == "row"
                else "an input of n / devices runs only as local='row'"))


def _run(fn, x, w, spec: ExecSpec, ctx: ExecContext) -> torch.Tensor:
    """The backend on a 2-D call, or on a grouped one: whole where the
    backend takes groups, else group by group with each group's image
    slice, stacked."""
    if w.ndim == 2 or getattr(fn, "grouped", False):
        return fn(x, w, spec, ctx)
    img = ctx.image
    return torch.stack([
        fn(x[g], w[g], spec, dataclasses.replace(
            ctx, image=img.layer(g) if img is not None else None))
        for g in range(w.shape[0])])


class _StraightThrough(torch.autograd.Function):
    """The backend's forward on the float32 operands (one grouped launch
    on the kernel for a grouped call); the backward of the plain float
    GEMM, per group for a grouped call (the reference's ``custom_vjp``
    ``_bwd``, under ``jax.vmap`` for the grouped one)."""

    @staticmethod
    def forward(ctx, x, w, fn, spec, ectx):
        ctx.save_for_backward(x, w)
        return _run(fn, x, w, spec, ectx)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        grouped = w.ndim == 3
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("g...m,gnm->g...n" if grouped
                              else "...m,nm->...n", g, w)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("g...n,g...m->gnm" if grouped
                              else "...n,...m->nm", x, g)
        return dx, dw, None, None, None


def _records_grad(*ts) -> bool:
    """Does autograd record an op on these operands?"""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in ts)


def matmul(x: torch.Tensor, w: torch.Tensor, spec: Optional[ExecSpec] = None,
           ctx: Optional[ExecContext] = None, *, dtype=None, image=None,
           post=None, local: Optional[str] = None,
           tile: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` under ``spec``'s execution backend.

    * ``spec=None`` means *digital by design*: a plain GEMM at ``dtype``
      (default ``x.dtype``), exempt from overrides and tracing.
    * A digital spec computes at ``dtype`` and returns that dtype; it
      takes no STE (autograd differentiates the GEMM itself).
    * Any other backend quantizes per its spec, computes in float32 with
      STE gradients and returns float32 — callers cast.
    * ``image``: this projection's compiled
      :class:`~repro_torch.accel.program.CimaImage`; used when it matches
      the resolved spec (bit-for-bit the on-the-fly result, zero weight
      quantize ops), dropped otherwise.
    * ``post``: a :class:`~repro_torch.core.datapath.Postreduce` epilogue
      run fused at the backend; the result is bit-for-bit
      ``post.apply(matmul(x, w, spec))`` wherever the backend composes
      the two, and fused into the kernel where it is per column.  When
      autograd records the call, the backend runs without it and
      ``post.apply`` follows under autograd (STE through the matmul, the
      true gradient through the epilogue and its registers).
    * A partitioned ``image`` under a matching ambient mesh
      (:func:`~repro_torch.distributed.autoshard.use_mesh`) runs as this
      rank's tile (:mod:`repro_torch.accel.shard`); the one record is
      logical, written before the sharded body (a local row call's
      measures no sparsity: :func:`_record_mvm`).  ``local="col"`` keeps
      a column tile's output on the rank (``[..., m / devices]``);
      ``local="row"`` takes ``x`` as the rank's N range of a row tile
      (``[..., n / devices]``), whose scale is reduced over the model
      axis (:mod:`repro_torch.accel.shard`).  Any other call with an
      input of ``n / devices`` raises.
    * ``tile`` (inside a tensor-parallel training step, ``distributed.
      autoshard.tp_mesh``): ``w`` is the rank's slice of the weight and
      the call runs the rank's tile (:mod:`repro_torch.accel.
      train_shard`): ``"col"``, ``w`` its output columns and ``x``
      whole; ``"row"``, ``w`` its rows and ``x`` its N block, the
      partial sums reduced over ``"model"``; ``"col-form"``, the same
      operands, the rank's columns computed on the gathered grids and
      gathered.  The forward and backward are those of any call on
      ``w`` (straight-through on the quantizing backends: ``dx = g wᵀ``,
      ``dw = xᵀ g`` on the tile, which for a row tile or the column form
      are the rank's block of ``dx`` and rows of ``dw``).
    * Grouped: ``w`` [G, N, M] and ``x`` [G, ..., N] (``image`` stacked
      [G, ...], ``post`` shared by the groups) -> [G, ..., M], equal to a
      loop of 2-D calls over the groups.  A digital spec differentiates
      natively; a quantizing one takes the straight-through backward
      per group, and a shared ``post``'s register cotangents sum over
      the groups (the reference's ``vmap`` of its ``custom_vjp``).
    """
    if spec is None:
        dt = dtype or x.dtype
        y = torch.einsum("...n,nm->...m", x.to(dt), w.to(dt))
        if tile == "row":
            from repro_torch.distributed.autoshard import reduce

            y = reduce(y)
        return post.apply(y) if post is not None else y

    ov = current_override()
    if ov:
        spec = dataclasses.replace(spec, **ov)
    if tally.ACTIVE:
        _report_form(spec, w, tile)

    from .program import image_matches

    if tile is not None:
        fn = _train_tile(tile, image, local)
        image = None
        _record_mvm(spec, x, w, None, post,
                    None if tile == "col" else "row")
    else:
        if image is not None and not image_matches(image, spec, w):
            image = None
        mesh = _shard_mesh(image)
        _check_width(x, w, image, mesh, local)
        _record_mvm(spec, x, w, image, post, local)
        # a partitioned image on its mesh runs as this rank's tile
        fn = (_sharded(image, mesh, local) if mesh is not None
              else get_backend(spec.backend))
    if ctx is None:
        ctx = ExecContext(generator=next_noise_generator(x.device))
    if image is not None:
        ctx = dataclasses.replace(ctx, image=image)
    san = _san_active()
    if san is not None:
        where = spec.tag or spec.backend
        san.observe_dispatch(spec, ctx)
        san.check_finite(x, f"accel.matmul[{where}] input")
        san.check_finite(w, f"accel.matmul[{where}] weight")
    if spec.is_digital:
        dt = dtype or x.dtype
        if post is not None:
            ctx = dataclasses.replace(ctx, post=post)
        return _guard_out(_run(fn, x.to(dt), w.to(dt), spec, ctx), spec)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    regs = (post.scale, post.bias) if post is not None else ()
    if _records_grad(xf, wf, *regs):
        y = _StraightThrough.apply(xf, wf, fn, spec,
                                   dataclasses.replace(ctx, post=None))
        return _guard_out(post.apply(y, spec.bx, spec.ba)
                          if post is not None else y, spec)
    if post is not None:
        ctx = dataclasses.replace(ctx, post=post)
    return _guard_out(_run(fn, xf, wf, spec, ctx), spec)
