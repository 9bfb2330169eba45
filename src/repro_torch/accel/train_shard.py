"""A tensor-parallel training step's tiles: each rank's share of a
projection whose weight slice it holds under ``state_specs`` (the
training sibling of :mod:`repro_torch.accel.shard`, which runs a
compiled program's tiles for serving).

Three forms, asked for by :func:`repro_torch.accel.matmul`'s ``tile``:

* ``"col"``: the weight is the rank's column tile ``[N, M/m]`` and the
  input is whole; the rank computes its output columns.  Every column
  sees all N rows, so its bits are the unsharded call's whatever the
  banking.  A per-column weight scale is the tile's own; a per-tensor
  one is the ``max`` over ``"model"`` of the tiles' amax.
* ``"row"`` (Megatron): the weight is the rank's rows ``[N/m, M]`` and
  the input the rank's N block of every row; the integer partial sums
  of the rank's banks are summed over ``"model"`` before the rescale.
  The input's amax (per row, or per tensor over the dp axes too) and
  the weight's (per column, or per tensor) are the ``max`` over
  ``"model"`` of the blocks', so the grids are the whole operands'.
  Exact only where no ADC sees a partial bank (:func:`row_form_ok`):
  on ``digital_int`` always, on ``bpbs``, ``bpbs_ref`` and ``kernel``
  where the rank's N block is whole banks.  An XNOR 1-bit input scale
  is a mean, which a sum over blocks would change: it takes no row form.
* ``"col-form"``, a row-parallel projection wherever the row tile is
  not exact: the same operands as ``"row"`` (the rank's N block and its
  rows), whose grids are set as the row tile sets them (the ``max`` of
  the blocks' amax) and then moved as int8: the input's blocks gathered
  over ``"model"``, the weight's rows re-laid out as the rank's column
  tile ``[N, M/m]`` (:meth:`~repro_torch.launch.mesh.ServeMesh.
  all_to_all`).  The rank computes its columns on the whole banks, and
  the columns are gathered, so every rank holds the whole output with
  the unsharded call's bits whatever the banking.  An XNOR 1-bit input
  (a mean) is gathered as floats and quantized whole; an XNOR 1-bit
  weight's columns are re-laid out as floats and quantized as columns.
  Its straight-through backward is the row tile's (``dx = g wᵀ`` on the
  rank's rows, ``dw = xᵀ g``: the whole output's gradient is on every
  rank), so the backward moves nothing.

On ``kernel`` the rank's tile is the BP/BS kernel ``cima_mvm.cu``'s
call on ``[N, M/m]`` or ``[N/m, M]`` planes (its plain version on CPU
tensors); a per-column epilogue fuses into a column tile's launch, as
the unsharded call fuses it.  A row tile's epilogue runs after the
reduce, a column form's after its gather.  Each rank's ADC noise (``bpbs`` at ``adc_sigma_lsb > 0``) comes
from the dispatch's generator folded with the rank's coordinates.
"""
from __future__ import annotations

import torch

from repro_torch.core.bpbs import (bpbs_matmul_planes,
                                   bpbs_matmul_planes_reference,
                                   weight_planes)
from repro_torch.core.quant import Coding, QTensor, quantize
from repro_torch.distributed.autoshard import (BatchStats, batch_stats,
                                               model_block, reduce)
from repro_torch.kernels import ops as kernel_ops

from .backends import _int8, _kernel_fusable, apply_post, rescale
from .context import fold_seed
from .spec import ExecSpec

TILE_FORMS = ("col", "row", "col-form")
# backends whose per-bank ADC clips a partial bank's popcount
BANKED = ("bpbs", "bpbs_ref", "kernel")


def _xnor1(coding, bits: int) -> bool:
    return Coding(coding) == Coding.XNOR and bits == 1


def row_form_ok(spec: ExecSpec, n_block: int) -> bool:
    """Can a row-parallel projection under ``spec`` run as a Megatron row
    tile of ``n_block`` rows and give the unsharded bits?  ``digital``
    (allclose) and ``digital_int`` always; the banked backends where the
    block is whole banks; never with an XNOR 1-bit input or per-column
    weight scale, both means."""
    if spec.is_digital:
        return True
    if _xnor1(spec.coding, spec.bx) or _xnor1(spec.coding, spec.ba):
        return False
    return spec.backend not in BANKED or n_block % spec.bank_n == 0


def _weight_grid(w: torch.Tensor, spec: ExecSpec, mesh, row: bool) \
        -> QTensor:
    """The tile's weight on the whole weight's grid: a per-column scale
    of a column tile is its own; any other is the ``max`` over
    ``"model"`` of the tiles' (an XNOR 1-bit scale, a mean, refuses)."""
    split = row or not spec.per_channel
    if split and _xnor1(spec.coding, spec.ba):
        raise ValueError(f"{spec.tag or spec.backend}: an XNOR 1-bit weight "
                         f"scale is a mean; a tile cannot reproduce it")
    return quantize(w, spec.ba, spec.coding,
                    axis=1 if spec.per_channel else None,
                    across=model_block(mesh) if split else None)


def _input_grid(x: torch.Tensor, spec: ExecSpec, mesh, row: bool) \
        -> QTensor:
    """The input on the whole input's grid: as it is for a column tile;
    for a row tile's N block the amax over ``"model"`` (per row), or
    over the dp axes and ``"model"`` (per tensor)."""
    from .backends import quantize_input

    if not row:
        return quantize_input(x, spec)
    if _xnor1(spec.coding, spec.bx):
        raise ValueError(f"{spec.tag or spec.backend}: an XNOR 1-bit input "
                         f"scale is a mean; a row tile cannot reproduce it")
    stats = batch_stats()
    axes = ("model",) if spec.x_per_row or stats is None \
        else tuple(stats.axes) + ("model",)
    return _int8(quantize(x, spec.bx, spec.coding, per_row=spec.x_per_row,
                          across=BatchStats(mesh, axes, mesh.size_of(axes))))


def _generator(generator, mesh):
    """The rank's own noise stream: the dispatch's seed folded with its
    model and data coordinates."""
    if generator is None:
        return None
    seed = fold_seed(fold_seed(generator.initial_seed(),
                               mesh.index("model")), mesh.index("data"))
    return torch.Generator(device=generator.device).manual_seed(seed)


def _int_product(qx: QTensor, qw: QTensor, spec: ExecSpec, generator,
                 mesh) -> torch.Tensor:
    """The integer-valued result of the rank's tile on its backend."""
    cfg = spec.bpbs()
    if spec.backend == "digital_int":
        return torch.einsum("...n,nm->...m", qx.q.to(torch.float32),
                            qw.q.to(torch.float32))
    if spec.backend == "kernel":
        return kernel_ops.cima_mvm(qx.q, qw.q, cfg)
    ws = weight_planes(qw.q, cfg).permute(0, 2, 1)
    if spec.backend == "bpbs":
        return bpbs_matmul_planes(qx.q, ws, cfg, _generator(generator, mesh))
    if spec.backend == "bpbs_ref":
        return bpbs_matmul_planes_reference(qx.q, ws, cfg)
    raise ValueError(f"backend {spec.backend!r} has no training tile; "
                     f"tiles run on digital, digital_int, "
                     f"{', '.join(BANKED)}")


def _column_form(x, w, spec: ExecSpec, mesh) -> tuple:
    """``(qx, qw)``: the whole input's grid and the rank's column tile of
    the weight's, from the rank's N block ``x`` and rows ``w`` (see the
    module docstring)."""
    if _xnor1(spec.coding, spec.bx):
        from .backends import quantize_input

        qx = quantize_input(mesh.all_gather(x, "model", x.ndim - 1), spec)
    else:
        qx = _input_grid(x, spec, mesh, True)
        qx = QTensor(mesh.all_gather(qx.q, "model", x.ndim - 1), qx.scale,
                     qx.bits, qx.coding)
    if _xnor1(spec.coding, spec.ba):
        cols = mesh.all_to_all(w, "model", w.ndim - 1, w.ndim - 2)
        return qx, _weight_grid(cols, spec, mesh, False)
    qw = _weight_grid(w, spec, mesh, True)
    cols = mesh.all_to_all(qw.q.to(torch.int8), "model", w.ndim - 1,
                           w.ndim - 2).to(torch.float32)
    scale = qw.scale
    if spec.per_channel:
        size = scale.shape[-1] // mesh.size("model")
        scale = scale.narrow(-1, mesh.index("model") * size, size)
    return qx, QTensor(cols, scale, qw.bits, qw.coding)


def tile_backend(form: str, mesh):
    """A backend-shaped call (``fn(x, w, spec, ctx)``) that runs the
    rank's ``form`` tile of a projection on ``mesh``; ``ctx.post`` runs
    where the unsharded backend runs it (fused into a column tile's
    kernel launch where it is per column, on the whole output after a
    row tile's reduce or a column form's gather)."""
    if form not in TILE_FORMS:
        raise ValueError(f"tile must be one of {TILE_FORMS}, got {form!r}")
    row = form == "row"

    def fn(x, w, spec: ExecSpec, ctx):
        post = ctx.post
        if spec.is_digital:
            if form == "col-form":
                raise ValueError("digital runs a row tile, not the column "
                                 "form")
            y = torch.einsum("...n,nm->...m", x, w)
            return apply_post(reduce(y) if row else y, post, spec)
        if form == "col-form":
            qx, qw = _column_form(x, w, spec, mesh)
            y = rescale(_int_product(qx, qw, spec, ctx.generator, mesh),
                        qx.scale, qw.scale, spec)
            return apply_post(mesh.all_gather(y, "model", y.ndim - 1), post,
                              spec)
        qx = _input_grid(x, spec, mesh, row)
        qw = _weight_grid(w, spec, mesh, row)
        if spec.backend == "kernel" and not row and post is not None \
                and _kernel_fusable(post, int(w.shape[-1])):
            sw = qw.scale.reshape(-1) if spec.per_channel else qw.scale
            escale = qx.scale * sw
            if post.scale is not None:
                escale = escale * post.scale
            return kernel_ops.cima_mvm(
                qx.q, qw.q, spec.bpbs(), escale=escale, pbias=post.bias,
                act=post.act, by_bits=post.resolve_bits(spec.bx, spec.ba))
        y = _int_product(qx, qw, spec, ctx.generator, mesh)
        if row:
            y = mesh.all_reduce(y, "model")
        return apply_post(rescale(y, qx.scale, qw.scale, spec), post, spec)

    return fn
