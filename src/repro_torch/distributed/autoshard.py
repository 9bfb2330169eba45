"""The ambient serving mesh.  Port of ``repro.distributed.autoshard``.

:func:`use_mesh` sets the :class:`~repro_torch.launch.mesh.ServeMesh`
(and its :class:`~repro_torch.distributed.sharding.ShardPolicy`) that
:func:`repro_torch.accel.matmul` consults: a compiled image partitioned
for the mesh's ``"model"`` axis runs as this rank's tile
(:mod:`repro_torch.accel.shard`).  Without a mesh every call runs whole,
so model code stays mesh-agnostic.

:func:`manual` marks mesh axes this code already runs split on, as the
reference's ``shard_map`` body does for all of them: with no names every
axis is manual and dispatch runs nothing sharded inside; with
``manual("data")`` the activations are this data shard's rows (the
serving engine's decode), so a partitioned matmul splits nothing more
over ``"data"``.

The reference's ``cs`` activation constraints.  Its attention puts
``"tp"`` on the kv heads, the GQA group, the query rows or the head dim
of q, k and v (``_attn_tp_mode``); the port's counterpart is explicit.
:func:`use_mesh` also carries the partitions of the program the ranks
run (``tiles``: the serving engine's compiled images, a policy tag to
``"col"`` or ``"row"``, read by :func:`mesh_tiles`), from which
``models.attention.head_split`` decides, as the reference's
``_attn_tp_mode`` does, where an attention call splits.  On the rank's
own heads (``"kv"``, ``"g"``) the layer asks
:func:`repro_torch.accel.matmul` for the two local forms by argument
(``local="col"``: the column tile's output stays on the rank;
``local="row"``: the input already is the rank's N range, its row
statistic reduced over ``"model"`` by :func:`model_block`).  On its
query rows or head dims (``"sq"``, ``"d"``; no tiles needed) attention
itself runs on the rank's share between gathered projections, the
scores summed over ``"model"`` in ``"d"``
(``models.attention.split_sdpa``).  MLA, the SSD mixer and the RG-LRU
run on the rank's share of the dims the reference's ``cs`` constraints
on q and ``kvu``, on ``xs`` and on ``xr`` put on ``"tp"``
(``models.mixer_split``): MLA's heads with its q and ``w_ukv`` tiles
local, SSD's heads or head dims and the LRU width with their scans and
states, the projections around them local where the tiles allow.  Every
other activation stays whole on the model axis.  A training step's :func:`global_batch` scope
carries no tiles and splits no attention, so the mesh form of training
is untouched by them.  The MoE block's two
constraints (the dispatch buffer and the expert outputs sharded on their
expert axis over ``"tp"``) are carried into a training step on a mesh
by :func:`gather`, a differentiable all-gather whose backward follows
what the gathered axes mean for the step:

* over the dp axes, whose ranks hold different rows of the global batch
  and so different losses, the gradient is summed over the axes and
  this rank's block kept (a reduce-scatter): each rank's block then
  carries every rank's loss;
* over an axis whose ranks compute the same rows downstream (``"model"``
  in mode ``"2d"``), each rank already holds the whole gradient: its
  block is kept, with no sum (a sum would count it ``model`` times).

:func:`sum_grad` is the dual of the second: the identity on a tensor
every rank of an axis holds whole, feeding work the ranks split (the
experts on ``"model"``), whose backward sums the ranks' partial
gradients.

:func:`global_batch` is the training step's scope, the reference's
``jit``-with-shardings form: this rank holds its block of the global
batch over the policy's dp axes, and batch-wide statistics are the
global batch's.  :func:`batch_stats` hands them the reductions (a
per-tensor input scale's amax, the XNOR 1-bit mean, the loss's token
count); :func:`train_mesh` the scope itself (the mesh, the policy, the
dp axes), also where the dp axes are one rank wide; :func:`local_stats`
turns the reductions off for a block whose operands are already the
global batch's.  It is distinct from ``manual("data")``, the serving
engine's ``shard_map`` form, where each data shard quantizes its own
rows.  The scope is held module-wide, not per thread: a remat layer's
replay runs in autograd's device thread and must see the statistics and
issue the collectives the forward did.

A ``global_batch(..., tp=True)`` scope is a tensor-parallel training
step (mode ``"2d"``): each model rank holds its ``"model"`` slice of
every parameter its block splits and computes its share
(:func:`tp_mesh`; ``models.layers``, ``models.attention``).  Its
activations are either *replicated* (every model rank holds the same
tensor and, downstream of it, the same gradient: the residual stream)
or the rank's own share, and three operators move between the two under
autograd:

* :func:`sum_grad`: a replicated tensor feeding work the ranks split;
  the backward sums the ranks' partial gradients (an all-reduce);
* :func:`reduce`: the sum over the ranks of their partial results (a
  row tile's partial sums, ``"d"``'s partial scores), replicated after;
  the backward is the identity, since every rank's gradient of the sum
  is the whole one;
* :func:`gather` over ``"model"``: the ranks' blocks joined; the
  backward keeps the rank's block, and with ``partial=True`` first sums
  the gradient over the ranks (a reduce-scatter), where each rank's
  downstream work used only its share of the gathered tensor.

A row-parallel projection's column form moves its operands' int8 grids
inside one straight-through call (``accel.train_shard``), whose
backward is the row tile's and moves nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, NamedTuple, Optional

import torch

_AXES = ("data", "model")
_STATE = threading.local()
_GLOBAL_BATCH: list = []


def set_mesh(mesh, policy=None) -> None:
    """Set the ambient mesh and, optionally, the ambient ShardPolicy."""
    _STATE.mesh = mesh
    _STATE.policy = policy


def get_mesh():
    return getattr(_STATE, "mesh", None)


def mesh_axis_size(name: str) -> int:
    """Size of one ambient-mesh axis: 1 when no mesh is set or the mesh
    does not carry the axis."""
    mesh = get_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return int(dict(mesh.shape)[name])


def get_shard_policy():
    """The ambient ShardPolicy (the module default when none is set)."""
    from .sharding import resolve_policy

    return resolve_policy(getattr(_STATE, "policy", None))


@contextlib.contextmanager
def use_mesh(mesh, policy=None, tiles=None) -> Iterator[None]:
    """Scope of the ambient mesh and policy; ``tiles`` (a policy tag to
    the partition of its compiled image on this mesh) names the tiles
    the ranks hold, where the code in scope runs a partitioned program
    (the serving engine)."""
    prev = get_mesh(), getattr(_STATE, "policy", None), mesh_tiles()
    set_mesh(mesh, policy)
    _STATE.tiles = dict(tiles or {})
    try:
        yield
    finally:
        set_mesh(*prev[:2])
        _STATE.tiles = prev[2]


def mesh_tiles() -> dict:
    """The innermost :func:`use_mesh` scope's tiles: a policy tag to
    ``"col"`` or ``"row"``; empty outside one, or where the scope runs no
    partitioned program."""
    return getattr(_STATE, "tiles", {})


@contextlib.contextmanager
def manual(*axes: str) -> Iterator[None]:
    """Scope in which ``axes`` (every axis when none are named) are
    already split by the code that runs in it."""
    prev = getattr(_STATE, "manual", frozenset())
    _STATE.manual = prev | frozenset(axes or _AXES)
    try:
        yield
    finally:
        _STATE.manual = prev


def in_manual(axis: Optional[str] = None) -> bool:
    """Is ``axis`` (every axis, when None) manual here?"""
    m = getattr(_STATE, "manual", frozenset())
    return axis in m if axis is not None else all(a in m for a in _AXES)


class BatchStats(NamedTuple):
    """A :func:`global_batch` scope: the ranks that hold the rest of the
    global batch (``axes`` of ``mesh``, the ``policy``'s dp axes, ``size``
    ranks in all, each holding an equal block of rows) and the
    reductions of a batch statistic over them."""

    mesh: object
    axes: tuple
    size: int
    policy: object = None
    tp: bool = False

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axes, op="max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axes)

    def dp_index(self) -> int:
        """This rank's block of the global batch (row-major over the dp
        axes, as ``batch_specs`` cuts it)."""
        idx = 0
        for a in self.axes:
            idx = idx * self.mesh.size(a) + self.mesh.index(a)
        return idx


def model_block(mesh) -> BatchStats:
    """The reductions of a statistic over the ``"model"`` ranks of
    ``mesh``, each of which holds an equal block of the operand's last
    dim (a local row tile's input): its amax is the whole row's."""
    return BatchStats(mesh, ("model",), mesh.size("model"))


@contextlib.contextmanager
def global_batch(mesh, policy=None, tp: bool = False) -> Iterator[None]:
    """Scope in which this rank holds its block of the global batch over
    ``policy``'s dp axes of ``mesh`` and batch statistics are global;
    with ``tp`` (mode ``"2d"``) the rank computes its share of every
    block the training step splits over ``"model"`` (:func:`tp_mesh`)."""
    from .sharding import resolve_policy

    policy = resolve_policy(policy)
    axes = policy.dp_axes(mesh)
    _GLOBAL_BATCH.append(BatchStats(mesh, axes, mesh.size_of(axes), policy,
                                    tp))
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


@contextlib.contextmanager
def local_stats() -> Iterator[None]:
    """Scope in which batch statistics are the operands' own (no
    :func:`global_batch` reduction): a block whose inputs every rank
    already holds for the whole global batch."""
    _GLOBAL_BATCH.append(None)
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


def train_mesh() -> Optional[BatchStats]:
    """The innermost :func:`global_batch` scope; None outside one (or
    inside :func:`local_stats`)."""
    return _GLOBAL_BATCH[-1] if _GLOBAL_BATCH else None


def tp_mesh():
    """The mesh of the innermost :func:`global_batch` scope where it is a
    tensor-parallel step (``tp=True``, mode ``"2d"``, a ``"model"`` axis
    wider than 1), else None."""
    scope = train_mesh()
    if scope is None or not scope.tp or scope.policy is None \
            or scope.policy.is_fsdp or "model" not in scope.mesh.axis_names \
            or scope.mesh.size("model") <= 1:
        return None
    return scope.mesh


def batch_stats() -> Optional[BatchStats]:
    """The innermost :func:`global_batch` scope where its batch
    statistics need reducing; None outside one, inside
    :func:`local_stats`, or where the dp axes hold the whole batch on
    every rank."""
    scope = train_mesh()
    return scope if scope is not None and scope.size > 1 else None


class _Gather(torch.autograd.Function):
    """:meth:`ServeMesh.all_gather` whose backward reduce-scatters over
    ``summed`` axes and keeps this rank's block over the others."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, summed):
        ctx.mesh, ctx.axes, ctx.dim, ctx.summed = mesh, axes, dim, summed
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        for a in ctx.axes:               # outermost first: row-major blocks
            if a in ctx.summed:
                g = mesh.reduce_scatter(g, a, dim)
            else:
                size = g.shape[dim] // mesh.size(a)
                g = g.narrow(dim, mesh.index(a) * size, size)
        return g, None, None, None, None


def gather(t: torch.Tensor, axes, dim: int,
           partial: bool = False) -> torch.Tensor:
    """This rank's ``t`` and the other ranks' of ``axes`` (an axis or a
    tuple) joined on ``dim`` in mesh order, inside a :func:`global_batch`
    scope, differentiably: the backward sums the gradient over the
    scope's dp axes among ``axes`` (and over all of ``axes`` with
    ``partial``: each rank's downstream work used only its share of the
    result) and keeps this rank's block over each (see the module
    docstring)."""
    scope = train_mesh()
    if scope is None:
        raise RuntimeError("gather runs inside a global_batch scope")
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if scope.mesh.size_of(axes) == 1:
        return t
    summed = axes if partial else tuple(a for a in axes if a in scope.axes)
    return _Gather.apply(t, scope.mesh, axes, dim, summed)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


def sum_grad(t: torch.Tensor, axes) -> torch.Tensor:
    """``t``, whose gradient is summed over ``axes`` in the backward: a
    tensor every rank of ``axes`` holds whole and feeds a part of the
    work they split (inside a :func:`global_batch` scope)."""
    scope = train_mesh()
    if scope is None:
        raise RuntimeError("sum_grad runs inside a global_batch scope")
    if scope.mesh.size_of(axes) == 1:
        return t
    return _SumGrad.apply(t, scope.mesh, axes)


class _Reduce(torch.autograd.Function):
    """:meth:`ServeMesh.all_reduce` (a sum) whose backward is the
    identity."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce(t: torch.Tensor, axes="model") -> torch.Tensor:
    """The sum of the ranks' ``t`` over ``axes`` inside a
    :func:`global_batch` scope: partial results (a row tile's partial
    sums, the ``"d"`` split's partial scores) made whole on every rank.
    The backward is the identity: every rank computes the same function
    of the sum downstream, so each holds the whole gradient of the sum,
    which is its own operand's."""
    scope = train_mesh()
    if scope is None:
        raise RuntimeError("reduce runs inside a global_batch scope")
    if scope.mesh.size_of(axes) == 1:
        return t
    return _Reduce.apply(t, scope.mesh, axes)

