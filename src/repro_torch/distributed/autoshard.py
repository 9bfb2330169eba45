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

The reference's ``cs`` activation constraints have no counterpart: the
port keeps activations replicated over the model axis, so there is
nothing to constrain.

:func:`global_batch` is the training step's scope, the reference's
``jit``-with-shardings form: this rank holds its block of the global
batch over the policy's dp axes, and batch-wide statistics are the
global batch's.  :func:`batch_stats` hands them the reductions (a
per-tensor input scale's amax, the XNOR 1-bit mean, the loss's token
count).  It is distinct from ``manual("data")``, the serving engine's
``shard_map`` form, where each data shard quantizes its own rows.  The
scope is held module-wide, not per thread: a remat layer's replay runs
in autograd's device thread and must see the statistics the forward saw.
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
def use_mesh(mesh, policy=None) -> Iterator[None]:
    prev, prev_pol = get_mesh(), getattr(_STATE, "policy", None)
    set_mesh(mesh, policy)
    try:
        yield
    finally:
        set_mesh(prev, prev_pol)


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
    """Reductions of a batch statistic over the ranks that hold the rest
    of the global batch: ``axes`` of ``mesh``, ``size`` ranks in all,
    each holding an equal block of rows."""

    mesh: object
    axes: tuple
    size: int

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axes, op="max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, self.axes)


@contextlib.contextmanager
def global_batch(mesh, policy=None) -> Iterator[None]:
    """Scope in which this rank holds its block of the global batch over
    ``policy``'s dp axes of ``mesh`` and batch statistics are global."""
    from .sharding import resolve_policy

    axes = resolve_policy(policy).dp_axes(mesh)
    size = mesh.size_of(axes)
    _GLOBAL_BATCH.append(BatchStats(mesh, axes, size) if size > 1 else None)
    try:
        yield
    finally:
        _GLOBAL_BATCH.pop()


def batch_stats() -> Optional[BatchStats]:
    """The innermost :func:`global_batch` scope's reductions; None outside
    one, or where the dp axes hold the whole batch on every rank."""
    return _GLOBAL_BATCH[-1] if _GLOBAL_BATCH else None
