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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

_AXES = ("data", "model")
_STATE = threading.local()


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
