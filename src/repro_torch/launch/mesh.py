"""Serving meshes over ``torch.distributed``.  Port of
``repro.launch.mesh``.

The port runs a ``data x model`` mesh in SPMD form: one process per mesh
position, as ``torchrun --nproc-per-node`` starts them, every process
running the same program on its own rank.  :class:`ServeMesh` is the
small mesh object the distribution layer reads: the reference's axis
names ``("data", "model")``, the axis sizes as ``shape``, this rank's
coordinates, and one process group per axis (the ranks that share this
rank's data index form its model group, those that share its model
index its data group).

The collective backend is an explicit argument, never chosen by trying:

* ``"nccl"`` when each rank owns a card;
* ``"gloo"`` when ranks share one card (NCCL refuses two ranks on one
  GPU) or run on the CPU.  gloo takes CUDA tensors and moves their bytes
  through host memory itself; only the collective's bytes leave the
  card.

A collective names one mesh axis or a tuple of them; over a tuple it
runs axis by axis (reductions in the tuple's order, gathers innermost
axis first, so a dim split over ``("data", "model")`` reassembles in
row-major block order).  Training adds the max reduction (a shared
quantization scale, ``compress_psum``'s ``pmax``), :meth:`ServeMesh.
all_to_all` (a row-parallel weight re-laid out as a column tile),
:meth:`ServeMesh.reduce_scatter` (the backward of a gather over rows that differ by rank,
:func:`repro_torch.distributed.autoshard.gather`) and :meth:`ServeMesh.
barrier`.  ``stats`` counts the collectives this rank issued and their
bytes; each is also reported, by kind and axis, to every open step
counter (:mod:`repro_torch.tally`).

:func:`make_production_mesh` is the reference's production mesh, 16 x 16
``("data", "model")`` or 2 x 16 x 16 with a leading ``"pod"`` axis, as a
:class:`RecordingMesh`: rank 0's view of it, issuing no communication.
The dry run (:mod:`repro_torch.launch.dryrun`) runs a step on it to
count what rank 0 computes and sends.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tally

AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class ServeMesh:
    """A ``data x model`` mesh seen from one rank.  ``rank`` is this
    process's row-major position (``data_index * model + model_index``);
    without groups (a 1 x 1 mesh, or a shape-only mesh for validation)
    every collective is the identity."""

    data: int = 1
    model: int = 1
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    groups: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> tuple:
        """``(data_index, model_index)`` of this rank."""
        return divmod(self.rank, self.model)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def _group(self, axis: str):
        if self.size(axis) <= 1:
            return None
        if axis not in self.groups:
            raise RuntimeError(f"mesh axis {axis!r} of size "
                               f"{self.size(axis)} has no process group")
        return self.groups[axis]

    def size_of(self, axes) -> int:
        """The product of the sizes of ``axes`` (an axis or a tuple)."""
        return math.prod(self.size(a) for a in _axes(axes))

    def _count(self, t: torch.Tensor, kind: str, axis: str,
               factor: float = 1, op: Optional[str] = None) -> None:
        """Count one collective over ``axis`` on operand ``t``; its result
        is ``factor`` times the operand (an all-gather's group size, a
        reduce-scatter's reciprocal); ``op`` is a reduction's."""
        nbytes = t.numel() * t.element_size()
        self.stats["collectives"] += 1
        self.stats["bytes"] += nbytes
        tally.report_collective(kind, axis, nbytes, int(nbytes * factor),
                                op)

    def all_reduce(self, t: torch.Tensor, axis, op: str = "sum") \
            -> torch.Tensor:
        """The sum (``op="sum"``) or maximum (``"max"``) of ``t`` over
        ``axis`` (a new tensor; ``t`` itself where no axis is wider than
        1)."""
        if all(self._group(a) is None for a in _axes(axis)):
            return t
        return self.all_reduce_(t.contiguous().clone(), axis, op)

    def all_reduce_(self, t: torch.Tensor, axis, op: str = "sum") \
            -> torch.Tensor:
        """:meth:`all_reduce` in place on a contiguous ``t``; returns
        it."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        for a in _axes(axis):
            group = self._group(a)
            if group is not None:
                self._count(t, "all-reduce", a, op=op)
                dist.all_reduce(t, op=_OPS[op], group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in
        mesh order (over a tuple, row-major over its axes)."""
        for a in reversed(_axes(axis)):
            group = self._group(a)
            if group is None:
                continue
            self._count(t, "all-gather", a, self.size(a))
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size(a))]
            dist.all_gather(parts, t, group=group)
            t = torch.cat(parts, dim=dim)
        return t

    def reduce_scatter(self, t: torch.Tensor, axis, dim: int) \
            -> torch.Tensor:
        """The sum of ``t`` over ``axis`` cut on ``dim`` into the axes'
        blocks, this rank's block (over a tuple, row-major over its
        axes: the inverse of :meth:`all_gather`'s order).  nccl reduces
        and scatters in one collective; gloo has none, so there it is an
        all-reduce followed by this rank's block, counted as the
        all-reduce it is."""
        for a in _axes(axis):
            if self._group(a) is None:
                continue
            n = self.size(a)
            if t.shape[dim] % n:
                raise ValueError(f"reduce_scatter: dim {dim} of size "
                                 f"{t.shape[dim]} does not split over "
                                 f"{a!r} ({n} ranks)")
            if self.backend == "nccl":
                t = self._reduce_scatter(t, a, dim)
            else:
                size = t.shape[dim] // n
                t = self.all_reduce(t, a).narrow(dim, self.index(a) * size,
                                                 size)
        return t

    def _reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) \
            -> torch.Tensor:
        """One nccl reduce-scatter over ``axis`` on ``dim``."""
        n = self.size(axis)
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        self._count(x, "reduce-scatter", axis, 1 / n, "sum")
        dist.reduce_scatter_tensor(out, x, group=self._group(axis))
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """``t`` cut on ``split_dim`` into the ``axis`` ranks' blocks, block
        j sent to rank j, and the blocks this rank receives joined on
        ``cat_dim`` in mesh order.  nccl does it in one all-to-all; gloo
        takes no CUDA all-to-all, so there it is an all-gather on
        ``cat_dim`` followed by this rank's block of ``split_dim``,
        counted as the all-gather it is."""
        n = self.size(axis)
        if self._group(axis) is None:
            return t
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of size "
                             f"{t.shape[split_dim]} does not split over "
                             f"{axis!r} ({n} ranks)")
        size = t.shape[split_dim] // n
        if self.backend != "nccl":
            return self.all_gather(t, axis, cat_dim).narrow(
                split_dim, self.index(axis) * size, size).contiguous()
        self._count(t, "all-to-all", axis)
        send = [c.contiguous() for c in t.split(size, dim=split_dim)]
        recv = [torch.empty_like(c) for c in send]
        dist.all_to_all(recv, send, group=self._group(axis))
        return torch.cat(recv, dim=cat_dim)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a barrier on each axis's
        group: a rank leaves the second only after every rank reached
        the first).  Not counted in ``stats``."""
        for a in AXES:
            group = self._group(a)
            if group is not None:
                dist.barrier(group=group)


@dataclasses.dataclass
class RecordingMesh(ServeMesh):
    """Rank 0's view of a production mesh that issues no communication:
    an all-reduce returns its operand, an all-gather the operand repeated
    to the gathered shape.  Each collective is counted in ``stats`` and
    reported to the open counters as :class:`ServeMesh` counts and
    reports it; a reduce-scatter takes the form ``backend`` gives it.
    ``pod > 1`` adds a leading ``"pod"`` axis."""

    pod: int = 1

    @property
    def axis_names(self) -> tuple:
        return ("pod",) + AXES if self.pod > 1 else AXES

    @property
    def shape(self) -> dict:
        lead = {"pod": self.pod} if self.pod > 1 else {}
        return {**lead, "data": self.data, "model": self.model}

    @property
    def coords(self) -> tuple:
        return (0,) * len(self.axis_names)

    def index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(axis)
        return 0

    def _group(self, axis: str):
        """The axis's name where it is wider than 1: no process group."""
        return axis if self.size(axis) > 1 else None

    def all_reduce_(self, t: torch.Tensor, axis, op: str = "sum") \
            -> torch.Tensor:
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        for a in _axes(axis):
            if self._group(a) is not None:
                self._count(t, "all-reduce", a, op=op)
        return t

    def all_gather(self, t: torch.Tensor, axis, dim: int) -> torch.Tensor:
        for a in reversed(_axes(axis)):
            n = self.size(a)
            if n > 1:
                self._count(t, "all-gather", a, n)
                t = torch.cat([t.contiguous()] * n, dim=dim)
        return t

    def _reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) \
            -> torch.Tensor:
        n = self.size(axis)
        self._count(t, "reduce-scatter", axis, 1 / n, "sum")
        return t.narrow(dim, 0, t.shape[dim] // n)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        n = self.size(axis)
        if n <= 1:
            return t
        if self.backend != "nccl":
            return super().all_to_all(t, axis, split_dim, cat_dim)
        self._count(t, "all-to-all", axis)
        block = t.narrow(split_dim, 0, t.shape[split_dim] // n)
        return torch.cat([block.contiguous()] * n, dim=cat_dim)

    def barrier(self) -> None:
        pass


def make_production_mesh(multi_pod: bool = False) -> RecordingMesh:
    """The production mesh as rank 0 sees it: 16 x 16 = 256 cards
    (``data x model``), or with ``multi_pod`` 2 pods x 256 with a leading
    ``"pod"`` axis (pure DP across the pods).  A :class:`RecordingMesh`
    on ``meta``, the dry run's device, for ``nccl`` (one card a rank)."""
    return RecordingMesh(data=16, model=16, pod=2 if multi_pod else 1,
                         backend="nccl", device=torch.device("meta"))


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _default_device() -> torch.device:
    """``cuda:<local rank>`` under nccl; the one card ranks share (or the
    local rank's, when there are several) under gloo."""
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized()
                               else 0))
    count = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local % count)


def make_serve_mesh(data: int = 1, model: int = 1, *, backend: str,
                    device=None, init_method: Optional[str] = None,
                    rank: Optional[int] = None,
                    world_size: Optional[int] = None,
                    ranks: Optional[list] = None) -> Optional[ServeMesh]:
    """An explicit ``data x model`` serving mesh (DESIGN.md §13).

    ``model`` ranks per replica each hold one tile of every partitioned
    CIMA image; ``data`` replicas each serve their slice of the batch.
    Every process of the job calls it (the groups are made collectively).
    The default process group is started here when it is not yet, with
    ``init_method`` (default ``env://``, what ``torchrun`` sets),
    ``rank`` and ``world_size``.  The job's size must equal
    ``data * model``; ``ranks`` (global ranks, mesh order) builds the
    mesh over a subset instead, and the processes outside it get None.
    ``device`` defaults to ``cuda:<local rank>`` (shared ``cuda:0`` on a
    one-card machine); pass ``"cpu"`` to run on the host."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    need = int(data) * int(model)
    if need < 1:
        raise ValueError(f"make_serve_mesh({data}x{model}): sizes must be "
                         f"positive")
    if not dist.is_initialized():
        if need == 1 and init_method is None and world_size in (None, 1) \
                and "WORLD_SIZE" not in os.environ:
            return ServeMesh(device=torch.device(
                "cuda" if device is None else device))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    members = list(range(dist.get_world_size())) if ranks is None \
        else [int(r) for r in ranks]
    if len(members) != need:
        have = "processes" if ranks is None else "ranks"
        raise ValueError(
            f"make_serve_mesh({data}x{model}) needs {need} {have}, have "
            f"{len(members)} (start one process per mesh position, e.g. "
            f"torchrun --nproc-per-node={need})")
    if device is None:
        device = _default_device()
    device = torch.device(device)
    if backend == "nccl" and device.type == "cuda" \
            and need > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs one card per rank: {need} ranks, "
            f"{torch.cuda.device_count()} cards (ranks that share a card "
            f"take backend='gloo')")
    me = dist.get_rank()
    groups: dict = {}
    # every process makes every group, in one order
    for d in range(data):
        g = dist.new_group([members[d * model + j] for j in range(model)],
                           backend=backend)
        if me in members and members.index(me) // model == d:
            groups["model"] = g
    for j in range(model):
        g = dist.new_group([members[d * model + j] for d in range(data)],
                           backend=backend)
        if me in members and members.index(me) % model == j:
            groups["data"] = g
    if me not in members:
        return None
    return ServeMesh(data=int(data), model=int(model),
                     rank=members.index(me), backend=backend, device=device,
                     groups=groups)


def make_host_mesh(model: int = 1, *, backend: str, device=None,
                   **init) -> ServeMesh:
    """A ``(world / model) x model`` mesh over every process of the job
    (tests and smoke runs); ``init`` as :func:`make_serve_mesh` takes
    it."""
    n = (dist.get_world_size() if dist.is_initialized() else
         int(init.get("world_size") or os.environ.get("WORLD_SIZE", 1)))
    if n % model:
        raise ValueError(f"make_host_mesh(model={model}): {n} processes "
                         f"do not split into model groups of {model}")
    return make_serve_mesh(n // model, model, backend=backend,
                           device=device, **init)
