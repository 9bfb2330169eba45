"""Counted work of a step: dots, bytes, collectives and kernel operations.
Port of ``repro.roofline.hlo_stats``.

The reference parses the compiled, SPMD-partitioned HLO of a step and
multiplies each while-loop body by its trip count.  The port runs
eagerly, so it counts the ops torch dispatches instead of parsing HLO:
:class:`StepCounter` is a ``TorchDispatchMode`` that sees every aten op a
scope runs, on ``meta``, CPU and CUDA tensors alike, autograd's backward
and remat's replays included (they dispatch like any other op).  Per
rank, as the reference's figures are per device:

* ``dot_flops``: torch's own flop formulas (``torch.utils.flop_counter``)
  for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolution, forward and
  backward; ``dot_flops_by_dtype`` splits them by the operands' dtype;
* ``dot_bytes``: the operands and output of each dot (an ``addmm``'s bias
  and a convolution's bias not counted, as the reference's HLO ``dot``
  has none);
* ``result_bytes``: the outputs of every op, views excluded.  Not
  comparable with the reference's figure: XLA's counts every instruction
  inside its fusions, torch's each op's output once;
* ``collectives`` / ``collective_bytes``: what the mesh reported
  (:func:`repro_torch.tally.report_collective`; a real
  :class:`~repro_torch.launch.mesh.ServeMesh` and the recording one
  alike), by the reference's
  :data:`COLLECTIVES` names, each op's bytes the larger of its operand
  and its result as the reference takes them; ``collectives_by_axis``
  the same by mesh axis, and ``collectives_by_op`` by ``(kind, axis,
  op)`` with a reduction's op (``"sum"``, ``"max"``; None for a gather),
  an attribute outside :meth:`StepCounter.stats`;
* ``n_ops``: the ops dispatched that write a tensor (views, aliases and
  host reads such as ``.item()`` not counted), in place of
  ``n_computations``;
* ``kernel_ops`` / ``kernel_bytes`` / ``kernel_calls``: what the BP/BS
  kernel's wrapper reported (:func:`repro_torch.tally.report_kernel`):
  its int8 plane
  operations and the bytes it moves, on a launch or a ``meta`` call.
  The kernel's work is not in ``dot_flops``: on the card it is one
  launch, not torch GEMMs;
* ``peak_bytes``: the most bytes of storage allocated inside the scope
  and alive at once (a storage counts from the op that made it until it
  is freed), the ``temp_size_in_bytes`` of a dry run.

:meth:`StepCounter.stats` returns these keys as a dict, as the
reference's ``analyze`` does.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import tally

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# dot op -> positions of its dot operands among the op's arguments
# (None: every tensor argument)
_DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
         _aten.baddbmm: (1, 2), _aten.convolution: (0, 1),
         _aten._convolution: (0, 1), _aten.convolution_backward: None}

_CIA = torch._C.DispatchKey.CompositeImplicitAutograd
_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Has ``func`` a C++ CompositeImplicitAutograd kernel (one made of
    other aten ops)?"""
    hit = _COMPOSITE.get(func)
    if hit is None:
        hit = _COMPOSITE[func] = func._overloadpacket not in _DOTS and \
            torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _CIA)
    return hit


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside ``with StepCounter() as c:``
    do; :meth:`stats` reads the counts."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.dot_flops_by_dtype: dict = defaultdict(int)
        self.dot_bytes = 0
        self.result_bytes = 0
        self.n_ops = 0
        self.kernel_ops = 0
        self.kernel_bytes = 0
        self.kernel_calls = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.collectives_by_axis: dict = {}
        self.collectives_by_op: dict = {}
        self.forms: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracked: set = set()
        self._depth = 0

    def __enter__(self):
        # re-entered around a composite op's decomposition: report once
        if self._depth == 0:
            tally.ACTIVE.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            tally.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, ops: int, nbytes: int) -> None:
        """One kernel call (:func:`repro_torch.tally.report_kernel`)."""
        self.kernel_ops += ops
        self.kernel_bytes += nbytes
        self.kernel_calls += 1

    def add_collective(self, kind: str, axis: str, operand_bytes: int,
                       result_bytes: int, op=None) -> None:
        """One collective (:func:`repro_torch.tally.report_collective`),
        its bytes the larger of its operand and its result."""
        nbytes = max(operand_bytes, result_bytes)
        for table, key in ((self.collectives, kind),
                           (self.collectives_by_axis, axis),
                           (self.collectives_by_op, (kind, axis, op))):
            entry = table.setdefault(key, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += nbytes

    def add_form(self, block: str, form) -> None:
        """The form a block ran in (:func:`repro_torch.tally.
        report_form`)."""
        self.forms[block] = form

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live_bytes -= nbytes

    def _track(self, outs, args) -> None:
        """Start counting the storages ``outs`` allocated: those that are
        neither an argument's nor already counted (views, in-place ops)."""
        seen = None
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            if seen is None:
                seen = {id(a.untyped_storage()) for a in args
                        if isinstance(a, torch.Tensor)}
            if key in seen:
                continue
            nb = st.nbytes()
            self._tracked.add(key)
            weakref.finalize(st, self._free, key, nb)
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite op reaches the mode whole under inference_mode
            # (``einsum``, ``matmul``): count the ops its C++ kernel is
            # made of, as autograd's dispatch would hand them over
            with self:
                return func._op_dk(_CIA, *args, **kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in _DOTS:
            flops = flop_counter.flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
            pos = _DOTS[packet]
            ins = [a for a in args if isinstance(a, torch.Tensor)] \
                if pos is None else [args[i] for i in pos]
            self.dot_flops += flops
            self.dot_flops_by_dtype[str(ins[0].dtype).split(".")[-1]] += flops
            self.dot_bytes += sum(_nbytes(t) for t in ins + outs)
        if outs and not func.is_view:
            self.n_ops += 1
            self.result_bytes += sum(_nbytes(t) for t in outs)
        self._track(outs, tree_leaves((args, kwargs)))
        return out

    def stats(self) -> dict:
        """The counts under the reference's ``analyze`` keys, and the
        port's own."""
        return {
            "dot_flops": int(self.dot_flops),
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
            "dot_bytes": int(self.dot_bytes),
            "result_bytes": int(self.result_bytes),
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "collectives_by_axis": {k: dict(v) for k, v in
                                    self.collectives_by_axis.items()},
            "collective_bytes": sum(v["bytes"]
                                    for v in self.collectives.values()),
            "n_ops": self.n_ops,
            "kernel_ops": self.kernel_ops,
            "kernel_bytes": self.kernel_bytes,
            "kernel_calls": self.kernel_calls,
            "peak_bytes": self.peak_bytes,
        }

