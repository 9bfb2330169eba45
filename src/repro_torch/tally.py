"""Where the BP/BS kernel's wrapper and the mesh report their work, and
a training step's blocks the form each took: the step counters open in
this process
(:class:`repro_torch.roofline.hlo_stats.StepCounter`, which adds itself
to :data:`ACTIVE` while it is open).

This module imports nothing, so the lowest layers report without
depending on the analysis that reads the reports.  Outside a counter a
caller tests :data:`ACTIVE` and builds no report.
"""
from __future__ import annotations

# the open counters, outermost first
ACTIVE: list = []


def report_kernel(ops: int, nbytes: int) -> None:
    """One kernel call's operations and bytes, to every open counter."""
    for c in ACTIVE:
        c.add_kernel(int(ops), int(nbytes))


def report_collective(kind: str, axis: str, operand_bytes: int,
                      result_bytes: int, op=None) -> None:
    """One collective over mesh ``axis``, to every open counter; ``op``
    is a reduction's (``"sum"`` or ``"max"``), None for a gather."""
    for c in ACTIVE:
        c.add_collective(kind, axis, int(operand_bytes), int(result_bytes),
                         op)


def report_form(block: str, form) -> None:
    """The form ``block`` (a projection's policy tag, ``"attn"`` or
    ``"embed"``) ran in, reported where the form is chosen, to every open
    counter."""
    for c in ACTIVE:
        c.add_form(block, form)
