"""The roofline of a step: :mod:`.hlo_stats` counts what a step computes,
moves and sends (dispatched ops, the BP/BS kernel's reports, the mesh's
collectives), :mod:`.analysis` prices the dry run's counts against the
H100 SXM's data-sheet peaks."""
