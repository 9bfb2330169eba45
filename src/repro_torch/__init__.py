"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

The same module layout as the JAX package, one port module per reference
module: :mod:`.configs`, :mod:`.core`, :mod:`.accel`, :mod:`.kernels`,
:mod:`.models`, :mod:`.serve`, plus :mod:`.convert` (parameters from the
JAX package).  It imports ``torch`` and nothing of ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
