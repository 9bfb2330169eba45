"""Parameters from the JAX package into the port.

:func:`params_from_jax` maps the reference's ``init_params`` tree,
converted leaf by leaf to numpy (``jax.tree.map(np.asarray, params)``),
onto the port's tree key for key: nested dicts stay dicts, lists stay
lists, the stacked ``"scanned"`` layer leaves keep their leading layer
axis, and so do whisper's ``cross`` leaves (stacked over the decoder
layers by the reference's ``jax.vmap``) beside its ``encoder`` tree and
``dec_pos``.  Compiled images are not converted: the port's
:func:`~repro_torch.accel.program.build_program` rebuilds them from the
weights, so strip a program before converting.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree from a numpy copy of a JAX param tree."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    raise TypeError(
        f"params_from_jax: unexpected leaf {type(tree).__name__}; pass a "
        "numpy tree of a program-free param tree")
