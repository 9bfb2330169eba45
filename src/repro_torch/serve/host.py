"""The audited device->host sync choke point for serving code.  Port of
``repro.serve.host``.

Every blocking device read on the serving loop serializes it, so each
one is a deliberate decision written down as ``host_sync(x,
reason="...")`` with a non-empty literal reason (the repo's linter checks
the reason is there).

An active :func:`repro_torch.analysis.sanitize.sanitize` scope checks
every synced array finite, on the host array it already returns: the
tokens and flags read here are the decode path's outputs."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.sanitize import active as _san_active


def host_sync(x: torch.Tensor, *, reason: str) -> np.ndarray:
    """Block on ``x`` and return it as a host ``np.ndarray``."""
    if not reason or not reason.strip():
        raise ValueError("host_sync requires a non-empty reason string "
                         "documenting why this sync is on the hot path")
    out = x.detach().to("cpu").numpy()
    san = _san_active()
    if san is not None:
        san.check_finite(out, f"host_sync({reason!r})")
    return out
