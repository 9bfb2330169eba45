"""The audited device->host sync choke point for serving code.  Port of
``repro.serve.host``.

Every blocking device read on the serving loop serializes it, so each
one is a deliberate decision written down as ``host_sync(x,
reason="...")`` with a non-empty literal reason (the repo's linter checks
the reason is there)."""
from __future__ import annotations

import numpy as np
import torch


def host_sync(x: torch.Tensor, *, reason: str) -> np.ndarray:
    """Block on ``x`` and return it as a host ``np.ndarray``."""
    if not reason or not reason.strip():
        raise ValueError("host_sync requires a non-empty reason string "
                         "documenting why this sync is on the hot path")
    return x.detach().to("cpu").numpy()
