"""Sparsity / AND-logic Controller (paper Fig. 6b).  Port of
``repro.core.sparsity``: the per-element mask bit ``M_n`` that gates
broadcasting of zero-valued inputs over the CIMA."""
from __future__ import annotations

import torch


def element_mask(x_q: torch.Tensor) -> torch.Tensor:
    """Mask bit ``M_n`` per input element: 1 = broadcast, 0 = zero-valued."""
    return torch.where(x_q != 0, 1.0, 0.0)
