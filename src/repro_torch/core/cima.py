"""Charge-domain CIMA column model (paper Figs. 2, 3).  Port of
``repro.core.cima``: the digital recovery of a plane dot product from the
column popcount."""
from __future__ import annotations

import torch

from .quant import Coding


def signed_dot_from_popcount(p: torch.Tensor, n_unmasked, coding: Coding
                             ) -> torch.Tensor:
    """XNOR: each unmasked cell contributes +-1, so ``dot = 2p - n_unmasked``.
    AND: cells contribute {0,1}, so ``dot = p``."""
    if Coding(coding) == Coding.XNOR:
        return 2.0 * p - n_unmasked
    return p
