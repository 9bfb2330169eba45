"""Charge-domain Compute-In-Memory Array (CIMA) column model (paper Figs.
2, 3).  Port of ``repro.core.cima``.

This is the physics-level model of one CIMA evaluation of one pair of bit
planes, bit cell by bit cell:

1. Reset: the column's local capacitors are shorted and discharged.
2. Local compute: every cell stores ``o = XNOR(a, x)`` (or ``AND(a, x)``)
   as charge on its MOM capacitor.  Cells whose input the Sparsity/AND-
   logic Controller masks never fire: their capacitor stays reset.
3. Accumulate: all capacitors are shorted; the column voltage is
   ``p / n_caps * Vdd`` with ``p`` the column popcount.

The fast path of :mod:`repro_torch.core.bpbs` computes the same ``p``
through one GEMM identity and agrees with this model bit for bit.
"""
from __future__ import annotations

import torch

from .quant import Coding


def cell_outputs(a_bits: torch.Tensor, x_bits: torch.Tensor,
                 mask: torch.Tensor, coding: Coding) -> torch.Tensor:
    """Binary cell outputs ``o`` in {0,1}, the charge on each local cap:
    ``a_bits`` [N, M] the stored plane, ``x_bits`` [..., N] the broadcast
    plane (both {0,1} under AND, {-1,+1} under XNOR), ``mask`` [..., N]
    (1 = broadcast, 0 = gated).  Returns [..., N, M]."""
    x = x_bits[..., :, None]
    m = mask[..., :, None]
    if Coding(coding) == Coding.XNOR:
        o = torch.where(a_bits * x > 0, 1.0, 0.0)   # XNOR of +-1 alphabets
    else:
        o = a_bits * x                               # AND of {0,1} alphabets
    return o * m                                     # masked cells stay reset


def column_popcount(a_bits: torch.Tensor, x_bits: torch.Tensor,
                    mask: torch.Tensor, coding: Coding) -> torch.Tensor:
    """Charge-share accumulation: per-column popcount ``p`` in [0, N]."""
    return torch.sum(cell_outputs(a_bits, x_bits, mask, coding), dim=-2)


def signed_dot_from_popcount(p: torch.Tensor, n_unmasked, coding: Coding
                             ) -> torch.Tensor:
    """Digital recovery of the plane dot product from ``p``.  XNOR: each
    unmasked cell contributes +-1, so ``dot = 2p - n_unmasked`` (the
    controller's tally of masked rows gives the offset, paper Fig. 6b).
    AND: cells contribute {0,1}, so ``dot = p``."""
    if Coding(coding) == Coding.XNOR:
        return 2.0 * p - n_unmasked
    return p
