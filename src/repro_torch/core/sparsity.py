"""Sparsity / AND-logic Controller (paper Fig. 6b).  Port of
``repro.core.sparsity``: the per-element mask bit ``M_n`` that gates
broadcasting of zero-valued inputs over the CIMA, the controller's
tallies, and the all-zero (bank, plane) count the cost model charges."""
from __future__ import annotations

import torch


def element_mask(x_q: torch.Tensor) -> torch.Tensor:
    """Mask bit ``M_n`` per input element: 1 = broadcast, 0 = zero-valued."""
    return torch.where(x_q != 0, 1.0, 0.0)


def unmasked_count(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Number of rows actually broadcast (per bank): ``N_active - tally``."""
    return torch.sum(mask, dim=axis)


def masked_tally(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The controller's tally of masked rows (the XNOR reset-cap offset)."""
    return mask.shape[axis] - unmasked_count(mask, axis)


def sparsity_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of zero-valued elements (drives the energy model).  The
    mean is the sum times the float32 reciprocal of the count, the
    reference's rounding (``torch.mean`` divides)."""
    return 1.0 - torch.sum(mask) * (1.0 / mask.numel())


def count_zero_planes(x_q: torch.Tensor, cfg) -> tuple[int, int]:
    """``(skipped, total)`` all-zero (bank, input-plane) evaluations: a
    (bank, kx) pair whose masked input bit plane is all zero across the
    whole batch broadcasts nothing, so the chip skips that serial step
    (what ``MvmRecord.planes_skipped`` charges).  ``cfg`` is a
    :class:`~repro_torch.core.bpbs.BpbsConfig`.  Reads one count per bank
    back to the host."""
    from .bpbs import input_planes

    planes, _ = input_planes(x_q, cfg)            # [..., N, BX]
    n = x_q.shape[-1]
    planes = planes.reshape(-1, n, cfg.bx)        # batch axes flattened
    n_banks = -(-n // cfg.bank_n)
    skipped = 0
    for b in range(n_banks):
        s, e = b * cfg.bank_n, min((b + 1) * cfg.bank_n, n)
        nz = (planes[:, s:e, :] != 0).any(0).any(0)          # [BX]
        skipped += int(torch.sum(~nz))
    return skipped, n_banks * cfg.bx
