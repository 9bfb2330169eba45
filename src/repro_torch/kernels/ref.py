"""Plain-torch oracles for the port's kernels (``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.bpbs import BpbsConfig, bpbs_matmul_int


def cima_mvm_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                 cfg: BpbsConfig) -> torch.Tensor:
    """Oracle for kernels.cima_mvm: the core BP/BS pipeline."""
    return bpbs_matmul_int(x_q, w_q, cfg)
