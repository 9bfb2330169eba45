"""Plain-torch oracles for the port's kernels (``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bpbs import BpbsConfig, bpbs_matmul_int


def cima_mvm_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                 cfg: BpbsConfig) -> torch.Tensor:
    """Oracle for kernels.cima_mvm: the core BP/BS pipeline."""
    return bpbs_matmul_int(x_q, w_q, cfg)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Oracle for kernels.flash_attention: dense masked softmax attention.
    ``q`` [B, H, Sq, D], ``k``/``v`` [B, HKV, Sk, D].  The last query is
    aligned to the last key (query ``r`` sits at ``r + Sk - Sq``), so it
    agrees with the kernel's top-left positions only when ``Sq == Sk``;
    a row that sees no key is 0."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qi >= kj)
    if window is not None:
        mask = mask & (kj > qi - window)
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
