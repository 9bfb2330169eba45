"""Bit-parallel / bit-serial (BP/BS) multi-bit MVM (paper Fig. 4).  Port
of ``repro.core.bpbs``.

The B_A bits of each matrix element map to parallel CIMA columns; the B_X
bits of each input element are applied serially.  Every (bit-column,
bit-step) pair is one column evaluation whose popcount the per-column ADC
digitizes; the results are barrel-shifted by their joint significance and
accumulated.  The fast path uses the GEMM identity ``d = 2p - n_unmasked``
(XNOR) / ``d = p`` (AND), so each bank is one exact float32 matmul over
all plane pairs followed by :func:`gemm_adc_epilogue`.  The N dimension
is split into banks of ``bank_n`` rows (2304 on the chip); each bank is a
separate charge share and ADC conversion.
"""
from __future__ import annotations

import dataclasses

import torch

from .adc import adc_quantize_sum
from .cima import signed_dot_from_popcount
from .quant import Coding, int_to_planes, plane_weights
from .sparsity import element_mask


@dataclasses.dataclass(frozen=True)
class BpbsConfig:
    """Static configuration of one CIMU MVM."""

    ba: int = 4                    # matrix-element bits (parallel columns)
    bx: int = 4                    # input-element bits (serial steps)
    coding: Coding = Coding.XNOR
    bank_n: int = 2304             # rows per charge-share/ADC boundary
    adc_bits: int = 8
    adc_sigma_lsb: float = 0.0     # analog non-ideality, LSB units
    adaptive_range: bool = False   # ADC full scale tracks unmasked rows
    ideal_adc: bool = False        # bypass the ADC (bit-true integer compute)
    # gate the GEMM of a bank whose input planes are all zero; the
    # epilogue still runs on the zeros, so the output is bit-identical
    skip_zero_planes: bool = True

    def __post_init__(self):
        object.__setattr__(self, "coding", Coding(self.coding))

    @property
    def wa(self):
        return plane_weights(self.ba, self.coding)

    @property
    def wx(self):
        return plane_weights(self.bx, self.coding)


def weight_planes(w_q: torch.Tensor, cfg: BpbsConfig) -> torch.Tensor:
    """Matrix-element bit planes, shape [N, M, B_A]."""
    return int_to_planes(w_q, cfg.ba, cfg.coding)


def input_planes(x_q: torch.Tensor, cfg: BpbsConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Input bit planes [..., N, B_X] with the controller mask folded in
    (XNOR planes of zero-valued elements are zeroed: capacitor reset)."""
    planes = int_to_planes(x_q, cfg.bx, cfg.coding)
    mask = element_mask(x_q)
    if cfg.coding == Coding.XNOR:
        planes = planes * mask[..., None]
    return planes, mask


def adc_full_scale(nu, bank_rows, cfg: BpbsConfig):
    """The ADC full scale of one bank conversion: the unmasked-row count
    ``nu`` under ``adaptive_range``, else the bank's static row count."""
    return nu if cfg.adaptive_range else bank_rows


def gemm_adc_epilogue(d: torch.Tensor, nu, bank_rows,
                      cfg: BpbsConfig) -> torch.Tensor:
    """Popcount recovery, ADC transfer and signed-dot recovery of one
    plane-pair evaluation: ``p = (d + nu) / 2`` (XNOR) or ``p = d`` (AND),
    quantized over :func:`adc_full_scale`, mapped back to the signed dot.
    No noise is drawn here (``adc_sigma_lsb > 0`` warns)."""
    p = (d + nu) * 0.5 if cfg.coding == Coding.XNOR else d
    if cfg.ideal_adc:
        p_hat = p
    else:
        fs = adc_full_scale(nu, bank_rows, cfg)
        p_hat = adc_quantize_sum(p, fs, cfg.adc_bits, cfg.adc_sigma_lsb)
    return signed_dot_from_popcount(p_hat, nu, cfg.coding)


def bpbs_matmul_planes(x_q: torch.Tensor, ws: torch.Tensor,
                       cfg: BpbsConfig) -> torch.Tensor:
    """BP/BS MVM on integer-grid inputs ``x_q`` [..., N] and pre-decomposed
    weight planes ``ws`` [N, B_A, M] (any exact dtype).  Returns [..., M]
    float32, integer-valued at ``adc_sigma_lsb == 0``."""
    xs, mask = input_planes(x_q, cfg)            # [..., N, BX], [..., N]
    n = x_q.shape[-1]
    m = ws.shape[2]
    lead = x_q.shape[:-1]
    t = 1
    for dim in lead:
        t *= dim
    wxv = torch.as_tensor(cfg.wx, dtype=torch.float32, device=x_q.device)
    wav = torch.as_tensor(cfg.wa, dtype=torch.float32, device=x_q.device)
    y = torch.zeros(lead + (m,), dtype=torch.float32, device=x_q.device)
    n_banks = -(-n // cfg.bank_n)
    for b in range(n_banks):
        s, e = b * cfg.bank_n, min((b + 1) * cfg.bank_n, n)
        nb = e - s
        nu = mask[..., s:e].sum(-1)                      # [...] unmasked rows
        # one exact f32 GEMM per bank over all (kx, ka) plane pairs, in
        # the chip's column-parallel layout [T*BX, nb] @ [nb, BA*M]
        x2 = xs[..., s:e, :].transpose(-1, -2).reshape(t * cfg.bx, nb)
        w2 = ws[s:e].to(torch.float32).reshape(nb, cfg.ba * m)
        if cfg.skip_zero_planes and not bool(x2.any()):
            d2 = x2.new_zeros((t * cfg.bx, cfg.ba * m))
        else:
            d2 = x2 @ w2
        d = d2.reshape(lead + (cfg.bx, cfg.ba, m))
        d_hat = gemm_adc_epilogue(d, nu[..., None, None, None], float(nb),
                                  cfg)
        y = y + torch.einsum("...xam,x,a->...m", d_hat, wxv, wav)
    return y


def bpbs_matmul_int(x_q: torch.Tensor, w_q: torch.Tensor,
                    cfg: BpbsConfig) -> torch.Tensor:
    """On-the-fly wrapper: decompose ``w_q`` [N, M], then
    :func:`bpbs_matmul_planes`."""
    ws = weight_planes(w_q, cfg).permute(0, 2, 1)
    return bpbs_matmul_planes(x_q, ws, cfg)
