"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).
Port of ``repro.models.rglru``.

The linear recurrence ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)``
runs as a log-depth doubling scan over the sequence for train/prefill
(the reference's ``lax.associative_scan``; both reassociate the products,
so the two agree to float tolerance, not bitwise) and as a single step for
decode.

The recurrence is diagonal and data-dependent (not a stationary MVM), so
it stays digital; the block's dense projections ``rec.in_x``,
``rec.in_gate`` and ``rec.out`` go through ``accel.matmul``, while the
gates ``w_rg``/``w_ig`` dispatch with ``spec=None`` in float32, as in the
reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.accel import Postreduce
from repro_torch.core.datapath import ACTIVATIONS

from .layers import init_linear, linear
from .ssm import _causal_conv, _softplus

C_EXP = 8.0   # the paper's fixed exponent on the recurrent gate


class LRUState(NamedTuple):
    conv: torch.Tensor    # [B, k-1, W] causal-conv trailing state
    h: torch.Tensor       # [B, W] recurrent hidden state


def init_rglru(gen, cfg, device, lead: tuple = ()) -> dict:
    """The block's params; ``lead`` prepends stacked-layer axes."""
    d, w = cfg.d_model, cfg.lru_width
    p = {"in_x": init_linear(gen, d, w, device, lead),      # recurrent branch
         "in_gate": init_linear(gen, d, w, device, lead),   # gate branch
         "conv_w": 0.1 * torch.randn(lead + (cfg.conv1d_size, w),
                                     generator=gen, device=device),
         "conv_b": torch.zeros(lead + (w,), device=device),
         "w_rg": init_linear(gen, w, w, device, lead),      # recurrence gate
         "w_ig": init_linear(gen, w, w, device, lead)}      # input gate
    # Lambda so that a = sigmoid(L)^c lies in ~[0.9, 0.999]
    u = torch.empty(lead + (w,), device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    r = u ** (1.0 / C_EXP)
    p["lambda"] = torch.log(r / (1.0 - r))
    p["out"] = init_linear(gen, w, d, device, lead)
    return p


def _lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = 0): a doubling
    (Hillis-Steele) scan over pairs, ceil(log2 S) rounds of
    (a2, b2) o (a1, b1) = (a2*a1, a2*b1 + b2)."""
    s = a.shape[1]
    for r in range(math.ceil(math.log2(s)) if s > 1 else 0):
        k = 1 << r
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
    return b


def rglru_forward(params, x, cfg, state: Optional[LRUState] = None,
                  decode: bool = False, dtype=torch.bfloat16, pad_mask=None):
    """x: [B, S, d] -> (y, new_state).

    ``pad_mask`` ([B, S] bool, True = real token; left-padded prefill):
    padded steps become identity transitions (a = 1, input term 0) and
    their conv inputs are zeroed, so the state after a left-padded prompt
    equals the state after the unpadded prompt."""
    b = x.shape[0]
    s = x.shape[1]
    sp = cfg.policy.resolver("rec")
    # the gate GELU rides the in_gate projection's fused datapath epilogue
    if getattr(cfg, "fuse_datapath", True):
        gate = linear(params["in_gate"], x, sp("rec.in_gate"), dtype,
                      post=Postreduce(act="gelu"))
    else:
        gate = ACTIVATIONS["gelu"](linear(params["in_gate"], x,
                                          sp("rec.in_gate"), dtype))
    xr = linear(params["in_x"], x, sp("rec.in_x"), dtype)
    if pad_mask is not None:
        xr = xr * pad_mask[..., None].to(xr.dtype)
    conv_state = state.conv if state is not None else None
    xr, new_conv = _causal_conv(xr, params["conv_w"].to(dtype),
                                params["conv_b"].to(dtype), conv_state)

    xf = xr.to(torch.float32)
    r = torch.sigmoid(linear(params["w_rg"], xr, None, torch.float32))
    i = torch.sigmoid(linear(params["w_ig"], xr, None, torch.float32))
    log_a = -C_EXP * r * _softplus(-params["lambda"])   # log sigmoid(L)^cr
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    if pad_mask is not None:
        m = pad_mask[..., None]
        a = torch.where(m, a, 1.0)
        gated = torch.where(m, gated, 0.0)

    if decode:
        assert s == 1 and state is not None
        h = a[:, 0] * state.h + gated[:, 0]
        hs = h[:, None, :]
    else:
        h0 = (state.h if state is not None
              else torch.zeros((b, xf.shape[-1]), device=x.device))
        # fold the carried-in state into the first step's additive term
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                           gated[:, 1:]], dim=1)
        hs = _lru_scan(a, gated)
        h = hs[:, -1]

    y = hs.to(dtype) * gate
    out = linear(params["out"], y, sp("rec.out"), dtype)
    return out, LRUState(new_conv, h)


def init_lru_state(cfg, batch: int, dtype, device,
                   lead: tuple = ()) -> LRUState:
    return LRUState(
        conv=torch.zeros(lead + (batch, cfg.conv1d_size - 1, cfg.lru_width),
                         dtype=dtype, device=device),
        h=torch.zeros(lead + (batch, cfg.lru_width), dtype=torch.float32,
                      device=device),
    )
