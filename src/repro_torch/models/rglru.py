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

On a serving mesh (:func:`~repro_torch.models.mixer_split.lru_split`)
each rank runs the conv, the recurrence and the state of its slice of
the LRU width: ``in_x`` and ``in_gate`` (with its fused GELU) as local
column tiles where the program's tiles allow it (else their outputs are
sliced), the conv on the slice, the conv's output gathered over
``"model"`` for the gates (which contract the whole width), each gate's
columns of the slice, the scan, and ``out`` on ``hs * gate`` as a local
row tile (else ``y`` is gathered and ``out`` runs as off the mesh).

A tensor-parallel training step (``distributed.autoshard.tp_mesh``)
runs the same split under autograd, in the serving split's order:
``in_x`` and ``in_gate`` are the rank's column tiles of their
replicated inputs, the conv weight and the gates' ``w_rg``/``w_ig`` the
rank's slices under their specs, the conv output gathered with
``partial=True`` (each rank's gates use all of it), ``lambda`` and the
conv bias whole through ``layers.shared_leaf`` (gradients summed over
``"model"``), and ``out`` the rank's rows through ``layers.row_linear``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import tally
from repro_torch.accel import Postreduce
from repro_torch.core.datapath import ACTIVATIONS
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import tp_mesh, train_mesh

from .layers import init_linear, linear, replicated, row_linear, shared_leaf
from .mixer_split import lru_split, serving_mesh
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
    equals the state after the unpadded prompt.

    On a serving mesh the rank runs its width slice (module docstring)
    and ``state`` holds it (:func:`state_width`; a state of another
    split raises)."""
    b = x.shape[0]
    s = x.shape[1]
    sp = cfg.policy.resolver("rec")
    split = lru_split(cfg)
    width = state_width(cfg)
    if state is not None and int(state.h.shape[-1]) != width:
        raise ValueError(
            f"an LRU state of width {int(state.h.shape[-1])} for a block of "
            f"{width} on this rank: make the state in the scope that "
            f"serves it")
    tp = tp_mesh() is not None
    if tally.ACTIVE and train_mesh() is not None:
        tally.report_form("rec", f"tp/{split.mode}" if tp else "whole")
    if tp:
        if state is not None:
            raise ValueError("a tensor-parallel training step runs no LRU "
                             "state")
        # the rank's slices of the weights; the 1-D leaves whole
        params = dict(params, **{k: shared_leaf(params[k], cfg.lru_width)
                                 for k in ("conv_b", "lambda")})
    col = "col" if split is not None and split.local else None

    def mine(t):     # a training rank holds its slices already
        return t if tp else _share(t, split)

    def proj(name, post=None):
        tag = f"rec.{name}"
        if tp:
            return linear(params[name], replicated(x, sp(tag)), sp(tag),
                          dtype, post=post, tile="col")
        return linear(params[name], x, sp(tag), dtype, post=post, local=col)

    # the gate GELU rides the in_gate projection's fused datapath epilogue
    if getattr(cfg, "fuse_datapath", True):
        gate = proj("in_gate", Postreduce(act="gelu"))
    else:
        gate = ACTIVATIONS["gelu"](proj("in_gate"))
    xr = proj("in_x")
    if col is None:
        gate, xr = _share(gate, split), _share(xr, split)
    if pad_mask is not None:
        xr = xr * pad_mask[..., None].to(xr.dtype)
    conv_state = state.conv if state is not None else None
    xr, new_conv = _causal_conv(xr, mine(params["conv_w"]).to(dtype),
                                _share(params["conv_b"], split).to(dtype),
                                conv_state)

    xf = xr.to(torch.float32)
    # the gates contract the whole width: the conv's output gathered
    if split is None:
        xw = xr
    elif tp:
        xw = autoshard.gather(xr, "model", xr.ndim - 1, partial=True)
    else:
        xw = serving_mesh().all_gather(xr, "model", -1)
    r = torch.sigmoid(linear({k: mine(v) for k, v in params["w_rg"].items()},
                             xw, None, torch.float32))
    i = torch.sigmoid(linear({k: mine(v) for k, v in params["w_ig"].items()},
                             xw, None, torch.float32))
    log_a = -C_EXP * r * _softplus(-_share(params["lambda"], split))
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
    if tp:
        return row_linear(params["out"], y, sp("rec.out"), dtype), \
            LRUState(new_conv, h)
    if split is not None and col is None:
        y = serving_mesh().all_gather(y, "model", -1)
    out = linear(params["out"], y, sp("rec.out"), dtype,
                 local="row" if col is not None else None)
    return out, LRUState(new_conv, h)


def _share(t: torch.Tensor, split) -> torch.Tensor:
    """The rank's width slice of ``t``'s last dim (``t`` off a split)."""
    return t if split is None else t[..., split.lo:split.hi]


def state_width(cfg) -> int:
    """The LRU width a rank's state holds: its slice on a serving mesh
    (:func:`~repro_torch.models.mixer_split.lru_split`), else all."""
    split = lru_split(cfg)
    return cfg.lru_width if split is None else split.size


def init_lru_state(cfg, batch: int, dtype, device,
                   lead: tuple = ()) -> LRUState:
    """A zero state; on a serving mesh the rank's width slice
    (:func:`state_width`)."""
    w = state_width(cfg)
    return LRUState(
        conv=torch.zeros(lead + (batch, cfg.conv1d_size - 1, w),
                         dtype=dtype, device=device),
        h=torch.zeros(lead + (batch, w), dtype=torch.float32,
                      device=device),
    )
