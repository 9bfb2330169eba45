"""Mamba2 SSD mixer (state-space duality, arXiv:2405.21060).  Port of
``repro.models.ssm``.

Chunked SSD for train/prefill: quadratic attention-like compute within
chunks, a linear recurrence across chunks (a loop over the chunk states,
the reference's ``lax.scan``).  Single-step recurrence for decode with a
constant-size (conv, ssm) state.

The in/out projections are static-weight MVMs and run through
``accel.matmul`` (policy paths ``ssm.in_proj``/``ssm.out_proj``); the SSD
scan multiplies two activations, so it stays digital: plain torch ops,
as plain XLA ops in the reference.

On a serving mesh (:func:`~repro_torch.models.mixer_split.ssd_split`)
each rank runs the conv, the scan and the state of its heads
(``"heads"``) or of its slice of every head's dims (``"p"``):
``in_proj`` stays a gathered column tile (its packed ``[z | xBC | dt]``
columns do not fall on head boundaries) and the rank takes its channels
of it.  In ``"heads"``, where the program's ``out_proj`` is a row tile,
the gated RMSNorm and ``out_proj`` run on the rank's channels too: each
head's sum of squares is gathered over ``"model"`` (so the mean is the
unsharded one, bit for bit) and ``out_proj`` takes the rank's channels
as a local row tile.  Otherwise ``y`` is gathered over ``"model"``
before the norm (in ``"p"`` the rank's channels are strided), and the
norm and ``out_proj`` run as off the mesh.

A tensor-parallel training step (``distributed.autoshard.tp_mesh``)
splits the mixer by the same rule on the step's mesh, under autograd.
``in_proj`` is the rank's column tile of its replicated input, gathered
(``autoshard.gather(..., partial=True)``), or used whole where the axis
does not divide its columns (its output's gradient summed over
``"model"``: each rank uses only its channels of it).  The conv weight
and the 1-D leaves come whole through ``layers.shared_leaf`` (gradients
summed over ``"model"``) and the rank takes its share of each.  In
``"heads"`` the norm and ``out_proj`` run on the rank's channels (the
per-head sums gathered with ``partial=True``, ``out_proj`` its rows
through ``layers.row_linear``).  In ``"p"`` ``y`` is gathered
(``partial=True``), the norm's statistic taken over the whole row as
unsharded, and only the rank's contiguous block of the normed channels
goes on to ``out_proj``'s row tile: that block is its rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tally
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import sum_grad, tp_mesh, train_mesh

from .layers import (init_linear, linear, replicated, row_linear,
                     shared_leaf)
from .mixer_split import MixerSplit, serving_mesh, ssd_split


class SSMState(NamedTuple):
    conv: torch.Tensor      # [B, k-1, conv_dim] trailing inputs of the conv
    ssm: torch.Tensor       # [B, H, P, N] recurrent state


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state    # x, B, C go through the conv
    return d_inner, n_heads, conv_dim


def init_ssm(gen, cfg, device, lead: tuple = ()) -> dict:
    """The mixer's params; ``lead`` prepends stacked-layer axes."""
    d = cfg.d_model
    d_inner, n_heads, conv_dim = dims(cfg)
    in_proj = init_linear(gen, d, 2 * d_inner + 2 * cfg.ssm_state + n_heads,
                          device, lead)
    conv_w = 0.1 * torch.randn(lead + (cfg.conv1d_size, conv_dim),
                               generator=gen, device=device)
    u = torch.empty(lead + (n_heads,), device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                   device=device))
    return {
        # in_proj -> [z, xBC, dt]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (conv_dim,), device=device),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "D": torch.ones(lead + (n_heads,), device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm_scale": torch.ones(lead + (d_inner,), device=device),
        "out_proj": init_linear(gen, d_inner, d, device, lead),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: [B, S, C]; w: [k, C].  Returns (y, new
    trailing state [B, k-1, C]).  The k shifted products are summed left
    to right, as the reference sums them."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else state
    return y + b, new_state


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Cumulative decay matrix: L[i,j] = sum_{j<l<=i} dA_l (lower-tri),
    -inf above the diagonal."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=dA.device)
    return torch.where(i[:, None] >= i[None, :], L, -torch.inf)


def ssd_chunked(x, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked SSD.  x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B_,C_: [B,S,N].
    Returns (y [B,S,H,P], final_state [B,H,P,N]).

    ``init_state`` ([B,H,P,N], default zeros) seeds the inter-chunk
    recurrence, so a resumed prefill continues from a carried state.
    The reference's three-operand einsums contract here pairwise."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B_.reshape(b, nc, chunk, n)
    Cc = C_.reshape(b, nc, chunk, n)

    dA = dtc * (-torch.exp(A))[None, None, None, :]       # [B,nc,Q,H] (<0)
    dA = dA.permute(0, 1, 3, 2)                            # [B,nc,H,Q]
    L = torch.exp(_segsum(dA))                             # [B,nc,H,Q,Q]

    xdt = xc * dtc[..., None]                              # dt-weighted input
    # intra-chunk (diagonal blocks): y = (C B^T o L) (dt x)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)           # [B,nc,Q,Q]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * L, xdt)
    # states at chunk ends: S_c = sum_k exp(dA_cum_end - dA_cum_k) B_k x_k
    dA_cum = torch.cumsum(dA, dim=-1)                      # [B,nc,H,Q]
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)    # [B,nc,H,Q]
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xdt * decay_to_end.permute(0, 1, 3, 2)[..., None])
    chunk_decay = torch.exp(dA_cum[..., -1])               # [B,nc,H]

    # inter-chunk recurrence over the nc chunks
    st = (torch.zeros_like(states[:, 0]) if init_state is None
          else init_state.to(states.dtype))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [B,nc,H,P,N]

    # inter-chunk contribution: y += C_q exp(dA_cum_q) S_prev
    in_decay = torch.exp(dA_cum).permute(0, 1, 3, 2)       # [B,nc,Q,H]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * in_decay[..., None]

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, st


def _share_dims(cfg, split: Optional[MixerSplit]) -> tuple:
    """(heads, head dim) of the rank's share of the SSD mixer."""
    _, n_heads, _ = dims(cfg)
    if split is None:
        return n_heads, cfg.ssm_head_dim
    if split.mode == "heads":
        return split.size, cfg.ssm_head_dim
    return n_heads, split.size


def _channels(t: torch.Tensor, cfg, split: Optional[MixerSplit]):
    """The rank's x channels of ``t``'s last dim (``d_inner`` head-major
    channels, or more: the rest is dropped): its heads' block in
    ``"heads"``, its slice of each head's dims in ``"p"``."""
    p = cfg.ssm_head_dim
    if split is None:
        return t
    if split.mode == "heads":
        return t[..., split.lo * p:split.hi * p]
    heads = dims(cfg)[1]
    return t[..., :heads * p].unflatten(-1, (heads, p))[
        ..., split.lo:split.hi].flatten(-2)


def _heads(t: torch.Tensor, split: Optional[MixerSplit]) -> torch.Tensor:
    """The rank's heads of a per-head operand's last dim in ``"heads"``;
    ``t`` otherwise (every head in ``"p"``)."""
    if split is None or split.mode != "heads":
        return t
    return t[..., split.lo:split.hi]


def _conv_operand(t: torch.Tensor, cfg, split: Optional[MixerSplit]):
    """The rank's channels of a conv operand over ``[x | B | C]``: its x
    channels followed by B and C, whole."""
    if split is None:
        return t
    d_inner = dims(cfg)[0]
    return torch.cat([_channels(t, cfg, split), t[..., d_inner:]], dim=-1)


def state_dims(cfg) -> tuple:
    """The shapes, without the batch, of a rank's (conv, ssm) state:
    ``(K-1, x channels + 2N)`` and ``(heads, head dim, N)`` of its share
    (:func:`~repro_torch.models.mixer_split.ssd_split`; the whole mixer
    off a serving mesh)."""
    heads, p = _share_dims(cfg, ssd_split(cfg))
    return ((cfg.conv1d_size - 1, heads * p + 2 * cfg.ssm_state),
            (heads, p, cfg.ssm_state))


def ssm_forward(params, x, cfg, state: Optional[SSMState] = None,
                decode: bool = False, dtype=torch.bfloat16, pad_mask=None):
    """Full mixer.  x: [B, S, d].  Returns (y, new_state).

    ``pad_mask`` ([B, S] bool, True = real token; left-padded prefill):
    padded steps are identity transitions: conv inputs zeroed (so the
    carried conv state matches an unpadded run) and ``dt`` zeroed (so
    ``exp(dt*A) = 1`` passes the SSD state through and the padded step
    adds nothing to any real position's output).

    On a serving mesh the rank runs its share (module docstring) and
    ``state`` holds it (:func:`state_dims`; a state of another split
    raises); a tensor-parallel training step runs its share with no
    state."""
    b, s, _ = x.shape
    d_inner, n_heads, conv_dim = dims(cfg)
    n = cfg.ssm_state
    sp = cfg.policy.resolver("ssm")
    split = ssd_split(cfg)
    heads, p = _share_dims(cfg, split)
    if state is not None and tuple(state.ssm.shape[-3:]) != (heads, p, n):
        raise ValueError(
            f"an SSM state of {tuple(state.ssm.shape[-3:])} (heads, head "
            f"dim, N) for a mixer of {(heads, p, n)} on this rank: make "
            f"the state in the scope that serves it")
    local = split is not None and split.local
    mesh = tp_mesh()
    if tally.ACTIVE and train_mesh() is not None:
        tally.report_form("ssm", "whole" if mesh is None
                          else f"tp/{split.mode}")
    if mesh is not None:
        if state is not None:
            raise ValueError("a tensor-parallel training step runs no SSM "
                             "state")
        params = dict(params, conv_w=shared_leaf(params["conv_w"], conv_dim),
                      **{k: shared_leaf(params[k], int(params[k].shape[-1]))
                         for k in ("conv_b", "A_log", "D", "dt_bias",
                                   "norm_scale")})
        zxbcdt = _tp_in_proj(params["in_proj"], x, sp("ssm.in_proj"), dtype,
                             2 * d_inner + 2 * n + n_heads)
    else:
        zxbcdt = linear(params["in_proj"], x, sp("ssm.in_proj"), dtype)
    z = zxbcdt[..., :d_inner]
    xbc = _conv_operand(zxbcdt[..., d_inner:d_inner + conv_dim], cfg, split)
    dt = _softplus(_heads(zxbcdt[..., -n_heads:], split).to(torch.float32)
                   + _heads(params["dt_bias"], split))
    if pad_mask is not None:
        xbc = xbc * pad_mask[..., None].to(xbc.dtype)
        dt = dt * pad_mask[..., None].to(dt.dtype)

    conv_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(
        xbc, _conv_operand(params["conv_w"], cfg, split).to(dtype),
        _conv_operand(params["conv_b"], cfg, split).to(dtype), conv_state)
    xbc = F.silu(xbc)
    d_loc = heads * p
    xs = xbc[..., :d_loc].reshape(b, s, heads, p)
    B_ = xbc[..., d_loc:d_loc + n].to(torch.float32)
    C_ = xbc[..., d_loc + n:].to(torch.float32)
    A = _heads(params["A_log"], split)

    if decode:
        assert s == 1
        dA = torch.exp(dt[:, 0] * (-torch.exp(A))[None, :])     # [B,H]
        xdt = xs[:, 0].to(torch.float32) * dt[:, 0, :, None]   # [B,H,P]
        new_ssm = state.ssm * dA[..., None, None] \
            + xdt[..., None] * B_[:, 0, None, None, :]
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0], new_ssm)[:, None]
    else:
        y, new_ssm = ssd_chunked(xs.to(torch.float32), dt, A, B_, C_,
                                 cfg.ssm_chunk,
                                 init_state=(state.ssm if state is not None
                                             else None))
    y = y + _heads(params["D"], split)[None, None, :, None] \
        * xs.to(torch.float32)
    norm_scale = params["norm_scale"]
    if local:        # the norm and out_proj on the rank's channels
        z, norm_scale = _channels(z, cfg, split), _channels(norm_scale, cfg,
                                                            split)
    elif split is not None:     # [B, S, heads, p]: gather the share
        y = _joined(y.to(dtype), 2 if split.mode == "heads" else 3)
    y = y.reshape(b, s, -1).to(dtype)

    # gated RMSNorm (mamba2): the mean over d_inner is the sum of each
    # head's sum of squares times the float32 reciprocal of d_inner
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    ss = (yf * yf).unflatten(-1, (-1, cfg.ssm_head_dim)).sum(dim=-1)
    if local:
        ss = _joined(ss, ss.ndim - 1)
    ms = ss.sum(dim=-1, keepdim=True) * (1.0 / d_inner)
    yf = yf * torch.rsqrt(ms + 1e-6)
    if mesh is not None and not local:
        # "p": out_proj's rows on this rank are a contiguous block of the
        # channels, and only it goes on
        rows = int(params["out_proj"]["w"].shape[-2])
        lo = mesh.index("model") * rows
        yf, norm_scale = yf.narrow(-1, lo, rows), norm_scale.narrow(-1, lo,
                                                                     rows)
    y = (yf * norm_scale).to(dtype)

    if mesh is not None:
        out = row_linear(params["out_proj"], y, sp("ssm.out_proj"), dtype)
    else:
        out = linear(params["out_proj"], y, sp("ssm.out_proj"), dtype,
                     local="row" if local else None)
    return out, SSMState(new_conv, new_ssm)


def _joined(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' shares of ``t`` joined on ``dim`` over ``"model"``: on a
    serving mesh an all-gather; in a tensor-parallel training step the
    differentiable gather whose backward sums the gradient (each rank
    goes on with its own share of the result)."""
    if tp_mesh() is None:
        return serving_mesh().all_gather(t, "model", dim=dim)
    return autoshard.gather(t, "model", dim, partial=True)


def _tp_in_proj(p: dict, x: torch.Tensor, spec, dtype,
                cols: int) -> torch.Tensor:
    """``in_proj``'s output in a tensor-parallel training step, whole on
    every rank: the rank's column tile of its replicated input, gathered,
    or the whole weight (all ``cols`` columns) where the model axis does
    not divide them.  Each rank uses only its channels of the output (B
    and C feed every rank's share), so the output's gradient is summed
    over ``"model"`` either way."""
    if int(p["w"].shape[-1]) == cols:
        return sum_grad(linear(p, x, spec, dtype), "model")
    y = linear(p, replicated(x, spec), spec, dtype, tile="col")
    return autoshard.gather(y, "model", y.ndim - 1, partial=True)


def init_ssm_state(cfg, batch: int, dtype, device,
                   lead: tuple = ()) -> SSMState:
    """A zero state; on a serving mesh the rank's share
    (:func:`state_dims`)."""
    conv, ssm = state_dims(cfg)
    return SSMState(
        conv=torch.zeros(lead + (batch,) + conv, dtype=dtype, device=device),
        ssm=torch.zeros(lead + (batch,) + ssm, dtype=torch.float32,
                        device=device),
    )
