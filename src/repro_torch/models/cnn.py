"""The paper's CIFAR-10 networks (Fig. 11), mapped as the chip maps them.
Port of ``repro.models.cnn``.

Every 3x3 conv is im2col'd into an MVM of dimensionality N = 9*C_in
(<= 2304 = 3*3*256, the CIMA's designed-for shape) and runs through
:func:`repro_torch.accel.matmul`; batch norm folds into the near-memory
datapath's scale/bias registers; Network B's binary activations are the
ABN comparator.

Inference (``train=False``) is the chip's pipeline: the BN running
statistics fold through :func:`~repro_torch.core.datapath.fold_batchnorm`
into a :class:`~repro_torch.core.datapath.Postreduce`, and scale, bias,
activation and B_y saturation run as the matmul's fused epilogue (inside
the CUDA kernel on the ``kernel`` backend), so an image's logits never
depend on its batch neighbours.  ``train=True`` normalizes with live
batch statistics and returns them for :func:`update_bn_stats`; under
autograd it is the QAT forward: the straight-through ``accel.matmul``
(the kernel forward, float32 GEMM backward), batch norm, ``ste_sign`` or
relu, and the 2x2 max-pool as ``amax``, which splits a tie's gradient
evenly as ``jnp.max`` does (Network B's ±1 activations tie as a rule).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import accel
from repro_torch.configs.cifar_nets import CnnConfig
from repro_torch.core.datapath import Postreduce, fold_batchnorm
from repro_torch.optim.qat import ste_sign

from .layers import truncated_normal_init


def _im2col(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """x: [B, H, W, C] -> patches [B, H, W, k*k*C] (SAME padding), the
    Reshaping Buffer's window extraction (Fig. 6a).

    The patch axis is SPATIAL-major: row ``(kh*k + kw)*C + c`` holds
    input channel ``c`` at window offset ``(kh, kw)``, the chip's
    ``9*C_in`` row order.  ``F.unfold`` on NCHW gives the channel-major
    ``(c, kh, kw)`` order, so the patches are reordered here."""
    b, h, w, c = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=k // 2)  # [B,C*k*k,HW]
    cols = cols.reshape(b, c, k * k, h, w)
    return cols.permute(0, 3, 4, 2, 1).reshape(b, h, w, k * k * c)


def init_cnn(seed: int, net: CnnConfig, device="cuda") -> dict:
    """Per layer: the im2col'd weight matrix plus the BN parameters and
    running statistics (``bn_mean``/``bn_var``) the inference datapath
    registers are folded from.  Weights are drawn from ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    layers = []
    for layer in net.layers:
        n = layer.cin * (9 if layer.kind == "conv" else 1)
        # accel-lint: allow[JAX02] init: one seeded stream
        w = truncated_normal_init(gen, (n, layer.cout), n ** -0.5, "cpu")
        layers.append({
            "w": w.to(device),
            "bn_scale": torch.ones(layer.cout, device=device),
            "bn_bias": torch.zeros(layer.cout, device=device),
            "bn_mean": torch.zeros(layer.cout, device=device),
            "bn_var": torch.ones(layer.cout, device=device),
        })
    return {"layers": layers}


def _batchnorm(y: torch.Tensor, scale, bias, eps: float = 1e-5):
    """Training-mode BN on live batch statistics; returns the normalized
    output and the per-channel (mean, var)."""
    dims = tuple(range(y.ndim - 1))
    mu = torch.mean(y, dims, keepdim=True)
    var = torch.mean(torch.square(y - mu), dims, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps) * scale + bias
    return out, (mu.reshape(-1), var.reshape(-1))


def update_bn_stats(params: dict, stats, momentum: float = 0.9) -> dict:
    """EMA-update the running BN statistics from one training batch's
    ``stats`` (the ``bn_stats`` of :func:`cnn_forward` / :func:`cnn_loss`
    with ``train=True``).  Returns a new tree."""
    new = {"layers": []}
    for p, (mu, var) in zip(params["layers"], stats):
        q = dict(p)
        q["bn_mean"] = momentum * p["bn_mean"] + (1.0 - momentum) * mu
        q["bn_var"] = momentum * p["bn_var"] + (1.0 - momentum) * var
        new["layers"].append(q)
    return new


def cnn_forward(params, images: torch.Tensor, net: CnnConfig,
                backend: Optional[str] = None, train: bool = False):
    """images: [B, 32, 32, 3] -> logits [B, 10] (plus the per-layer BN
    batch statistics when ``train=True``).

    ``backend`` runs the whole net under :func:`repro_torch.accel.
    override`, so the same parameters evaluate under the ideal and the
    chip model.  The loop is unrolled, so layer-index policy rules
    apply, and every layer dispatches (and records) once."""
    ov = (accel.override(backend=backend) if backend is not None
          else contextlib.nullcontext())
    x = images
    n_layers = len(net.layers)
    bn_stats = []
    with ov:
        for i, (layer, p) in enumerate(zip(net.layers, params["layers"])):
            if layer.kind == "conv":
                h = _im2col(x)                           # [B,H,W,9*Cin]
            else:
                h = x.reshape(x.shape[0], -1)            # flatten
            spec = net.policy.resolve(f"layer{i}", kind=layer.kind, layer=i)
            last = i == n_layers - 1
            if train:
                y = accel.matmul(h, p["w"], spec, dtype=torch.float32)
                y, (mu, var) = _batchnorm(y, p["bn_scale"], p["bn_bias"])
                bn_stats.append((mu.detach(), var.detach()))
                if not last:
                    y = ste_sign(y) if net.readout == "abn" \
                        else torch.relu(y)
            else:
                s, b = fold_batchnorm(p["bn_scale"], p["bn_bias"],
                                      p["bn_mean"], p["bn_var"])
                post = Postreduce(
                    scale=s, bias=b,
                    act=None if last else
                    ("sign" if net.readout == "abn" else "relu"),
                    saturate=True)
                y = accel.matmul(h, p["w"], spec, dtype=torch.float32,
                                 post=post)
            if layer.kind == "conv" and layer.pool:
                b_, hh, ww, c = y.shape
                y = y.reshape(b_, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
            x = y
    return (x, bn_stats) if train else x


def cnn_loss(params, batch: dict, net: CnnConfig,
             backend: Optional[str] = None, train: bool = True):
    """Cross-entropy and accuracy; ``metrics["bn_stats"]`` carries the
    per-layer batch statistics for :func:`update_bn_stats` when
    ``train=True``."""
    if train:
        logits, bn_stats = cnn_forward(params, batch["images"], net,
                                       backend, train=True)
    else:
        logits, bn_stats = cnn_forward(params, batch["images"], net,
                                       backend), []
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
    loss = torch.mean(logz - ll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    metrics = {"loss": loss, "acc": acc}
    if train:
        metrics["bn_stats"] = bn_stats
    return loss, metrics
