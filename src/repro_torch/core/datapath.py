"""Near-memory digital datapath: post-reduce compute (paper Figs. 5, 8).
Port of ``repro.core.datapath``.

After BP/BS recombination the datapath applies, in the chip's order:
scale -> bias -> activation -> saturation to B_y bits (16 b when
``B_X + B_A <= 5``, else 32 b).  :class:`Postreduce` is one datapath
program, the ``post=`` argument of :func:`repro_torch.accel.matmul`;
:func:`fold_batchnorm` computes its registers from BN statistics.  Every
stage is differentiable under autograd, tensor registers included (a
residual stream on the bias port), with the reference's gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis.sanitize import active as _san_active


def output_bits(bx: int, ba: int) -> int:
    """B_y as set by the near-memory datapath (paper Fig. 8)."""
    return 16 if (bx + ba) <= 5 else 32


def saturate(y: torch.Tensor, bits: int) -> torch.Tensor:
    """Clip to the signed ``bits``-bit output word.  Under autograd it is
    ``minimum(maximum(y, lo), hi)``, as ``jnp.clip`` computes it, so a
    value exactly on a bound gets the reference's gradient 1/2 (the two
    operands of a tie share it); ``torch.clamp`` would give 1."""
    hi = 2.0 ** (bits - 1) - 1
    san = _san_active()
    if san is not None:
        # overflow counter: values clipped here outgrew the Fig. 8 B_y
        # output word (sanitizer contract)
        san.observe_by(y, bits)
    if y.requires_grad:
        return torch.minimum(torch.maximum(y, y.new_full((), -(hi + 1))),
                             y.new_full((), hi))
    return torch.clamp(y, -(hi + 1), hi)


# "gelu" is the tanh approximation (jax.nn.gelu's default) and "sign"
# maps 0 to +1 (torch.sign would map it to 0)
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sign": lambda x: torch.where(x >= 0, 1.0, -1.0),
    "identity": lambda x: x,
}


def postreduce(y: torch.Tensor, scale=None, bias=None,
               act: Optional[str] = None,
               by_bits: Optional[int] = None) -> torch.Tensor:
    """scale -> bias -> activation -> saturate-to-B_y (saturation last:
    it bounds the output word the datapath writes)."""
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    if act is not None:
        y = ACTIVATIONS[act](y)
    if by_bits is not None:
        y = saturate(y, by_bits)
    return y


@dataclasses.dataclass
class Postreduce:
    """One datapath program: the fused epilogue of a CIMU matmul.

    ``scale``/``bias`` are the scale/bias register contents (scalar,
    per-column ``[M]``, or anything broadcastable to the output — a
    residual stream rides the bias port).  ``saturate`` clips to the
    executing spec's B_y; ``by_bits`` sets that width explicitly."""

    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    act: Optional[str] = None
    saturate: bool = False
    by_bits: Optional[int] = None

    def resolve_bits(self, bx: Optional[int] = None,
                     ba: Optional[int] = None) -> Optional[int]:
        """The saturation width in effect (None = no saturation)."""
        if self.by_bits is not None:
            return self.by_bits
        if self.saturate and bx is not None and ba is not None:
            return output_bits(bx, ba)
        return None

    def n_ops(self) -> int:
        """Datapath ops per output element (the trace's count)."""
        return ((self.scale is not None) + (self.bias is not None)
                + (self.act not in (None, "identity"))
                + (self.saturate or self.by_bits is not None))

    def apply(self, y: torch.Tensor, bx: Optional[int] = None,
              ba: Optional[int] = None) -> torch.Tensor:
        """Run the pipeline on ``y`` (the unfused reference semantics)."""
        return postreduce(y, self.scale, self.bias, self.act,
                          self.resolve_bits(bx, ba))


def fold_batchnorm(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN statistics into the datapath's (scale, bias) registers:
    ``inv = gamma * rsqrt(var + eps)`` and ``beta - mean * inv``."""
    inv = gamma * torch.rsqrt(var + eps)
    return inv, beta - mean * inv
