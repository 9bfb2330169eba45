"""The tuner's quality axis: what a precision choice costs in accuracy.
Port of ``repro.tune.quality``.

Energy and throughput reprice analytically; quality cannot — a 1-b
network is cheaper *because* it computes less.  Two pluggable models
close the loop without breaking the trace-once contract:

* :class:`SqnrQuality` — the LM proxy: empirical SQNR (dB) of the
  candidate's quantized compute against the float GEMM, per managed
  projection, on synthetic operands (:mod:`repro_torch.core.sqnr`'s
  methodology, paper Fig. 7/10).  A candidate's score is the WEAKEST
  projection's dB (quality is gated by the worst layer).  Results are
  cached by the quantization signature — a 500-point sweep whose
  candidates draw from 4 precisions triggers 4 small synthetic matmuls,
  not 500 network evaluations.  The operands come from a
  ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
  unless the caller asks for another), drawn by :func:`sqnr_operands`.
* :class:`CifarQuality` — exact task accuracy: run the (reduced) CIFAR
  network under the candidate's policy through
  :func:`repro_torch.models.cnn.cnn_forward`.  Same caching: one eval
  per distinct policy signature.

Both expose ``score(candidate, cost_model=None) -> float`` (higher is
better); :class:`NullQuality` scores nothing and drops the quality axis
from the frontier entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.quant import Coding


class NullQuality:
    """No quality model: every candidate scores None (axis disabled)."""

    def describe(self) -> str:
        return "none"

    def score(self, cand, cost_model=None) -> Optional[float]:
        return None


def sqnr_operands(seed: int, batch: int, n: int, m: int, device):
    """The synthetic float operands of one SQNR probe: ``x [batch, n]``
    and ``w [n, m]`` standard normal (``w`` scaled by ``n ** -0.5``),
    drawn from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, n), generator=gen, device=device)
    # accel-lint: allow[JAX02] x then w from the probe's own seeded stream
    w = torch.randn((n, m), generator=gen, device=device) * n ** -0.5
    return x, w


@dataclasses.dataclass
class SqnrQuality:
    """SQNR-vs-float proxy for LM candidates.

    For each footprint the candidate's resolved spec is exercised on
    synthetic float operands through the real backend
    (:func:`repro_torch.accel.matmul`, outside any trace scope — nothing
    is recorded; on ``kernel`` a launch of the CUDA kernel) and compared
    against the float GEMM.  ``digital`` specs score ``digital_db`` (no
    quantization).  The candidate's score is the minimum over
    projections.
    """

    batch: int = 32
    m: int = 64
    n_cap: int = 2304      # SQNR is ~independent of n beyond one bank
    seed: int = 0
    digital_db: float = 80.0
    device: Any = "cuda"
    _cache: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return "sqnr-vs-float"

    def _sig(self, spec, n: int) -> tuple:
        return (spec.backend, min(n, self.n_cap), spec.ba, spec.bx,
                Coding(spec.coding).value, spec.bank_n, spec.adc_bits,
                spec.adc_sigma_lsb, spec.adaptive_range, spec.ideal_adc)

    def _measure(self, spec, n: int) -> float:
        from repro_torch import accel
        from repro_torch.core.sqnr import sqnr_db

        if spec.is_digital:
            return self.digital_db
        sig = self._sig(spec, n)
        hit = self._cache.get(sig)
        if hit is not None:
            return hit
        n_eff = min(n, self.n_cap)
        x, w = sqnr_operands(self.seed, self.batch, n_eff, self.m,
                             self.device)
        with torch.no_grad():
            y_hat = accel.matmul(x, w, dataclasses.replace(spec, tag="sqnr"))
            db = float(sqnr_db(x @ w, y_hat))
        self._cache[sig] = db
        return db

    def score(self, cand, cost_model=None) -> float:
        if cost_model is None or not getattr(cost_model, "footprints", None):
            raise ValueError(
                "SqnrQuality needs the cost model's footprint list to "
                "know which projections a policy touches")
        return min(
            self._measure(cand.policy.resolve(fp.tag, kind=fp.kind), fp.n)
            for fp in cost_model.footprints)


@dataclasses.dataclass
class CifarQuality:
    """Exact CIFAR accuracy of a candidate policy (the paper's task axis).

    Evaluates ``cnn_forward(params, images, net-with-candidate-policy)``
    once per distinct policy signature, on the device ``images`` lie on.
    The candidate may carry a full
    :class:`~repro_torch.accel.policy.PrecisionPolicy` (LM-style
    :class:`~repro_torch.tune.space.Candidate`) or just ``ba``/``bx`` (the
    analytic :class:`~repro_torch.tune.tuner.CifarCandidate`), in which
    case the net's own policy is rescaled to those widths.
    """

    params: dict
    net: Any                  # CnnConfig
    images: Any               # [B, H, W, 3]
    labels: Any               # [B]
    _cache: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return f"cifar-accuracy[{self.net.name}]"

    def _policy_of(self, cand):
        if getattr(cand, "policy", None) is not None:
            return cand.policy
        from .space import _rescale_policy

        return _rescale_policy(self.net.policy, cand.ba, cand.bx)

    def score(self, cand, cost_model=None) -> float:
        from repro_torch.models.cnn import cnn_forward

        from .space import _describe_policy

        policy = self._policy_of(cand)
        sig = repr(_describe_policy(policy))
        hit = self._cache.get(sig)
        if hit is not None:
            return hit
        net = dataclasses.replace(self.net, policy=policy)
        with torch.no_grad():
            logits = cnn_forward(self.params, self.images, net, train=False)
        acc = float(torch.mean(
            (torch.argmax(logits, -1) == self.labels).to(torch.float32)))
        self._cache[sig] = acc
        return acc
