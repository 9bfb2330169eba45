"""Opt-in runtime sanitizer for the accel stack.  Port of
``repro.analysis.sanitize``.

``accel.sanitize()`` opens a scope during which the stack's boundaries
self-check:

* **NaN/Inf guards** — every tensor crossing the ``accel.matmul``
  dispatch boundary (input, weight, output) and every array pulled to
  the host through :func:`repro_torch.serve.host.host_sync` is checked
  finite.  On the ``kernel`` backend the output guard reads the CUDA
  kernel's own result, its fused epilogue included.
* **ADC saturation counter** — the fraction of
  :func:`repro_torch.core.adc.adc_convert` codes landing on the top code
  (clipped charge-share range, the analog analog of int overflow).  On
  the kernel the ADC runs inside the launch and nothing is observed.
* **B_y overflow counter** — the fraction of values entering the
  datapath's :func:`repro_torch.core.datapath.saturate` stage that
  exceed the B_y word and get clipped (paper Fig. 8's output-word rule).
* **Allocator audit** — :meth:`Sanitizer.audit_allocator` proves the
  paged-KV :class:`~repro_torch.serve.kv.BlockAllocator` drained at
  scheduler shutdown (leaked blocks = requests retired without freeing
  their tables); double-frees already raise in the allocator itself.
* **VDD-corner validity** — ``sanitize(vdd=0.85)`` pins the supply
  corner: it must be a modeled corner (``SIGMA_LSB_CORNER``), and any
  noise-modeling spec dispatched inside the scope must carry at least
  that corner's sigma — a 0.85 V run claiming 1.2 V noise is a silently
  optimistic robustness result.

Hard violations (non-finite values, allocator leaks, unknown corner,
``require_noise_key=True`` with no noise generator in scope) raise
:class:`SanitizeError` at the offending call.  Rates (saturation,
overflow, corner mismatches) accumulate on :class:`SanitizerStats` and
only fail the scope when a ``*_limit`` threshold is set.

A check reduces on the tensor's own device and reads back one bool:
copying each operand to the host would move every full-width weight
over PCIe at every dispatch.  Tensors without data are skipped, as the
reference skips tracers: ``meta`` and fake tensors, and any tensor
while the current stream captures a CUDA graph.  Checks read
``x.detach()``, so autograd sees no op of theirs.  Integer tensors
(int8 planes) are not checked.

The scope stack is module-wide, not thread-local: autograd runs the
backward, and remat's recomputed forward, in a thread of its own on
CUDA, and those dispatches must see the scope the caller opened.

This module imports no other repro_torch module at import time, so the
hook sites (``accel.dispatch``, ``core.adc``, ``core.datapath``,
``serve``) can import it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


class SanitizeError(RuntimeError):
    """A sanitizer invariant was violated."""


@dataclasses.dataclass
class SanitizerStats:
    finite_checks: int = 0
    dispatches: int = 0
    adc_conversions: int = 0      # code decisions observed
    adc_saturated: int = 0        # of which landed on the top code
    by_values: int = 0            # values through saturate()
    by_overflowed: int = 0        # of which exceeded the B_y word
    corner_mismatches: int = 0
    allocator_audits: int = 0

    @property
    def adc_saturation_rate(self) -> float:
        return self.adc_saturated / max(self.adc_conversions, 1)

    @property
    def by_overflow_rate(self) -> float:
        return self.by_overflowed / max(self.by_values, 1)


def _has_data(x: torch.Tensor) -> bool:
    """Can a check read ``x``?  Not a meta or fake tensor, and not a CUDA
    tensor while its stream captures a graph (a read would end the
    capture)."""
    if x.is_meta:
        return False
    if type(x) not in (torch.Tensor, torch.nn.Parameter):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(x, FakeTensor):
            return False
    return not (x.is_cuda and torch.cuda.is_current_stream_capturing())


@dataclasses.dataclass(eq=False)        # identity eq: scopes nest by object
class Sanitizer:
    """One active ``sanitize()`` scope."""

    vdd: Optional[float] = None
    require_noise_key: bool = False
    adc_saturation_limit: Optional[float] = None
    by_overflow_limit: Optional[float] = None
    stats: SanitizerStats = dataclasses.field(default_factory=SanitizerStats)

    # -------------------------------------------------------------- checks

    def check_finite(self, x, where: str) -> None:
        if x is None:
            return
        if isinstance(x, np.ndarray):          # a host array (host_sync)
            if not (np.issubdtype(x.dtype, np.floating)
                    or np.issubdtype(x.dtype, np.complexfloating)):
                return
            self.stats.finite_checks += 1
            finite = np.isfinite(x)
            if not finite.all():
                self._non_finite(int((~finite).sum()), x.shape, where)
            return
        if not torch.is_tensor(x) or not _has_data(x):
            return
        if not (x.is_floating_point() or x.is_complex()):
            return
        self.stats.finite_checks += 1
        x = x.detach()
        if not bool(torch.isfinite(x).all()):     # the one device read
            self._non_finite(int((~torch.isfinite(x)).sum()), x.shape,
                             where)

    @staticmethod
    def _non_finite(bad: int, shape, where: str) -> None:
        raise SanitizeError(
            f"sanitize: {bad} non-finite value(s) at {where} "
            f"(shape {tuple(shape)})")

    def observe_dispatch(self, spec, ctx) -> None:
        self.stats.dispatches += 1
        sigma = getattr(spec, "adc_sigma_lsb", 0.0)
        if self.require_noise_key and sigma and \
                getattr(ctx, "generator", None) is None:
            raise SanitizeError(
                f"sanitize(require_noise_key=True): spec "
                f"{getattr(spec, 'tag', '') or spec.backend!r} models "
                f"adc_sigma_lsb={sigma} but no noise key reached the "
                f"dispatch; wrap the call in accel.adc_noise(seed)")
        if self.vdd is not None and not getattr(spec, "is_digital", False) \
                and not getattr(spec, "ideal_adc", False):
            corner = self._corner_sigma()
            if sigma < corner:
                self.stats.corner_mismatches += 1

    def _corner_sigma(self) -> float:
        from repro_torch.core.adc import SIGMA_LSB_CORNER

        if self.vdd not in SIGMA_LSB_CORNER:
            raise SanitizeError(
                f"sanitize(vdd={self.vdd}): not a modeled supply corner; "
                f"known corners: {sorted(SIGMA_LSB_CORNER)}")
        return SIGMA_LSB_CORNER[self.vdd]

    def observe_adc(self, codes, cmax: float) -> None:
        if not torch.is_tensor(codes) or not _has_data(codes):
            return
        self.stats.adc_conversions += codes.numel()
        self.stats.adc_saturated += int((codes >= cmax).sum())

    def observe_by(self, y, bits: int) -> None:
        if not torch.is_tensor(y) or not _has_data(y):
            return
        hi = 2.0 ** (bits - 1) - 1
        self.stats.by_values += y.numel()
        self.stats.by_overflowed += int(((y > hi) | (y < -(hi + 1))).sum())

    def audit_allocator(self, alloc, where: str = "shutdown") -> None:
        self.stats.allocator_audits += 1
        held = sorted(getattr(alloc, "_held", ()))
        if alloc.available != alloc.num_blocks or held:
            raise SanitizeError(
                f"sanitize: BlockAllocator leaked {len(held)} block(s) at "
                f"{where}: {held[:16]}{'...' if len(held) > 16 else ''} "
                f"({alloc.available}/{alloc.num_blocks} free)")

    def _check_limits(self) -> None:
        s = self.stats
        if self.adc_saturation_limit is not None and \
                s.adc_saturation_rate > self.adc_saturation_limit:
            raise SanitizeError(
                f"sanitize: ADC saturation rate "
                f"{s.adc_saturation_rate:.3f} exceeds limit "
                f"{self.adc_saturation_limit} ({s.adc_saturated}/"
                f"{s.adc_conversions} codes on the top code); the "
                f"charge-share range is clipping — raise adc_bits or "
                f"enable adaptive_range")
        if self.by_overflow_limit is not None and \
                s.by_overflow_rate > self.by_overflow_limit:
            raise SanitizeError(
                f"sanitize: B_y overflow rate {s.by_overflow_rate:.3f} "
                f"exceeds limit {self.by_overflow_limit} "
                f"({s.by_overflowed}/{s.by_values} values clipped); the "
                f"recombined sum outgrows the Fig. 8 output word")


# module-wide, as accel.context's stacks: autograd's device thread runs
# the backward and remat's replayed forward under the caller's scope
_SCOPES: list[Sanitizer] = []


def active() -> Optional[Sanitizer]:
    """The innermost active sanitizer scope, or None."""
    return _SCOPES[-1] if _SCOPES else None


class sanitize:
    """Context manager opening a sanitizer scope (see module docstring).

    ::

        with accel.sanitize(vdd=0.85, adc_saturation_limit=0.25) as san:
            logits, _ = forward(params, tokens, cfg)
        print(san.stats.adc_saturation_rate)
    """

    def __init__(self, *, vdd: Optional[float] = None,
                 require_noise_key: bool = False,
                 adc_saturation_limit: Optional[float] = None,
                 by_overflow_limit: Optional[float] = None):
        self.sanitizer = Sanitizer(
            vdd=vdd, require_noise_key=require_noise_key,
            adc_saturation_limit=adc_saturation_limit,
            by_overflow_limit=by_overflow_limit)

    def __enter__(self) -> Sanitizer:
        if self.sanitizer.vdd is not None:
            self.sanitizer._corner_sigma()    # unknown corner fails fast
        _SCOPES.append(self.sanitizer)
        return self.sanitizer

    def __exit__(self, exc_type, exc, tb) -> None:
        _SCOPES.remove(self.sanitizer)
        if exc_type is None:
            self.sanitizer._check_limits()
