"""ExecSpec: the static description of how one matmul executes.  Port of
``repro.accel.spec``.

``backend`` names a registered execution substrate:

* ``digital``      — plain float GEMM at the caller's compute dtype.
* ``digital_int``  — bit-true integer compute at (B_A, B_X): the paper's
                     *ideal* reference.
* ``bpbs``         — the BP/BS pipeline's fast GEMM-identity path
                     (:mod:`repro_torch.core.bpbs`), with ADC noise.
* ``bpbs_ref``     — the same MVM cell by cell (slow; validation only).
* ``kernel``       — the hand-written CUDA kernel
                     (:mod:`repro_torch.kernels.cima_mvm`); its plain
                     torch version on CPU tensors.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.bpbs import BpbsConfig
from repro_torch.core.quant import Coding


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Hashable execution spec attached to a projection (or a policy rule)."""

    backend: str = "digital"
    ba: int = 4                    # matrix-element bits (parallel columns)
    bx: int = 4                    # input-element bits (serial steps)
    coding: Coding = Coding.XNOR
    bank_n: int = 2304             # rows per charge-share/ADC boundary
    adc_bits: int = 8
    adc_sigma_lsb: float = 0.0     # analog non-ideality, LSB units
    adaptive_range: bool = False   # ADC full scale tracks unmasked rows
    ideal_adc: bool = False        # bypass the ADC (bit-true integer compute)
    per_channel: bool = True       # per-output-column weight scales
    # one input scale per row (what a per-vector input DAC sees): a
    # request's quantized values never depend on its batch neighbours
    x_per_row: bool = False
    # gate the plane products of all-zero input planes (bit-identical)
    skip_zero_planes: bool = True
    tag: str = ""                  # provenance: the path a policy resolved

    def __post_init__(self):
        object.__setattr__(self, "coding", Coding(self.coding))
        from .registry import known_backend, list_backends

        if not known_backend(self.backend):
            raise ValueError(
                f"unknown accel backend {self.backend!r}; registered: "
                f"{list_backends()}")

    @property
    def is_digital(self) -> bool:
        return self.backend == "digital"

    def bpbs(self) -> BpbsConfig:
        """The core BP/BS config this spec describes."""
        return BpbsConfig(
            ba=self.ba, bx=self.bx, coding=self.coding, bank_n=self.bank_n,
            adc_bits=self.adc_bits, adc_sigma_lsb=self.adc_sigma_lsb,
            adaptive_range=self.adaptive_range, ideal_adc=self.ideal_adc,
            skip_zero_planes=self.skip_zero_planes)

    def with_(self, **kw) -> "ExecSpec":
        return dataclasses.replace(self, **kw)
