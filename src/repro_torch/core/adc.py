"""Per-column SAR ADC and binarizing ABN models (paper Figs. 2, 5, 10).
Port of ``repro.core.adc``.

The column popcount ``p`` in ``[0, full_scale]`` is digitized to
``2^adc_bits`` codes and reconstructed.  The operation order is the
reference's exactly — ``clip(p, 0, fs) * (cmax / fs)``, half-to-even
rounding, then ``round(code * (fs / cmax))`` — which is what makes the
grids bitwise-equal to it (and to the CUDA kernel's epilogue).

``sigma_lsb`` adds Gaussian noise in LSB units before the code decision,
the residual analog non-ideality of Fig. 10.  It is drawn from an
explicit ``torch.Generator`` on the tensor's device, so it matches the
reference in distribution, not in bits.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.analysis.sanitize import active as _san_active

# Modelled residual analog non-ideality per VDD corner, in ADC LSB units.
# Fig. 10's measured column transfer functions bound the deviation to a
# fraction of an LSB; the 0.85 V corner runs the charge share and the SAR
# comparator at reduced headroom, so it is modelled noisier.  These are
# the sigmas of the noise-aware-QAT and BN-calibration recipe
# (repro_torch.optim.qat).
SIGMA_LSB_CORNER = {1.2: 0.15, 0.85: 0.3}


def adc_codes(adc_bits: int = 8) -> int:
    return 2 ** adc_bits


def _warn_keyless_noise(sigma_lsb: float, where: str) -> None:
    """A spec requested noise (``sigma_lsb > 0``) but no generator reached
    the conversion: say so loudly instead of silently running noiseless."""
    warnings.warn(
        f"{where}: adc_sigma_lsb={sigma_lsb} requested but no noise "
        "generator is in scope — running NOISELESS. Wrap the call in "
        "`with repro_torch.accel.adc_noise(seed):` (or pass a "
        "torch.Generator) to sample the analog non-ideality, or set "
        "adc_sigma_lsb=0 to silence this.", RuntimeWarning, stacklevel=3)


def _full_scale(full_scale, like: torch.Tensor) -> torch.Tensor:
    fs = torch.as_tensor(full_scale, dtype=torch.float32, device=like.device)
    return torch.clamp_min(fs, 1.0)


def _quotient(a: float, b: torch.Tensor) -> torch.Tensor:
    """The IEEE quotient ``a / b`` of a float by a tensor: torch evaluates
    ``float / tensor`` as ``reciprocal(tensor) * float``, so the numerator
    is made a tensor."""
    return torch.full_like(b, a) / b


def adc_convert(p: torch.Tensor, full_scale, adc_bits: int = 8,
                sigma_lsb: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Analog column value ``p`` -> integer ADC code in ``[0, 2^bits - 1]``."""
    cmax = float(adc_codes(adc_bits) - 1)
    fs = _full_scale(full_scale, p)
    x = torch.minimum(torch.clamp_min(p.to(torch.float32), 0.0), fs) \
        * _quotient(cmax, fs)
    if sigma_lsb:
        if generator is not None:
            x = x + sigma_lsb * torch.randn(x.shape, generator=generator,
                                            device=x.device)
        else:
            _warn_keyless_noise(sigma_lsb, "adc_convert")
    codes = torch.clamp(torch.round(x), 0.0, cmax)
    san = _san_active()
    if san is not None:
        # saturation-rate counter: codes pinned to the top code mean the
        # charge-share range clipped (sanitizer contract)
        san.observe_adc(codes, cmax)
    return codes


def adc_reconstruct(code: torch.Tensor, full_scale, adc_bits: int = 8
                    ) -> torch.Tensor:
    """ADC code -> reconstructed (integer) popcount estimate ``p_hat``."""
    cmax = float(adc_codes(adc_bits) - 1)
    fs = _full_scale(full_scale, code)
    return torch.round(code * (fs / cmax))


def adc_quantize_sum(p: torch.Tensor, full_scale, adc_bits: int = 8,
                     sigma_lsb: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Convert then reconstruct: the quantization the ADC imposes on ``p``
    (identity for integer ``p`` whenever ``full_scale <= 2^adc_bits - 1``)."""
    code = adc_convert(p, full_scale, adc_bits, sigma_lsb, generator)
    return adc_reconstruct(code, full_scale, adc_bits)


def abn_binarize(p: torch.Tensor, threshold_code, full_scale,
                 dac_bits: int = 6, sigma_lsb: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Analog Batch-Norm: compare the column value against a 6-b DAC
    reference and return {-1, +1} (the BNN activation).
    ``threshold_code`` indexes the DAC's ``2^dac_bits`` levels spanning
    the column full scale; the noise is ``sigma_lsb`` ADC LSBs
    (``fs / 255`` each)."""
    dmax = float(2 ** dac_bits - 1)
    fs = _full_scale(full_scale, p)
    thresh = torch.as_tensor(threshold_code, dtype=torch.float32,
                             device=p.device) * (fs / torch.full_like(fs, dmax))
    x = p.to(torch.float32)
    if sigma_lsb:
        if generator is not None:
            lsb = fs / torch.full_like(fs, 255.0)
            x = x + sigma_lsb * lsb * torch.randn(
                x.shape, generator=generator, device=x.device)
        else:
            _warn_keyless_noise(sigma_lsb, "abn_binarize")
    return torch.where(x >= thresh, 1.0, -1.0)


def abn_threshold_code(threshold_p, full_scale, dac_bits: int = 6
                       ) -> torch.Tensor:
    """Quantize a desired popcount threshold onto the 6-b DAC grid."""
    dmax = float(2 ** dac_bits - 1)
    tp = torch.as_tensor(threshold_p, dtype=torch.float32)
    fs = _full_scale(full_scale, tp)
    return torch.clamp(torch.round(tp * _quotient(dmax, fs)), 0.0, dmax)
