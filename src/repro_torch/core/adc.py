"""Per-column SAR ADC model (paper Figs. 2, 5, 10).  Port of
``repro.core.adc``.

The column popcount ``p`` in ``[0, full_scale]`` is digitized to
``2^adc_bits`` codes and reconstructed.  The operation order is the
reference's exactly — ``clip(p, 0, fs) * (cmax / fs)``, half-to-even
rounding, then ``round(code * (fs / cmax))`` — which is what makes the
grids bitwise-equal to it (and to the CUDA kernel's epilogue).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch


def adc_codes(adc_bits: int = 8) -> int:
    return 2 ** adc_bits


def _warn_keyless_noise(sigma_lsb: float, where: str) -> None:
    """A spec requested noise (``sigma_lsb > 0``) but no generator reached
    the conversion: say so loudly instead of silently running noiseless."""
    warnings.warn(
        f"{where}: adc_sigma_lsb={sigma_lsb} requested but no noise "
        "generator is in scope — running NOISELESS. Pass a torch.Generator "
        "to sample the analog non-ideality, or set adc_sigma_lsb=0 to "
        "silence this.", RuntimeWarning, stacklevel=3)


def _full_scale(full_scale, like: torch.Tensor) -> torch.Tensor:
    fs = torch.as_tensor(full_scale, dtype=torch.float32, device=like.device)
    return torch.clamp_min(fs, 1.0)


def adc_convert(p: torch.Tensor, full_scale, adc_bits: int = 8,
                sigma_lsb: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Analog column value ``p`` -> integer ADC code in ``[0, 2^bits - 1]``."""
    cmax = float(adc_codes(adc_bits) - 1)
    fs = _full_scale(full_scale, p)
    # a tensor numerator: torch evaluates ``float / tensor`` as
    # ``reciprocal(tensor) * float``, which is not the IEEE quotient
    ratio = torch.full_like(fs, cmax) / fs
    x = torch.minimum(torch.clamp_min(p.to(torch.float32), 0.0), fs) * ratio
    if sigma_lsb:
        if generator is not None:
            x = x + sigma_lsb * torch.randn(x.shape, generator=generator,
                                            device=x.device)
        else:
            _warn_keyless_noise(sigma_lsb, "adc_convert")
    return torch.clamp(torch.round(x), 0.0, cmax)


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
