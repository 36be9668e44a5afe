"""Standard spectra: BlackBody and named colours.

Counterparts of raysect/optical/library/spectra/{blackbody.pyx,
colours.py}. BlackBody evaluates the Planck law directly; named colours are
narrow normalised top-hats at the reference's centre wavelengths
(colours.py:48-57).
"""

from __future__ import annotations

import math

from ..spectrum import InterpolatedSF, NumericallyIntegratedSF

__all__ = [
    "BlackBody",
    "purple", "blue", "light_blue", "cyan", "green", "yellow", "orange",
    "red_orange", "red", "maroon",
]

# Planck constants
_H = 6.62607015e-34
_C = 299792458.0
_KB = 1.380649e-23


class BlackBody(NumericallyIntegratedSF):
    """Planck black-body spectral radiance, W/m2/str/nm
    (spectra/blackbody.pyx:38)."""

    def __init__(self, temperature, scale=1.0):
        if temperature <= 0:
            raise ValueError("Temperature must be greater than zero.")
        if scale <= 0:
            raise ValueError("Scale must be greater than zero.")
        super().__init__(sample_resolution=5.0)
        self.temperature = float(temperature)
        self.scale = float(scale)

    def function(self, wavelength):
        lam = wavelength * 1e-9  # nm -> m
        # spectral radiance per metre, converted to per nm (x 1e-9)
        b = (2 * _H * _C * _C) / (lam ** 5) / (
            math.exp(_H * _C / (lam * _KB * self.temperature)) - 1.0
        )
        return self.scale * b * 1e-9


def _top_hat_spectralfn(center, width, rolloff):
    """Normalised top-hat spectral function (colours.py:35-46)."""
    start = 0
    end = 1000
    half_width = width / 2
    top_min = center - half_width
    top_max = center + half_width
    base_min = top_min - rolloff
    base_max = top_max + rolloff
    return InterpolatedSF(
        [start, base_min, top_min, top_max, base_max, end],
        [0, 0, 1, 1, 0, 0],
        normalise=True,
    )


purple = _top_hat_spectralfn(423.1, 5.0, 1.0)
blue = _top_hat_spectralfn(469.2, 5.0, 1.0)
light_blue = _top_hat_spectralfn(478.8, 5.0, 1.0)
cyan = _top_hat_spectralfn(492.3, 5.0, 1.0)
green = _top_hat_spectralfn(538.5, 5.0, 1.0)
yellow = _top_hat_spectralfn(571.1, 5.0, 1.0)
orange = _top_hat_spectralfn(584.6, 5.0, 1.0)
red_orange = _top_hat_spectralfn(596.1, 5.0, 1.0)
red = _top_hat_spectralfn(630.8, 5.0, 1.0)
maroon = _top_hat_spectralfn(676.9, 5.0, 1.0)
