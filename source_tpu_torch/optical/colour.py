"""Reference spectra for colour work (reference raysect/optical/colour.pyx).

Only the CIE D65 illuminant is carried so far."""

from __future__ import annotations

import numpy as np

from .spectrum import InterpolatedSF

__all__ = ["d65_white"]

# CIE D65 standard illuminant, 10 nm tabulation (standard public data),
# normalised like the reference d65_white (colour.pyx:118) so its *mean*
# over the visual range 375-785 nm is ~1.
_D65_W = np.arange(380.0, 790.0, 10.0)
_D65_S = np.array([
    49.98, 54.65, 82.75, 91.49, 93.43, 86.68, 104.86, 117.01, 117.81,
    114.86, 115.92, 108.81, 109.35, 107.80, 104.79, 104.41, 100.00,
    96.33, 95.79, 88.69, 90.01, 89.60, 87.70, 83.29, 83.70, 80.03,
    80.21, 82.28, 78.28, 69.72, 71.61, 74.35, 61.60, 69.89, 75.09,
    63.59, 46.42, 66.81, 63.38, 64.30, 59.45,
])
d65_white = InterpolatedSF(_D65_W, _D65_S / 87.1971)
