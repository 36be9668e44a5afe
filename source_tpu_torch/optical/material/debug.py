"""Debug materials: Light, PerfectReflectingSurface.

Counterparts of raysect/optical/material/debug.pyx:41-143.
"""

from __future__ import annotations

import numpy as np

from .base import MAT_LIGHT, MAT_PERFECT_REFLECT, NPARAMS, NSLOTS, Material

__all__ = ["Light", "PerfectReflectingSurface"]


class Light(Material):
    """Lambertian surface lit by a distant source (debug.pyx:41):
    response = intensity * max(0, -light_direction . normal) * spectrum.

    params[0:3] = normalised world-space light direction; spectra slot 0 =
    spectrum * intensity (D65 white by default).
    """

    MAT_TYPE = MAT_LIGHT

    def __init__(self, light_direction, intensity=1.0, spectrum=None):
        super().__init__()
        d = np.asarray(
            [light_direction.x, light_direction.y, light_direction.z]
            if hasattr(light_direction, "x") else list(light_direction),
            np.float64,
        )
        norm = np.linalg.norm(d)
        if norm == 0:
            raise ValueError("light_direction cannot be a zero vector.")
        self.light_direction = d / norm
        self.intensity = max(0.0, float(intensity))
        if spectrum is None:
            raise NotImplementedError(
                "Light without a spectrum defaults to D65 white from "
                "optical/library/spectra.py, which this package does not "
                "carry yet; pass spectrum= explicitly")
        self.spectrum = spectrum

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0:3] = self.light_direction
        return p

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = (
            np.asarray(self.spectrum.sample(min_wavelength, max_wavelength, bins))
            * self.intensity
        )
        return out


class PerfectReflectingSurface(Material):
    """Lossless mirror (debug.pyx:82)."""

    MAT_TYPE = MAT_PERFECT_REFLECT
