"""Dielectric materials and the Sellmeier dispersion model.

Counterparts of raysect/optical/material/dielectric.pyx
(Sellmeier:40, Dielectric:120). The wavefront kernel consumes:
  scalars[0] = interior index averaged over the spectral slice
               (dielectric.pyx:176 — dispersion therefore requires
               spectral_rays slicing, exactly like the reference)
  scalars[1] = exterior index averaged over the slice
  params[0]  = transmission_only flag
  spectra[1] = transmission per metre (Beer-Lambert volume attenuation,
               dielectric.pyx:313-328)
"""

from __future__ import annotations

import math

import numpy as np

from ..spectrum import ConstantSF, NumericallyIntegratedSF
from .base import MAT_DIELECTRIC, NPARAMS, NSCALARS, NSLOTS, Material, VOL_BEER

__all__ = ["Sellmeier", "Dielectric"]


class Sellmeier(NumericallyIntegratedSF):
    """Three-term Sellmeier dispersion formula (dielectric.pyx:40-117).

    Coefficients use the standard convention: wavelength in micrometres.
    """

    def __init__(self, b1, b2, b3, c1, c2, c3, sample_resolution=10):
        super().__init__(sample_resolution)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.b3 = float(b3)
        self.c1 = float(c1)
        self.c2 = float(c2)
        self.c3 = float(c3)

    def function(self, wavelength):
        """Refractive index at wavelength (nm)."""
        w2 = wavelength * wavelength * 1e-6  # nm^2 -> um^2
        return math.sqrt(
            1
            + (self.b1 * w2) / (w2 - self.c1)
            + (self.b2 * w2) / (w2 - self.c2)
            + (self.b3 * w2) / (w2 - self.c3)
        )


class Dielectric(Material):
    """Ideal dielectric with Fresnel reflection/refraction path roulette and
    Beer-Lambert interior attenuation (dielectric.pyx:120-335)."""

    MAT_TYPE = MAT_DIELECTRIC
    VOLUME_KIND = VOL_BEER

    def __init__(self, index, transmission, external_index=None,
                 transmission_only=False):
        super().__init__()
        self.index = index
        self.transmission = transmission
        self.external_index = external_index if external_index is not None else ConstantSF(1.0)
        self.transmission_only = bool(transmission_only)
        self.importance = 1.0  # dielectric.pyx:150

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = 1.0 if self.transmission_only else 0.0
        return p

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = self.index.sample(min_wavelength, max_wavelength, bins)
        out[1] = self.transmission.sample(min_wavelength, max_wavelength, bins)
        return out

    def compile_scalars(self, min_wavelength, max_wavelength):
        s = np.zeros(NSCALARS, dtype=np.float64)
        s[0] = self.index.average(min_wavelength, max_wavelength)
        s[1] = self.external_index.average(min_wavelength, max_wavelength)
        return s
