"""Conducting materials (mirrors).

Counterparts of raysect/optical/material/conductor.pyx
(Conductor:39, RoughConductor:159). Spectra slot 0 = n(lambda), slot 1 =
k(lambda); the wavefront kernel evaluates the conducting Fresnel equations
per bin and, for the rough variant, Cook-Torrance GGX + Smith shadowing.
"""

from __future__ import annotations

import numpy as np

from .base import MAT_CONDUCTOR, MAT_ROUGH_CONDUCTOR, NPARAMS, NSLOTS, Material

__all__ = ["Conductor", "RoughConductor"]


class Conductor(Material):

    MAT_TYPE = MAT_CONDUCTOR

    def __init__(self, index, extinction):
        super().__init__()
        self.index = index
        self.extinction = extinction

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = self.index.sample(min_wavelength, max_wavelength, bins)
        out[1] = self.extinction.sample(min_wavelength, max_wavelength, bins)
        return out


class RoughConductor(Conductor):
    """Cook-Torrance microfacet conductor, GGX distribution
    (conductor.pyx:159-339). params[0] = roughness in (0, 1]."""

    MAT_TYPE = MAT_ROUGH_CONDUCTOR

    def __init__(self, index, extinction, roughness):
        super().__init__(index, extinction)
        self.roughness = roughness

    @property
    def roughness(self):
        return self._roughness

    @roughness.setter
    def roughness(self, value):
        if not 0 < value <= 1:
            raise ValueError("Roughness must lie in the range (0, 1].")
        self._roughness = float(value)

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = self._roughness
        return p
