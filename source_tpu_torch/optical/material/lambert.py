"""Lambertian diffuse surface.

Counterpart of raysect/optical/material/lambert.pyx:40. Spectra
slot 0 carries the reflectivity curve; the wavefront kernel implements the
cosine-hemisphere sampling + one-sample MIS estimator of the reference's
ContinuousBSDF base (material.pyx:327-352, lambert.pyx:71-106).
"""

from __future__ import annotations

import numpy as np

from ..spectrum import ConstantSF
from .base import MAT_LAMBERT, NSLOTS, Material

__all__ = ["Lambert"]


class Lambert(Material):

    MAT_TYPE = MAT_LAMBERT

    def __init__(self, reflectivity=None):
        super().__init__()
        self.reflectivity = reflectivity if reflectivity is not None else ConstantSF(0.5)

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = self.reflectivity.sample(min_wavelength, max_wavelength, bins)
        return out
