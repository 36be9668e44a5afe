"""Surface and volume emitters.

Counterparts of raysect/optical/material/emitter/{uniform,unity,
anisotropic,checkerboard,homogeneous,inhomogeneous}.pyx. Surface emitters
terminate the path and add ``throughput x emission``; volume emitters
contribute along containing segments in the wavefront volume stage.
"""

from __future__ import annotations

import numpy as np

from ..spectrum import ConstantSF
from .base import (
    MAT_CHECKERBOARD,
    MAT_EMITTER,
    MAT_EMITTER_ANISO,
    NPARAMS,
    NSLOTS,
    Material,
    NullSurface,
    VOL_HOMOGENEOUS,
    VOL_INHOMOGENEOUS,
)

__all__ = [
    "UniformSurfaceEmitter",
    "UnitySurfaceEmitter",
    "AnisotropicSurfaceEmitter",
    "Checkerboard",
    "HomogeneousVolumeEmitter",
    "UniformVolumeEmitter",
    "UnityVolumeEmitter",
    "InhomogeneousVolumeEmitter",
    "VolumeIntegrator",
    "NumericalIntegrator",
]


class UniformSurfaceEmitter(Material):
    """Uniform, isotropic surface emitter (emitter/uniform.pyx:36).

    Spectra slot 0 = emission_spectrum x scale, W/m2/str/nm.
    """

    MAT_TYPE = MAT_EMITTER

    def __init__(self, emission_spectrum, scale=1.0):
        super().__init__()
        self.emission_spectrum = emission_spectrum
        self.scale = float(scale)
        self.importance = 1.0  # emitters are important by default (uniform.pyx:62)

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = (
            np.asarray(self.emission_spectrum.sample(min_wavelength, max_wavelength, bins))
            * self.scale
        )
        return out


class UnitySurfaceEmitter(UniformSurfaceEmitter):
    """Emits 1 W/m2/str/nm in every bin (emitter/unity.pyx:37) — the
    analytic-validation workhorse (demos/accuracy)."""

    def __init__(self):
        super().__init__(ConstantSF(1.0), 1.0)


class AnisotropicSurfaceEmitter(Material):
    """Cosine-power anisotropic surface emitter (emitter/anisotropic.pyx:37).

    emission(theta) = spectrum x scale x cos(theta)^power, with theta the
    angle to the surface normal. params[0] = cosine power.
    """

    MAT_TYPE = MAT_EMITTER_ANISO

    def __init__(self, emission_spectrum, scale=1.0, cosine_power=1.0):
        super().__init__()
        self.emission_spectrum = emission_spectrum
        self.scale = float(scale)
        self.cosine_power = float(cosine_power)
        self.importance = 1.0  # anisotropic.pyx:49

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = self.cosine_power
        return p

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = (
            np.asarray(self.emission_spectrum.sample(min_wavelength, max_wavelength, bins))
            * self.scale
        )
        return out


class Checkerboard(Material):
    """Two-spectrum checkerboard emitter test pattern
    (emitter/checkerboard.pyx:39). params[0] = grid width; slots 0/1 the two
    emission spectra."""

    MAT_TYPE = MAT_CHECKERBOARD

    def __init__(self, width=1.0, emission_spectrum1=None, emission_spectrum2=None,
                 scale1=1.0, scale2=1.0):
        super().__init__()
        self.width = float(width)
        self.emission_spectrum1 = emission_spectrum1 or ConstantSF(1.0)
        self.emission_spectrum2 = emission_spectrum2 or ConstantSF(1.0)
        self.scale1 = float(scale1)
        self.scale2 = float(scale2)
        self.importance = 1.0  # checkerboard.pyx:76

    def compile_params(self):
        p = np.zeros(NPARAMS, dtype=np.float64)
        p[0] = self.width
        return p

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = (
            np.asarray(self.emission_spectrum1.sample(min_wavelength, max_wavelength, bins))
            * self.scale1
        )
        out[1] = (
            np.asarray(self.emission_spectrum2.sample(min_wavelength, max_wavelength, bins))
            * self.scale2
        )
        return out


class HomogeneousVolumeEmitter(NullSurface):
    """Homogeneous volume emitter: pass-through surface, constant volume
    emission per unit length (emitter/homogeneous.pyx:36). Spectra slot 0 =
    emission density, W/m3/str/nm."""

    VOLUME_KIND = VOL_HOMOGENEOUS

    def __init__(self, emission_function=None, scale=1.0):
        super().__init__()
        self.emission_function = emission_function or ConstantSF(1.0)
        self.scale = float(scale)
        self.importance = 1.0  # homogeneous.pyx:48

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins), dtype=np.float64)
        out[0] = (
            np.asarray(self.emission_function.sample(min_wavelength, max_wavelength, bins))
            * self.scale
        )
        return out


class UniformVolumeEmitter(HomogeneousVolumeEmitter):
    """Alias matching the reference's UniformVolumeEmitter (uniform.pyx:91)."""


class UnityVolumeEmitter(HomogeneousVolumeEmitter):
    """Emits 1 W/m3/str/nm everywhere (emitter/unity.pyx)."""

    def __init__(self):
        super().__init__(ConstantSF(1.0), 1.0)


class VolumeIntegrator:
    """Volume integration strategy base (emitter/inhomogeneous.pyx:40)."""


class NumericalIntegrator(VolumeIntegrator):
    """Fixed-resolution ray march (emitter/inhomogeneous.pyx:108-177).

    The reference adapts sample count to ``step``; under jit the count must
    be static, so ``max_samples`` midpoint-rule samples span each traversed
    segment (step is kept for API parity and conservative accuracy checks).
    """

    def __init__(self, step=0.01, min_samples=5, max_samples=32):
        if step <= 0:
            raise ValueError("step must be positive.")
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2.")
        self.step = float(step)
        self.min_samples = int(min_samples)
        self.max_samples = int(max_samples)


class InhomogeneousVolumeEmitter(NullSurface):
    """Spatially varying volume emitter (emitter/inhomogeneous.pyx:40).

    ``emission_function(p_local, direction_local, wavelengths)`` is a
    tensor-valued closure returning spectral emission density
    (W/m3/str/nm) with shape [..., bins]; it is evaluated at
    ``integrator.max_samples`` points along every traversed in-volume
    segment, in the primitive's local frame (optionally offset by a
    wrapping VolumeTransform).
    """

    VOLUME_KIND = VOL_INHOMOGENEOUS

    def __init__(self, emission_function, integrator=None):
        super().__init__()
        if not callable(emission_function):
            raise TypeError("emission_function must be callable.")
        self.emission_function = emission_function
        self.integrator = integrator or NumericalIntegrator()
        self.importance = 1.0
