"""Spectra and spectral functions.

Re-design of raysect/optical/{spectrum,spectralfunction}.pyx.

``Spectrum`` keeps the reference's binning convention exactly: ``bins``
equal-width bins over [min_wavelength, max_wavelength) with bin-centre
wavelengths ``min + (i + 0.5) * delta`` (spectrum.pyx:132-181). Its samples
are a HOST numpy float64 array (the reference's Spectrum is float64 numpy
too) so per-sample host folding — the PixelProcessor path — never pays a
device sync; in the wavefront tracer whole *batches* of spectra are
tensors of shape [rays, bins] — the class is the host-facing wrapper only.

``SpectralFunction`` and subclasses mirror spectralfunction.pyx:44-529. Their
``sample()`` output feeds the scene compiler, which bakes every material
curve onto the render's wavelength grid.
"""

from __future__ import annotations

import numpy as np

from ..core.math import interp as _interp

__all__ = [
    "Spectrum",
    "SpectralFunction",
    "InterpolatedSF",
    "ConstantSF",
    "NumericallyIntegratedSF",
    "photon_energy",
]

# physical constants (CODATA)
SPEED_OF_LIGHT = 299792458.0
PLANCK_CONSTANT = 6.62607015e-34
ELEMENTARY_CHARGE = 1.602176634e-19


def photon_energy(wavelength):
    """Energy of a photon in J for wavelength in nm (spectrum.pyx:553)."""
    return PLANCK_CONSTANT * SPEED_OF_LIGHT / (wavelength * 1e-9)


def wavelength_grid(min_wavelength, max_wavelength, bins, dtype=np.float64):
    """Bin-centre wavelengths (spectrum.pyx:181 convention). Host numpy —
    device code builds its grid inside compile_scene."""
    delta = (max_wavelength - min_wavelength) / bins
    return min_wavelength + (np.arange(bins, dtype=dtype) + 0.5) * delta


class Spectrum:
    """A binned radiance spectrum over [min_wavelength, max_wavelength)
    (spectrum.pyx:43). Samples in W/m2/str/nm."""

    def __init__(self, min_wavelength, max_wavelength, bins, samples=None):
        if min_wavelength <= 0 or max_wavelength <= 0:
            raise ValueError("Wavelength must be greater than zero.")
        if min_wavelength >= max_wavelength:
            raise ValueError("Minimum wavelength must be less than the maximum.")
        if bins < 1:
            raise ValueError("Number of bins must be >= 1.")
        self.min_wavelength = float(min_wavelength)
        self.max_wavelength = float(max_wavelength)
        self.bins = int(bins)
        self.delta_wavelength = (self.max_wavelength - self.min_wavelength) / self.bins
        if samples is None:
            self.samples = np.zeros(self.bins, dtype=np.float64)
        else:
            samples = np.asarray(samples, dtype=np.float64)
            if samples.shape != (self.bins,):
                raise ValueError("Sample array must have shape (bins,).")
            self.samples = samples
        self._wavelengths = None

    @property
    def wavelengths(self):
        if self._wavelengths is None:
            self._wavelengths = wavelength_grid(
                self.min_wavelength, self.max_wavelength, self.bins
            )
        return self._wavelengths

    def is_compatible(self, min_wavelength, max_wavelength, bins):
        """Spectral-config equality check (spectrum.pyx:183)."""
        return (
            self.min_wavelength == min_wavelength
            and self.max_wavelength == max_wavelength
            and self.bins == bins
        )

    def new_spectrum(self):
        return Spectrum(self.min_wavelength, self.max_wavelength, self.bins)

    def copy(self):
        return Spectrum(
            self.min_wavelength, self.max_wavelength, self.bins, self.samples
        )

    def clear(self):
        self.samples = np.zeros_like(self.samples)

    def is_zero(self):
        return bool(np.all(self.samples == 0.0))

    def total(self):
        """Total radiance, W/m2/str (spectrum.pyx total())."""
        return float(np.sum(self.samples) * self.delta_wavelength)

    def average(self, min_wavelength=None, max_wavelength=None):
        """Mean spectral radiance over the range (spectrum.pyx:202)."""
        lo = self.min_wavelength if min_wavelength is None else min_wavelength
        hi = self.max_wavelength if max_wavelength is None else max_wavelength
        if lo == self.min_wavelength and hi == self.max_wavelength:
            return float(self.samples.mean())
        return float(
            _interp.average(self.wavelengths, self.samples, lo, hi)
        )

    def integrate(self, min_wavelength=None, max_wavelength=None):
        """Integrated radiance over the range (spectrum.pyx:240).

        Full-range fast path: the integral of the bin-centre piecewise-
        linear interpolant with constant end extrapolation over exactly
        [min_wavelength, max_wavelength] telescopes to sum(samples)*delta —
        the reference's total() identity (spectrum.pyx:306) — so the hot
        PixelProcessor call costs one numpy reduction."""
        lo = self.min_wavelength if min_wavelength is None else min_wavelength
        hi = self.max_wavelength if max_wavelength is None else max_wavelength
        if lo == self.min_wavelength and hi == self.max_wavelength:
            return float(self.samples.sum() * self.delta_wavelength)
        return float(_interp.integrate(self.wavelengths, self.samples, lo, hi))

    def sample(self, min_wavelength, max_wavelength, bins):
        """Resample onto a new spectral configuration (spectrum.pyx:260)."""
        return np.asarray(
            _interp.sample_bins(
                self.wavelengths, self.samples, min_wavelength, max_wavelength, bins
            )
        )

    def to_photons(self):
        """Convert radiance to photons/s/m2/str/nm (spectrum.pyx:360)."""
        return np.asarray(self.samples / photon_energy(self.wavelengths))

    # in-place spectral arithmetic (reference spectrum.pyx:428-550)
    def add_scalar(self, v):
        self.samples = self.samples + v

    def sub_scalar(self, v):
        self.samples = self.samples - v

    def mul_scalar(self, v):
        self.samples = self.samples * v

    def div_scalar(self, v):
        self.samples = self.samples / v

    def add_array(self, a):
        self.samples = self.samples + np.asarray(a)

    def sub_array(self, a):
        self.samples = self.samples - np.asarray(a)

    def mul_array(self, a):
        self.samples = self.samples * np.asarray(a)

    def div_array(self, a):
        self.samples = self.samples / np.asarray(a)

    def mad_scalar(self, scalar, array):
        self.samples = self.samples + scalar * np.asarray(array)

    def mad_array(self, a, b):
        self.samples = self.samples + np.asarray(a) * np.asarray(b)

    def __getstate__(self):
        return (
            self.min_wavelength,
            self.max_wavelength,
            self.bins,
            np.asarray(self.samples),
        )

    def __setstate__(self, state):
        mn, mx, b, s = state
        self.__init__(mn, mx, b, s)


class SpectralFunction:
    """Abstract spectral curve (spectralfunction.pyx:44).

    Subclasses implement evaluate/integrate; ``sample`` averages over equal
    bins and caches the result (the reference's single-slot cache,
    spectralfunction.pyx:80-140).
    """

    def __init__(self):
        self._cache_key = None
        self._cache_samples = None

    def __call__(self, wavelength):
        return self.evaluate(wavelength)

    def evaluate(self, wavelength):
        raise NotImplementedError

    def integrate(self, min_wavelength, max_wavelength):
        raise NotImplementedError

    def average(self, min_wavelength, max_wavelength):
        return self.integrate(min_wavelength, max_wavelength) / (
            max_wavelength - min_wavelength
        )

    def sample(self, min_wavelength, max_wavelength, bins):
        key = (float(min_wavelength), float(max_wavelength), int(bins))
        if self._cache_key == key and self._cache_samples is not None:
            return self._cache_samples
        edges = np.linspace(min_wavelength, max_wavelength, bins + 1)
        delta = (max_wavelength - min_wavelength) / bins
        samples = np.array(
            [self.integrate(edges[i], edges[i + 1]) / delta for i in range(bins)],
            dtype=np.float64,
        )
        self._cache_key = key
        self._cache_samples = samples
        return samples


class InterpolatedSF(SpectralFunction):
    """Linearly interpolated spectral function with nearest-neighbour end
    extrapolation (spectralfunction.pyx:416)."""

    def __init__(self, wavelengths, samples, normalise=False):
        super().__init__()
        self.wavelengths = np.asarray(wavelengths, dtype=np.float64)
        self.samples = np.asarray(samples, dtype=np.float64)
        if self.wavelengths.ndim != 1:
            raise ValueError("Wavelength array must be 1D.")
        if self.samples.shape[0] != self.wavelengths.shape[0]:
            raise ValueError("Wavelength and sample arrays must be the same length.")
        order = np.argsort(self.wavelengths)
        self.wavelengths = self.wavelengths[order]
        self.samples = self.samples[order]
        if normalise:
            self.samples = self.samples / self.integrate(
                self.wavelengths.min(), self.wavelengths.max()
            )

    def evaluate(self, wavelength):
        return float(np.interp(wavelength, self.wavelengths, self.samples))

    def integrate(self, min_wavelength, max_wavelength):
        return float(
            _interp.integrate(
                self.wavelengths,
                self.samples,
                min_wavelength,
                max_wavelength,
            )
        )

    def sample(self, min_wavelength, max_wavelength, bins):
        key = (float(min_wavelength), float(max_wavelength), int(bins))
        if self._cache_key == key and self._cache_samples is not None:
            return self._cache_samples
        samples = np.asarray(
            _interp.sample_bins(
                self.wavelengths,
                self.samples,
                min_wavelength,
                max_wavelength,
                bins,
            ),
            dtype=np.float64,
        )
        self._cache_key = key
        self._cache_samples = samples
        return samples


class ConstantSF(SpectralFunction):
    """Wavelength-independent value (spectralfunction.pyx:509)."""

    def __init__(self, value):
        super().__init__()
        self.value = float(value)

    def evaluate(self, wavelength):
        return self.value

    def integrate(self, min_wavelength, max_wavelength):
        return self.value * (max_wavelength - min_wavelength)

    def sample(self, min_wavelength, max_wavelength, bins):
        return np.full(bins, self.value, dtype=np.float64)


class NumericallyIntegratedSF(SpectralFunction):
    """Spectral function defined by a python function f(wavelength),
    trapezoidally integrated at fixed resolution
    (spectralfunction.pyx:330-415)."""

    def __init__(self, sample_resolution=1.0):
        super().__init__()
        if sample_resolution <= 0:
            raise ValueError("Sampling resolution must be greater than zero.")
        self.sample_resolution = float(sample_resolution)

    def function(self, wavelength):
        raise NotImplementedError

    def evaluate(self, wavelength):
        return float(self.function(wavelength))

    def integrate(self, min_wavelength, max_wavelength):
        if max_wavelength <= min_wavelength:
            return 0.0
        n = max(2, int(np.ceil((max_wavelength - min_wavelength) / self.sample_resolution)) + 1)
        w = np.linspace(min_wavelength, max_wavelength, n)
        f = np.array([self.function(x) for x in w], dtype=np.float64)
        return float(np.trapezoid(f, w))
