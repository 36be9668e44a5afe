"""CIE colour pipeline (reference raysect/optical/colour.pyx).

The CIE 1931 2-degree colour matching functions are the multi-lobe
piecewise-Gaussian analytic fit of Wyman, Sloan & Shirley (JCGT 2013), as
in the JAX package, not the reference's 5 nm tables. They carry the
reference's normalisation (tables divided by 106.8566, so the y-bar curve
integrates to 1; colour.pyx:39-81), so radiance -> XYZ magnitudes agree.
Everything here takes and returns f32 tensors (array-likes are converted);
``spectra_to_ciexyz`` is a product in f32 written out as multiply-adds, so
no TF32 or reduced-precision matmul can touch it.
"""

from __future__ import annotations

import numpy as np
import torch

from .spectrum import InterpolatedSF, Spectrum

__all__ = [
    "ciexyz_x",
    "ciexyz_y",
    "ciexyz_z",
    "resample_ciexyz",
    "spectrum_to_ciexyz",
    "spectra_to_ciexyz",
    "ciexyy_to_ciexyz",
    "ciexyz_to_ciexyy",
    "ciexyz_to_srgb",
    "srgb_to_ciexyz",
    "srgb_transfer_function",
    "srgb_transfer_function_inverse",
    "d65_white",
]

# reference table normalisation: CIE y-bar integral over wavelength in nm
_CIE_NORM = 106.8566


def _f32(x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32)


def _gauss(w, mu, s1, s2):
    """Piecewise Gaussian with distinct left/right widths."""
    s = torch.where(w < mu, s1, s2)
    t = (w - mu) / s
    return torch.exp(-0.5 * t * t)


def cie_x_bar(w):
    """CIE 1931 x-bar CMF, analytic fit (Wyman et al. 2013, eq. 2)."""
    return (
        1.056 * _gauss(w, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(w, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(w, 501.1, 20.4, 26.2)
    )


def cie_y_bar(w):
    return (0.821 * _gauss(w, 568.8, 46.9, 40.5)
            + 0.286 * _gauss(w, 530.9, 16.3, 31.1))


def cie_z_bar(w):
    return (1.217 * _gauss(w, 437.0, 11.8, 36.0)
            + 0.681 * _gauss(w, 459.0, 26.0, 13.8))


class _AnalyticCMF:
    """SpectralFunction-like wrapper of an analytic CMF (normalised)."""

    def __init__(self, fn):
        self._fn = fn

    def evaluate(self, wavelength):
        return float(self._fn(_f32(wavelength))) / _CIE_NORM

    __call__ = evaluate

    def sample(self, min_wavelength, max_wavelength, bins):
        """Per-bin average by a 4-point midpoint rule inside each bin."""
        edges = np.linspace(min_wavelength, max_wavelength, bins + 1)
        offs = (np.arange(4) + 0.5) / 4.0
        w = edges[:-1, None] + (edges[1:] - edges[:-1])[:, None] * offs[None, :]
        vals = self._fn(_f32(w)).numpy()
        return vals.mean(axis=1) / _CIE_NORM

    def integrate(self, min_wavelength, max_wavelength):
        s = self.sample(min_wavelength, max_wavelength, 64)
        return float(s.sum() * (max_wavelength - min_wavelength) / 64)


ciexyz_x = _AnalyticCMF(cie_x_bar)
ciexyz_y = _AnalyticCMF(cie_y_bar)
ciexyz_z = _AnalyticCMF(cie_z_bar)


def resample_ciexyz(min_wavelength, max_wavelength, bins):
    """The XYZ sensitivity curves at the bin centres of a spectral grid ->
    f32 [bins, 3] (colour.pyx:123)."""
    if bins < 1:
        raise ValueError("Number of samples can not be less than 1.")
    if min_wavelength <= 0.0 or max_wavelength <= 0.0:
        raise ValueError("Wavelength can not be less than or equal to zero.")
    if min_wavelength >= max_wavelength:
        raise ValueError(
            "Minimum wavelength must be less than the maximum wavelength.")
    delta = (max_wavelength - min_wavelength) / bins
    w = torch.from_numpy(
        min_wavelength + (np.arange(bins, dtype=np.float32) + 0.5) * delta)
    xyz = torch.stack([cie_x_bar(w), cie_y_bar(w), cie_z_bar(w)], dim=-1)
    return xyz / _CIE_NORM


def spectra_to_ciexyz(samples, resampled_xyz, delta_wavelength):
    """Batched spectrum -> XYZ: samples [..., B] x resampled [B, 3] ->
    [..., 3] (colour.pyx:158), as f32 multiply-adds over the bins."""
    samples = _f32(samples)
    resampled_xyz = _f32(resampled_xyz).to(samples.device)
    return (samples[..., :, None] * resampled_xyz).sum(-2) * delta_wavelength


def spectrum_to_ciexyz(spectrum: Spectrum, resampled_xyz=None):
    """One Spectrum -> (x, y, z)."""
    if resampled_xyz is None:
        resampled_xyz = resample_ciexyz(
            spectrum.min_wavelength, spectrum.max_wavelength, spectrum.bins)
    xyz = spectra_to_ciexyz(spectrum.samples, resampled_xyz,
                            spectrum.delta_wavelength)
    return float(xyz[0]), float(xyz[1]), float(xyz[2])


def ciexyy_to_ciexyz(cx, cy, y):
    """CIE xyY -> XYZ (colour.pyx:195)."""
    return y / cy * cx, y, y / cy * (1 - cx - cy)


def ciexyz_to_ciexyy(x, y, z):
    """CIE XYZ -> xyY."""
    n = x + y + z
    return x / n, y / n, y


def srgb_transfer_function(v):
    """Linear -> gamma-encoded sRGB (colour.pyx srgb_transfer_function)."""
    v = _f32(v)
    return torch.where(
        v <= 0.0031308,
        12.92 * v,
        1.055 * torch.clamp(v, min=1e-12) ** (1.0 / 2.4) - 0.055,
    )


def srgb_transfer_function_inverse(v):
    v = _f32(v)
    return torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


# sRGB D65 matrices (IEC 61966-2-1, the coefficients of colour.pyx:235)
_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], dtype=np.float32)
_SRGB_TO_XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=np.float32)


def _apply3(m, v):
    """[3, 3] x [..., 3] -> [..., 3] as f32 multiply-adds."""
    m = torch.from_numpy(m).to(v.device)
    return (m[:, 0] * v[..., 0:1] + m[:, 1] * v[..., 1:2]
            + m[:, 2] * v[..., 2:3])


def ciexyz_to_srgb(x, y=None, z=None):
    """XYZ -> gamma-encoded sRGB, clamped to [0, 1]. Takes a batched
    [..., 3] tensor or three scalars (the reference's signature)."""
    scalar = y is not None
    xyz = (torch.stack([_f32(x), _f32(y), _f32(z)], dim=-1) if scalar
           else _f32(x))
    rgb = srgb_transfer_function(torch.clamp(_apply3(_XYZ_TO_SRGB, xyz),
                                             min=0.0))
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if scalar:
        return float(rgb[..., 0]), float(rgb[..., 1]), float(rgb[..., 2])
    return rgb


def srgb_to_ciexyz(r, g=None, b=None):
    """Gamma-encoded sRGB -> XYZ (the inverse of ciexyz_to_srgb)."""
    scalar = g is not None
    rgb = (torch.stack([_f32(r), _f32(g), _f32(b)], dim=-1) if scalar
           else _f32(r))
    xyz = _apply3(_SRGB_TO_XYZ, srgb_transfer_function_inverse(rgb))
    if scalar:
        return float(xyz[..., 0]), float(xyz[..., 1]), float(xyz[..., 2])
    return xyz


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
