"""Observer pipelines.

Counterpart of the reference's optical/observer/pipelines.py (a redesign of
raysect/optical/observer/pipeline/{rgb,bayer,mono/power,mono/radiance,
spectral/power,spectral/radiance}.pyx). Each pipeline has a device side,
``project``: the per-sample spectra of a whole pixel tile to channel
values, as f32 tensor arithmetic on the observer's device; and a host side:
numpy StatsArray frames with the reference's accumulate, display and save
semantics, into which the observer folds the per-pixel statistics with
Welford merges (statsarray.pyx combine_samples).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.math.statsarray import StatsArray1D, StatsArray2D, StatsArray3D, StatsBin
from ..colour import ciexyz_to_srgb, resample_ciexyz
from ..spectrum import Spectrum
from .base import Pipeline, Pipeline0D, Pipeline1D, Pipeline2D

__all__ = [
    "RGBPipeline2D",
    "BayerPipeline2D",
    "PowerPipeline0D",
    "PowerPipeline1D",
    "PowerPipeline2D",
    "RadiancePipeline0D",
    "RadiancePipeline1D",
    "RadiancePipeline2D",
    "SpectralPowerPipeline0D",
    "SpectralPowerPipeline1D",
    "SpectralPowerPipeline2D",
    "SpectralRadiancePipeline0D",
    "SpectralRadiancePipeline1D",
    "SpectralRadiancePipeline2D",
]


def _delta(slice_):
    return torch.tensor((slice_.max_wavelength - slice_.min_wavelength)
                        / slice_.bins, dtype=torch.float32)


def _sampled(fn, slice_):
    """A spectral function's per-bin samples over the slice, f32."""
    return torch.as_tensor(
        np.asarray(fn.sample(slice_.min_wavelength, slice_.max_wavelength,
                             slice_.bins)), dtype=torch.float32)


class _FrameMixin:
    """StatsArray frame plumbing shared by the pipelines."""

    def _make_frame(self, shape, channels):
        dims = tuple(shape) + ((channels,) if channels > 1 else ())
        if len(dims) == 0:
            return StatsBin()
        if len(dims) == 1:
            return StatsArray1D(dims[0])
        if len(dims) == 2:
            return StatsArray2D(*dims)
        if len(dims) == 3:
            return StatsArray3D(*dims)
        raise ValueError("Unsupported frame dimensionality.")

    def _fold(self, frame, channels, pixel_ids, mean, m2, n):
        """Merge per-pixel (mean, m2, n) channel statistics into the frame."""
        if isinstance(frame, StatsBin):
            # 0D observer: one pixel, one channel
            for i in range(mean.shape[0]):
                frame.combine_samples(float(mean[i, 0]),
                                      float(m2[i, 0] / max(n[i] - 1, 1)),
                                      int(n[i]))
            return
        flat_mean = frame.mean.reshape(-1, channels)
        flat_m2 = frame._m2.reshape(-1, channels)
        flat_n = frame.samples.reshape(-1, channels)
        n_a = flat_n[pixel_ids].astype(np.float64)
        n_b = np.broadcast_to(n[:, None].astype(np.float64), mean.shape)
        tot = n_a + n_b
        safe = np.maximum(tot, 1.0)
        delta = mean - flat_mean[pixel_ids]
        flat_mean[pixel_ids] = flat_mean[pixel_ids] + delta * (n_b / safe)
        flat_m2[pixel_ids] = (flat_m2[pixel_ids] + m2
                              + delta * delta * (n_a * n_b / safe))
        flat_n[pixel_ids] = tot.astype(np.int64)
        frame.mean[...] = flat_mean.reshape(frame.mean.shape)
        frame._m2[...] = flat_m2.reshape(frame._m2.shape)
        frame.samples[...] = flat_n.reshape(frame.samples.shape)
        frame._refresh_variance()

    # --- checkpoint/resume (the reference pickles pipelines mid-render,
    # e.g. demos/prism.py) ------------------------------------------------------

    def _set_frame(self, frame, pixel_shape):
        """Install a restored frame (RGBPipeline2D keeps it as xyz_frame)."""
        self.frame = frame
        self._shape = pixel_shape

    def save_state(self, path):
        """Write the accumulated statistics frame to an .npz checkpoint."""
        frame = self.frame
        if frame is None:
            raise RuntimeError("Pipeline has no frame to save (render first).")
        pixel_shape = np.asarray(self._shape if self._shape else [], np.int64)
        kind = "bin" if isinstance(frame, StatsBin) else "array"
        np.savez(path, kind=kind, mean=frame.mean, m2=frame._m2,
                 samples=frame.samples, pixel_shape=pixel_shape)

    def load_state(self, path):
        """Restore a checkpoint of save_state; later observe() passes with
        accumulate=True continue from it."""
        z = np.load(path, allow_pickle=False)
        pixel_shape = tuple(int(v) for v in z["pixel_shape"])
        if str(z["kind"]) == "bin":
            frame = StatsBin()
            frame.mean = float(z["mean"])
            frame._m2 = float(z["m2"])
            frame.samples = int(z["samples"])
            frame.variance = (
                frame._m2 / (frame.samples - 1) if frame.samples > 1 else 0.0
            )
        else:
            dims = z["mean"].shape
            frame = {1: StatsArray1D, 2: StatsArray2D, 3: StatsArray3D}[len(dims)](*dims)
            frame.mean[...] = z["mean"]
            frame._m2[...] = z["m2"]
            frame.samples[...] = z["samples"]
            frame._refresh_variance()
        self._set_frame(frame, pixel_shape)


def _peak_scaled(img, peak):
    return (np.clip(img / peak if peak > 0 else img, 0, 1) * 255 + 0.5).astype(np.uint8)


class RGBPipeline2D(Pipeline2D, _FrameMixin):
    """Spectrum -> CIE XYZ statistics frame with sRGB display and save
    (pipeline/rgb.pyx:48-533)."""

    def __init__(self, display_unsaturated_fraction=1.0, name=None, accumulate=True):
        self.name = name or "RGBPipeline2D"
        self.accumulate = accumulate
        self.display_unsaturated_fraction = display_unsaturated_fraction
        self.display_update_time = 15
        self.xyz_frame = None
        self._shape = None

    def n_channels(self, total_bins):
        return 3

    def projection_constants(self, slice_):
        cie = resample_ciexyz(slice_.min_wavelength, slice_.max_wavelength,
                              slice_.bins)
        return {"cie": cie, "delta": _delta(slice_)}

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        # [T,S,B] x [B,3] as f32 multiply-adds: geometry and radiometry stay
        # in f32, never in a reduced-precision (TF32/bf16) matmul
        xyz = (spectra[..., :, None] * consts["cie"]).sum(-2) * consts["delta"]
        return xyz * sensitivity[:, None, None]

    def initialise(self, shape, spectral_config, slices, quiet=False):
        if self.xyz_frame is None or self._shape != shape or not self.accumulate:
            self.xyz_frame = self._make_frame(shape, 3)
            self._shape = shape

    @property
    def frame(self):
        return self.xyz_frame

    def _set_frame(self, frame, pixel_shape):
        self.xyz_frame = frame
        self._shape = pixel_shape

    def update(self, pixel_ids, mean, m2, n):
        self._fold(self.xyz_frame, 3, pixel_ids, mean, m2, n)

    # --- display / save (rgb.pyx display pipeline) --------------------------------

    def _auto_exposure(self, rgb_lin):
        frac = self.display_unsaturated_fraction
        if frac >= 1.0 or rgb_lin.size == 0:
            peak = rgb_lin.max() if rgb_lin.size else 1.0
        else:
            peak = np.percentile(rgb_lin, frac * 100.0)
        return rgb_lin / peak if peak > 0 else rgb_lin

    def rgb_image(self):
        """Tone-mapped sRGB image [nx, ny, 3] in [0, 1]."""
        lin = self._auto_exposure(self.xyz_frame.mean.copy())
        return ciexyz_to_srgb(torch.as_tensor(lin, dtype=torch.float32)).numpy()

    def save(self, filename):
        """Save the current frame as a PNG (rgb.pyx save())."""
        img = (np.clip(self.rgb_image(), 0, 1) * 255 + 0.5).astype(np.uint8)
        # frame axis 0 is x, axis 1 is y (as the reference)
        _write_png(filename, np.transpose(img, (1, 0, 2)))

    def display(self):
        try:
            import matplotlib.pyplot as plt

            plt.figure()
            plt.imshow(np.transpose(self.rgb_image(), (1, 0, 2)))
            plt.title(self.name)
            plt.show()
        except Exception:
            pass


class BayerPipeline2D(Pipeline2D, _FrameMixin):
    """RGGB Bayer-mosaic pipeline (pipeline/bayer.pyx:49): one mono value
    per pixel, filtered by the mosaic pattern."""

    def __init__(self, red_filter, green_filter, blue_filter,
                 display_unsaturated_fraction=1.0, name=None, accumulate=True):
        self.name = name or "BayerPipeline2D"
        self.accumulate = accumulate
        self.display_unsaturated_fraction = display_unsaturated_fraction
        self.display_update_time = 15
        self.filters = (red_filter, green_filter, blue_filter)
        self.frame = None
        self._shape = None

    def n_channels(self, total_bins):
        return 1

    def projection_constants(self, slice_):
        filt = torch.stack([_sampled(f, slice_) for f in self.filters])  # [3, B]
        return {"filt": filt, "delta": _delta(slice_)}

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        vals = (spectra[..., None, :] * consts["filt"]).sum(-1) * consts["delta"]
        if px is None:
            mono = vals[..., 1:2]
        else:
            # RGGB: (0,0)=R (1,0)=G (0,1)=G (1,1)=B
            fidx = torch.where(
                (px % 2 == 0) & (py % 2 == 0), 0,
                torch.where((px % 2 == 1) & (py % 2 == 1), 2, 1))
            mono = torch.take_along_dim(
                vals, fidx[:, None, None].expand(-1, vals.shape[1], 1), dim=-1)
        return mono * sensitivity[:, None, None]

    def initialise(self, shape, spectral_config, slices, quiet=False):
        if self.frame is None or self._shape != shape or not self.accumulate:
            self.frame = self._make_frame(shape, 1)
            self._shape = shape

    def update(self, pixel_ids, mean, m2, n):
        self._fold(self.frame, 1, pixel_ids, mean, m2, n)

    def save(self, filename):
        img = self.frame.mean
        img8 = _peak_scaled(img, img.max() if img.size else 1.0)
        _write_png(filename, np.transpose(img8, (1, 0))[..., None].repeat(3, axis=-1))


class _MonoPipeline(Pipeline, _FrameMixin):
    """Power and Radiance pipelines (mono/power.pyx:48)."""

    _apply_sensitivity = True
    _default_name = "MonoPipeline"

    def __init__(self, filter=None, accumulate=True, name=None):
        self.name = name or self._default_name
        self.filter = filter
        self.accumulate = accumulate
        self.frame = None
        self._shape = None
        self.value = None  # 0D StatsBin
        self.display_update_time = 15
        self.display_unsaturated_fraction = 1.0

    def n_channels(self, total_bins):
        return 1

    def projection_constants(self, slice_):
        consts = {"delta": _delta(slice_)}
        if self.filter is not None:
            consts["filt"] = _sampled(self.filter, slice_)
        return consts

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        weighted = spectra * consts["filt"] if "filt" in consts else spectra
        total = weighted.sum(-1, keepdim=True) * consts["delta"]  # [T,S,1]
        if self._apply_sensitivity:
            total = total * sensitivity[:, None, None]
        return total

    def initialise(self, shape, spectral_config, slices, quiet=False):
        if len(shape) == 0:
            if self.value is None or not self.accumulate:
                self.value = StatsBin()
            self.frame = self.value
            self._shape = shape
            return
        if self.frame is None or self._shape != shape or not self.accumulate:
            self.frame = self._make_frame(shape, 1)
            self._shape = shape

    def _set_frame(self, frame, pixel_shape):
        self.frame = frame
        self._shape = pixel_shape
        if isinstance(frame, StatsBin):
            self.value = frame

    def update(self, pixel_ids, mean, m2, n):
        self._fold(self.frame, 1, pixel_ids, mean, m2, n)

    def save(self, filename):
        if isinstance(self.frame, StatsBin):
            raise RuntimeError("0D pipelines have no image to save.")
        img = self.frame.mean
        peak = (np.percentile(img, self.display_unsaturated_fraction * 100.0)
                if img.size else 1.0)
        img8 = _peak_scaled(img, peak)
        _write_png(filename, np.transpose(img8, (1, 0))[..., None].repeat(3, axis=-1))


class PowerPipeline0D(_MonoPipeline, Pipeline0D):
    """Total power W (mono/power.pyx:48)."""
    _default_name = "PowerPipeline0D"


class PowerPipeline1D(_MonoPipeline, Pipeline1D):
    _default_name = "PowerPipeline1D"


class PowerPipeline2D(_MonoPipeline, Pipeline2D):
    _default_name = "PowerPipeline2D"

    def __init__(self, filter=None, accumulate=True, display_unsaturated_fraction=1.0, name=None):
        super().__init__(filter=filter, accumulate=accumulate, name=name)
        self.display_unsaturated_fraction = display_unsaturated_fraction


class RadiancePipeline0D(_MonoPipeline, Pipeline0D):
    """Mean radiance W/m2/sr (mono/radiance.pyx:40): no sensitivity factor."""
    _apply_sensitivity = False
    _default_name = "RadiancePipeline0D"


class RadiancePipeline1D(RadiancePipeline0D, Pipeline1D):
    _default_name = "RadiancePipeline1D"


class RadiancePipeline2D(RadiancePipeline0D, Pipeline2D):
    _default_name = "RadiancePipeline2D"

    def __init__(self, filter=None, accumulate=True, display_unsaturated_fraction=1.0, name=None):
        super().__init__(filter=filter, accumulate=accumulate, name=name)
        self.display_unsaturated_fraction = display_unsaturated_fraction


class _SpectralPipeline(Pipeline, _FrameMixin):
    """Per-bin spectral statistics (spectral/power.pyx:44)."""

    _apply_sensitivity = True
    _default_name = "SpectralPipeline"

    def __init__(self, accumulate=True, name=None):
        self.name = name or self._default_name
        self.accumulate = accumulate
        self.frame = None
        self._shape = None
        self._total_bins = None
        self.min_wavelength = None
        self.max_wavelength = None
        self.display_update_time = 15

    def n_channels(self, total_bins):
        return total_bins

    def projection_constants(self, slice_):
        return {"offset": slice_.offset}

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        vals = spectra
        if self._apply_sensitivity:
            vals = vals * sensitivity[:, None, None]
        # zero-fill into the full spectral channel range at the slice offset
        T, S, b = vals.shape
        off = consts["offset"]
        out = torch.zeros((T, S, self._total_bins), dtype=vals.dtype,
                          device=vals.device)
        out[..., off:off + b] = vals
        return out

    def initialise(self, shape, spectral_config, slices, quiet=False):
        bins = spectral_config.bins
        self.min_wavelength = spectral_config.min_wavelength
        self.max_wavelength = spectral_config.max_wavelength
        if (
            self.frame is None
            or self._shape != shape
            or self._total_bins != bins
            or not self.accumulate
        ):
            self.frame = self._make_frame(tuple(shape) + (bins,), 1)
            self._shape = shape
            self._total_bins = bins

    def update(self, pixel_ids, mean, m2, n):
        # frame dims: shape + (bins,), the bins folded as the channels
        self._fold(self.frame, self._total_bins, pixel_ids, mean, m2, n)

    def _set_frame(self, frame, pixel_shape):
        self.frame = frame
        self._shape = pixel_shape
        self._total_bins = int(frame.mean.shape[-1])

    @property
    def wavelengths(self):
        if self._total_bins is None:
            return None
        delta = (self.max_wavelength - self.min_wavelength) / self._total_bins
        return self.min_wavelength + (np.arange(self._total_bins) + 0.5) * delta

    def to_spectrum(self, *idx):
        """The mean spectrum at a pixel as a Spectrum."""
        samples = self.frame.mean[idx] if idx else self.frame.mean
        return Spectrum(self.min_wavelength, self.max_wavelength,
                        self._total_bins, samples)


class SpectralPowerPipeline0D(_SpectralPipeline, Pipeline0D):
    _default_name = "SpectralPowerPipeline0D"


class SpectralPowerPipeline1D(_SpectralPipeline, Pipeline1D):
    _default_name = "SpectralPowerPipeline1D"


class SpectralPowerPipeline2D(_SpectralPipeline, Pipeline2D):
    _default_name = "SpectralPowerPipeline2D"


class SpectralRadiancePipeline0D(_SpectralPipeline, Pipeline0D):
    _apply_sensitivity = False
    _default_name = "SpectralRadiancePipeline0D"


class SpectralRadiancePipeline1D(SpectralRadiancePipeline0D, Pipeline1D):
    _default_name = "SpectralRadiancePipeline1D"


class SpectralRadiancePipeline2D(SpectralRadiancePipeline0D, Pipeline2D):
    _default_name = "SpectralRadiancePipeline2D"


def _write_png(filename, img):
    """Minimal PNG writer (RGB uint8 [H, W, 3]) on zlib, with no
    matplotlib or PIL."""
    import struct
    import zlib

    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[row].astype(np.uint8).tobytes() for row in range(h)
    )

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(str(filename), "wb") as f:
        f.write(png)
