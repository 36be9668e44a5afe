"""Frame samplers: full-frame and adaptive task generation.

Counterparts of the reference's optical/observer/samplers.py
(raysect/optical/observer/{sampler1d,sampler2d}.pyx). Task generation is
host numpy between render passes: the adaptive samplers re-tile from the
error frame of the previous pass.
"""

from __future__ import annotations

import numpy as np

from .base import FrameSampler1D, FrameSampler2D

__all__ = [
    "FullFrameSampler1D",
    "FullFrameSampler2D",
    "MonoAdaptiveSampler1D",
    "MonoAdaptiveSampler2D",
    "MaskedMonoAdaptiveSampler2D",
    "RGBAdaptiveSampler2D",
    "MaskedRGBAdaptiveSampler2D",
    "SpectralAdaptiveSampler1D",
    "SpectralAdaptiveSampler2D",
]


def _shuffled(tasks):
    tasks = np.asarray(tasks)
    if tasks.shape[0]:
        np.random.shuffle(tasks)
    return [tuple(t) for t in tasks]


class FullFrameSampler2D(FrameSampler2D):
    """Every pixel, every pass (sampler2d.pyx:42)."""

    def __init__(self, mask=None):
        self.mask = None if mask is None else np.asarray(mask, bool)

    def generate_tasks(self, pixels):
        nx, ny = pixels
        xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        tasks = np.stack([xs.ravel(), ys.ravel()], axis=1)
        if self.mask is not None:
            tasks = tasks[self.mask[tasks[:, 0], tasks[:, 1]]]
        return _shuffled(tasks)


class FullFrameSampler1D(FrameSampler1D):
    """Every pixel, every pass (sampler1d.pyx:40)."""

    def generate_tasks(self, pixels):
        (n,) = pixels if isinstance(pixels, tuple) else (pixels,)
        return [(int(i),) for i in np.random.permutation(n)]


class _AdaptiveBase:
    """Shared adaptive machinery (sampler2d.pyx:105-296 semantics):

      min_samples = max(min_samples, max_samples / ratio)
      normalised error = stderr / mean (per pixel, max over channels)
      cutoff = max(cutoff, percentile(normalised, 1 - fraction))
      task if samples < min_samples or normalised > cutoff
    """

    def __init__(self, fraction=0.2, ratio=10.0, min_samples=1000, cutoff=0.0,
                 mask=None):
        if not 0 < fraction <= 1:
            raise ValueError("Attribute 'fraction' must be in the range (0, 1].")
        if ratio < 1:
            raise ValueError("Attribute 'ratio' must be >= 1.")
        if min_samples < 1:
            raise ValueError("Attribute 'min_samples' must be >= 1.")
        if not 0 <= cutoff <= 1:
            raise ValueError("Attribute 'cutoff' must be in the range [0, 1].")
        self.fraction = float(fraction)
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self.cutoff = float(cutoff)
        self.mask = None if mask is None else np.asarray(mask, bool)

    def _frame_stats(self):
        """Return (mean, errors, samples) arrays with a trailing channel axis."""
        raise NotImplementedError

    def _adaptive_tasks(self, pixels):
        stats = self._frame_stats()
        if stats is None:
            return None
        mean, errors, samples = stats
        shape = mean.shape[:-1]
        if tuple(shape) != tuple(pixels):
            return None
        mask = self.mask if self.mask is not None else np.ones(shape, bool)
        if mask.shape != tuple(shape):
            raise ValueError(
                "The pixel geometry passed to the frame sampler is inconsistent "
                "with the mask shape."
            )
        if samples[mask].max() == 0:
            return None  # nothing rendered yet

        min_samples = max(self.min_samples, int(samples[mask].max() / self.ratio))
        with np.errstate(divide="ignore", invalid="ignore"):
            normalised = np.where(mean > 0, errors / mean, 0.0)
        normalised = normalised.max(axis=-1)
        percentile_error = np.percentile(normalised[mask], (1 - self.fraction) * 100)
        cutoff = max(self.cutoff, percentile_error)
        min_pixel_samples = samples.min(axis=-1)
        select = mask & (
            (min_pixel_samples < min_samples) | (normalised > cutoff)
        )
        idx = np.argwhere(select)
        return _shuffled(idx)

    def generate_tasks(self, pixels):
        tasks = self._adaptive_tasks(pixels)
        if tasks is None:
            # no frame data yet: full frame
            if len(pixels) == 2:
                return FullFrameSampler2D(self.mask).generate_tasks(pixels)
            return FullFrameSampler1D().generate_tasks(pixels)
        return tasks


class MonoAdaptiveSampler2D(_AdaptiveBase, FrameSampler2D):
    """Adaptive sampling driven by a Power/Radiance pipeline's noise
    (sampler2d.pyx:105)."""

    def __init__(self, pipeline, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0, mask=None):
        super().__init__(fraction, ratio, min_samples, cutoff, mask)
        self.pipeline = pipeline

    def _frame_stats(self):
        frame = getattr(self.pipeline, "frame", None)
        if frame is None or not hasattr(frame, "mean"):
            return None
        return (
            frame.mean[..., None],
            frame.errors()[..., None],
            frame.samples[..., None],
        )


class MaskedMonoAdaptiveSampler2D(MonoAdaptiveSampler2D):
    """Masked variant (sampler2d.pyx:298)."""

    def __init__(self, pipeline, mask, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0):
        super().__init__(pipeline, fraction, ratio, min_samples, cutoff, mask)


class RGBAdaptiveSampler2D(_AdaptiveBase, FrameSampler2D):
    """Adaptive sampling driven by an RGBPipeline2D's XYZ noise
    (sampler2d.pyx:697)."""

    def __init__(self, pipeline, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0, mask=None):
        super().__init__(fraction, ratio, min_samples, cutoff, mask)
        self.pipeline = pipeline

    def _frame_stats(self):
        frame = getattr(self.pipeline, "xyz_frame", None)
        if frame is None:
            return None
        return frame.mean, frame.errors(), frame.samples


class MaskedRGBAdaptiveSampler2D(RGBAdaptiveSampler2D):
    """Masked variant (sampler2d.pyx:897)."""

    def __init__(self, pipeline, mask, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0):
        super().__init__(pipeline, fraction, ratio, min_samples, cutoff, mask)


class SpectralAdaptiveSampler2D(_AdaptiveBase, FrameSampler2D):
    """Adaptive sampling from a spectral pipeline's per-bin noise
    (sampler2d.pyx:325)."""

    def __init__(self, pipeline, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0, mask=None):
        super().__init__(fraction, ratio, min_samples, cutoff, mask)
        self.pipeline = pipeline

    def _frame_stats(self):
        frame = getattr(self.pipeline, "frame", None)
        if frame is None or not hasattr(frame, "mean"):
            return None
        # frame dims: (nx, ny, bins) — bins act as channels
        return frame.mean, frame.errors(), frame.samples


class MonoAdaptiveSampler1D(_AdaptiveBase, FrameSampler1D):
    """1D adaptive sampler (sampler1d.pyx:58)."""

    def __init__(self, pipeline, fraction=0.2, ratio=10.0, min_samples=1000,
                 cutoff=0.0):
        super().__init__(fraction, ratio, min_samples, cutoff)
        self.pipeline = pipeline

    def _frame_stats(self):
        frame = getattr(self.pipeline, "frame", None)
        if frame is None or not hasattr(frame, "mean"):
            return None
        return (
            frame.mean[..., None],
            frame.errors()[..., None],
            frame.samples[..., None],
        )

    def generate_tasks(self, pixels):
        pixels = pixels if isinstance(pixels, tuple) else (pixels,)
        return super().generate_tasks(pixels)


class SpectralAdaptiveSampler1D(MonoAdaptiveSampler1D):
    """1D spectral adaptive sampler (sampler1d.pyx:209)."""

    def _frame_stats(self):
        frame = getattr(self.pipeline, "frame", None)
        if frame is None or not hasattr(frame, "mean"):
            return None
        return frame.mean, frame.errors(), frame.samples
