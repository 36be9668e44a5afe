"""Incremental statistics (Welford mean/variance) arrays.

Counterpart of the reference's raysect/core/math/statsarray.pyx
(StatsBin:39, StatsArray1D:132, StatsArray2D:315, StatsArray3D:513).

Two halves:
  * device side: functions over ``(mean, m2, n)`` tensor triples.
    ``combine_stats`` is associative, so partial statistics merge in any
    order, and a batch of samples folds in one step instead of a loop;
  * host side: ``StatsArray{1,2,3}D`` own numpy float64 frames with the
    reference's API (mean, variance, errors(), add_sample,
    combine_samples). Observer pipelines keep their frames in them between
    render passes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "zeros_stats",
    "fold_samples",
    "combine_stats",
    "stats_error",
    "StatsBin",
    "StatsArray1D",
    "StatsArray2D",
    "StatsArray3D",
]


# --- device-side functional statistics ---------------------------------------


def zeros_stats(shape, dtype=torch.float32, device="cpu"):
    """An empty (mean, m2, n) statistics triple."""
    return tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(3))


def fold_samples(stats, sample_sum, sample_sq_sum, count):
    """Fold a batch of samples, reduced to (sum, sum of squares, count) per
    bin, into running (mean, m2, n) statistics: repeated
    StatsBin.add_sample (statsarray.pyx:64-90) as one associative merge."""
    mean = stats[0]
    cnt = torch.as_tensor(count, device=mean.device).to(mean.dtype)
    safe = torch.clamp(cnt, min=1.0)
    b_mean = sample_sum / safe
    b_m2 = torch.clamp(sample_sq_sum - cnt * b_mean * b_mean, min=0.0)
    return combine_stats(stats, (b_mean, b_m2, cnt))


def combine_stats(a, b):
    """Merge two (mean, m2, n) statistics (statsarray.pyx combine_samples).
    Associative and commutative."""
    mean_a, m2_a, n_a = a
    mean_b, m2_b, n_b = b
    n = n_a + n_b
    safe_n = torch.clamp(n, min=1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / safe_n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / safe_n)
    mean = torch.where(n > 0, mean, 0.0)
    m2 = torch.where(n > 0, m2, 0.0)
    return mean, m2, n


def stats_error(stats):
    """Standard error of the mean (statsarray.pxd error())."""
    mean, m2, n = stats
    var = torch.where(n > 1, m2 / torch.clamp(n - 1, min=1.0), 0.0)
    return torch.where(n > 0, torch.sqrt(var / torch.clamp(n, min=1.0)), 0.0)


# --- host-side classes --------------------------------------------------------


class _StatsBase:
    """Shared implementation of the host StatsArray classes."""

    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)
        self.mean = np.zeros(self.shape, dtype=np.float64)
        self.variance = np.zeros(self.shape, dtype=np.float64)
        self.samples = np.zeros(self.shape, dtype=np.int64)
        # internal m2 accumulator
        self._m2 = np.zeros(self.shape, dtype=np.float64)

    def clear(self):
        self.mean[...] = 0.0
        self.variance[...] = 0.0
        self.samples[...] = 0
        self._m2[...] = 0.0

    def _refresh_variance(self):
        with np.errstate(invalid="ignore", divide="ignore"):
            v = np.where(self.samples > 1,
                         self._m2 / np.maximum(self.samples - 1, 1), 0.0)
        self.variance[...] = v

    def errors(self):
        """Standard error of the mean per element (statsarray.pxd:65)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            e = np.where(
                self.samples > 0,
                np.sqrt(self.variance / np.maximum(self.samples, 1)),
                0.0,
            )
        return e

    def error(self, *idx):
        return float(self.errors()[idx])

    def add_sample(self, *args):
        *idx, sample = args
        idx = tuple(idx)
        n = self.samples[idx] + 1
        delta = sample - self.mean[idx]
        self.mean[idx] += delta / n
        self._m2[idx] += delta * (sample - self.mean[idx])
        self.samples[idx] = n
        self._refresh_variance()

    def combine_samples(self, *args):
        """combine_samples(*idx, mean, variance, count): merge a batch of
        statistics computed elsewhere (statsarray.pyx combine_samples)."""
        *idx, mean_b, var_b, n_b = args
        idx = tuple(idx)
        if n_b <= 0:
            return
        n_a = self.samples[idx]
        m2_b = var_b * max(n_b - 1, 0)
        n = n_a + n_b
        delta = mean_b - self.mean[idx]
        self.mean[idx] += delta * (n_b / n)
        self._m2[idx] += m2_b + delta * delta * (n_a * n_b / n)
        self.samples[idx] = n
        self._refresh_variance()

    def merge_arrays(self, mean_b, m2_b, n_b):
        """Merge whole (mean, m2, n) arrays: the device-to-host fold."""
        mean_b = np.asarray(mean_b, dtype=np.float64)
        m2_b = np.asarray(m2_b, dtype=np.float64)
        n_b = np.asarray(n_b, dtype=np.float64)
        n_a = self.samples.astype(np.float64)
        n = n_a + n_b
        safe = np.maximum(n, 1.0)
        delta = mean_b - self.mean
        self.mean += delta * (n_b / safe)
        self._m2 += m2_b + delta * delta * (n_a * n_b / safe)
        self.samples = n.astype(np.int64)
        self._refresh_variance()

    def __getstate__(self):
        return self.shape, self.mean, self.variance, self.samples, self._m2

    def __setstate__(self, state):
        self.shape, self.mean, self.variance, self.samples, self._m2 = state


class StatsBin:
    """Single-value incremental statistics (statsarray.pyx:39)."""

    def __init__(self):
        self.mean = 0.0
        self.variance = 0.0
        self.samples = 0
        self._m2 = 0.0

    def clear(self):
        self.__init__()

    def add_sample(self, sample):
        self.samples += 1
        delta = sample - self.mean
        self.mean += delta / self.samples
        self._m2 += delta * (sample - self.mean)
        self.variance = self._m2 / (self.samples - 1) if self.samples > 1 else 0.0

    def combine_samples(self, mean, variance, sample_count):
        if sample_count <= 0:
            return
        n_a = self.samples
        m2_b = variance * max(sample_count - 1, 0)
        n = n_a + sample_count
        delta = mean - self.mean
        self.mean += delta * (sample_count / n)
        self._m2 += m2_b + delta * delta * (n_a * sample_count / n)
        self.samples = n
        self.variance = self._m2 / (n - 1) if n > 1 else 0.0

    def error(self):
        """Standard error of the mean (statsarray.pxd:46; a method, as in
        the reference)."""
        if self.samples <= 0:
            return 0.0
        return math.sqrt(self.variance / self.samples)


class StatsArray1D(_StatsBase):
    def __init__(self, length):
        if length < 1:
            raise ValueError("Length must be >= 1.")
        super().__init__((length,))
        self.length = int(length)


class StatsArray2D(_StatsBase):
    def __init__(self, nx, ny):
        if nx < 1 or ny < 1:
            raise ValueError("Dimensions must be >= 1.")
        super().__init__((nx, ny))
        self.nx = int(nx)
        self.ny = int(ny)


class StatsArray3D(_StatsBase):
    def __init__(self, nx, ny, nz):
        if nx < 1 or ny < 1 or nz < 1:
            raise ValueError("Dimensions must be >= 1.")
        super().__init__((nx, ny, nz))
        self.nx = int(nx)
        self.ny = int(ny)
        self.nz = int(nz)
