"""Vectorized piecewise-linear sampled-function utilities.

Vectorized replacement for the nogil numeric helpers in
raysect/core/math/cython/utility.pyx (``find_index``, ``interpolate``,
``integrate``, ``average`` — utility.pxd:36-75). Semantics match the
reference: nearest-neighbour (constant) extrapolation outside the sample
range; trapezium-rule integration of the piecewise-linear interpolant.

Everything here computes on the HOST with numpy — the host-facing Spectrum
path must never pay a device sync per call (the reference's equivalents are
nogil C for the same reason).
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_index", "interpolate", "integral_to", "integrate", "average", "sample_bins"]


def find_index(x, p):
    """Index of the lower sample bounding p: result i satisfies
    x[i] <= p < x[i+1]; -1 below range; len(x)-1 at/above top
    (utility.pyx find_index bisection semantics)."""
    return np.searchsorted(x, p, side="right") - 1


def interpolate(x, y, p):
    """Linear interpolation with constant end extrapolation
    (utility.pyx:97-135). ``p`` may be any shape."""
    return np.interp(p, x, y)


def integral_to(x, y, q):
    """Integral of the piecewise-linear function from x[0] to q, with
    constant extrapolation beyond both ends. Signed: q < x[0] gives a
    negative value. Building block for ``integrate``."""
    # cumulative trapezoid at the knots
    dx = x[1:] - x[:-1]
    seg = 0.5 * (y[1:] + y[:-1]) * dx
    cum = np.concatenate([np.zeros((1,), y.dtype), np.cumsum(seg)])

    qc = np.clip(q, x[0], x[-1])
    i = np.clip(np.searchsorted(x, qc, side="right") - 1, 0, x.shape[0] - 2)
    x0 = x[i]
    x1 = x[i + 1]
    y0 = y[i]
    y1 = y[i + 1]
    t = (qc - x0) / np.where(x1 > x0, x1 - x0, 1.0)
    yq = y0 + (y1 - y0) * t
    partial = 0.5 * (y0 + yq) * (qc - x0)
    inside = cum[i] + partial
    below = y[0] * (q - x[0])
    above = cum[-1] + y[-1] * (q - x[-1])
    return np.where(q < x[0], below, np.where(q > x[-1], above, inside))


def integrate(x, y, x0, x1):
    """Integral between x0 and x1 (utility.pyx:137+). Zero if x1 <= x0."""
    r = integral_to(x, y, x1) - integral_to(x, y, x0)
    return np.where(x1 > x0, r, 0.0)


def average(x, y, x0, x1):
    """Mean value over [x0, x1]."""
    return integrate(x, y, x0, x1) / (x1 - x0)


def sample_bins(x, y, min_w, max_w, bins):
    """Re-sample a piecewise-linear function onto ``bins`` equal-width bins
    over [min_w, max_w) by per-bin averaging — the reference
    SpectralFunction.sample contract (spectralfunction.pyx:171-216)."""
    edges = min_w + (max_w - min_w) * np.arange(bins + 1) / bins
    cum = integral_to(x, y, edges)
    delta = (max_w - min_w) / bins
    return (cum[1:] - cum[:-1]) / delta
