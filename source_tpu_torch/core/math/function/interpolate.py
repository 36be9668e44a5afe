"""Array interpolators: 1D/2D/3D gridded data -> smooth scalar fields.

Counterpart of source_tpu/core/math/function/interpolate.py (the
reference's array interpolators, raysect/core/math/function/float/
function1d/interpolate.pyx:45 ``Interpolator1DArray``, function2d/
interpolate/interpolator2darray.pyx:101, function3d/interpolate/
interpolator3darray.pyx:99): linear or cubic interpolation with
none/nearest/linear/quadratic extrapolation over an ``extrapolation_range``.

As in the JAX package:
  * cubic interpolation is local Hermite, knot slopes from second-order
    finite differences (the reference's _ArrayDerivative estimates,
    interpolate.pyx:627), evaluated separably: every query gathers its
    (4,)^N neighbourhood and reduces one axis at a time;
  * linear/quadratic extrapolation is a Taylor expansion from the nearest
    edge point whose mixed partial derivatives are the interpolant's own,
    taken by autograd (the JAX package takes them with ``jax.grad``);
  * 'none' extrapolation returns NaN out of range (the reference raises).

The tables are float32, one copy per device; a call evaluates on its
queries' device, or for numbers and numpy arrays on the interpolator's
``device`` (the card unless it was made with ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Function1D, Function2D, Function3D, as_tensors

__all__ = ["Interpolator1DArray", "Interpolator2DArray", "Interpolator3DArray"]

_INTERP_TYPES = ("linear", "cubic")
_EXTRAP_TYPES = ("none", "nearest", "linear", "quadratic")


def _check_axis(x, name):
    x = np.asarray(x, np.float64)
    if x.ndim != 1 or x.size < 2:
        raise ValueError(f"{name} must be a 1D array with >= 2 samples.")
    if not np.all(np.diff(x) > 0):
        raise ValueError(f"{name} must be strictly increasing.")
    return x


def _fd_slope(xm, x0, xp, fm, f0, fp):
    """Knot slope at x0 from its neighbours: the reference's second-order
    non-uniform three-point formula at interior knots
    (interpolate.pyx _ArrayDerivative1D._evaluate_x); a clamped (duplicated)
    edge point collapses one delta to zero, which degrades it to the
    one-sided first-order edge estimate (_evaluate_edge_x)."""
    dx0 = xp - x0
    dx1 = x0 - xm
    # clamped windows duplicate coordinates exactly: compare against zero
    lo_edge = dx1 == 0.0
    hi_edge = dx0 == 0.0
    num = fp * dx1 * dx1 - fm * dx0 * dx0 - f0 * (dx1 * dx1 - dx0 * dx0)
    den = dx0 * dx1 * dx1 + dx1 * dx0 * dx0
    interior = torch.where(den != 0.0, num / torch.where(den != 0.0, den, 1.0),
                           0.0)
    one_sided_lo = (fp - f0) / torch.where(hi_edge, 1.0, dx0)
    one_sided_hi = (f0 - fm) / torch.where(lo_edge, 1.0, dx1)
    return torch.where(lo_edge, one_sided_lo,
                       torch.where(hi_edge, one_sided_hi, interior))


def _hermite_window(x4, f4, q):
    """Cubic Hermite on the middle interval [x4[..., 1], x4[..., 2]] of a
    4-point window, with FD slopes. q broadcasts against x4[..., 0]."""
    m_a = _fd_slope(x4[..., 0], x4[..., 1], x4[..., 2],
                    f4[..., 0], f4[..., 1], f4[..., 2])
    m_b = _fd_slope(x4[..., 1], x4[..., 2], x4[..., 3],
                    f4[..., 1], f4[..., 2], f4[..., 3])
    h = x4[..., 2] - x4[..., 1]
    hs = torch.clamp(torch.abs(h), min=1e-30) * torch.where(h < 0, -1.0, 1.0)
    t = (q - x4[..., 1]) / hs
    f0, f1 = f4[..., 1], f4[..., 2]
    m0, m1 = m_a * hs, m_b * hs
    t2 = t * t
    t3 = t2 * t
    return ((2 * t3 - 3 * t2 + 1) * f0
            + (t3 - 2 * t2 + t) * m0
            + (-2 * t3 + 3 * t2) * f1
            + (t3 - t2) * m1)


class _GridInterpolator:
    """Shared N-D grid machinery (N = 1, 2, 3)."""

    def __init__(self, axes, f, interpolation_type, extrapolation_type,
                 extrapolation_range, names, device=None):
        interpolation_type = interpolation_type.lower()
        extrapolation_type = extrapolation_type.lower()
        if interpolation_type not in _INTERP_TYPES:
            raise ValueError(f"interpolation_type must be one of {_INTERP_TYPES}.")
        if extrapolation_type not in _EXTRAP_TYPES:
            raise ValueError(f"extrapolation_type must be one of {_EXTRAP_TYPES}.")
        if extrapolation_type == "quadratic" and (
                interpolation_type != "cubic" or len(axes) != 1):
            # the reference's permitted_interpolation_combinations: quadratic
            # extrapolation exists only for the 1D cubic interpolator
            # (interpolate.pyx:745-749)
            raise ValueError(
                f"Extrapolation type {extrapolation_type} not compatible with "
                f"interpolation type {interpolation_type}.")
        self.interpolation_type = interpolation_type
        self.extrapolation_type = extrapolation_type
        self.extrapolation_range = float(extrapolation_range)
        self.device = device

        axes = [_check_axis(a, nm) for a, nm in zip(axes, names)]
        f = np.asarray(f, np.float64)
        if f.shape != tuple(a.size for a in axes):
            raise ValueError("f shape must match the axis lengths.")
        if interpolation_type == "cubic" and any(a.size < 4 for a in axes):
            raise ValueError("cubic interpolation requires >= 4 samples per axis.")
        self._host = ([torch.as_tensor(a, dtype=torch.float32) for a in axes],
                      torch.as_tensor(f, dtype=torch.float32))
        self._tables = {torch.device("cpu"): self._host}

        if extrapolation_type == "quadratic":
            # data-driven edge curvature of the reference's
            # _Extrapolator1DQuadratic (interpolate.pyx:499-570): a quadratic
            # through the edge knot with the edge first derivative and the
            # slope change across the edge cell as curvature, in float64
            x0 = axes[0]
            h_lo = x0[1] - x0[0]
            m0 = (f[1] - f[0]) / h_lo
            m1 = self._np_fd_slope(x0[0], x0[1], x0[2], f[0], f[1], f[2])
            self._quad_d2_lo = float((m1 - m0) / h_lo)
            h_hi = x0[-1] - x0[-2]
            m_end = (f[-1] - f[-2]) / h_hi
            m_in = self._np_fd_slope(x0[-3], x0[-2], x0[-1], f[-3], f[-2], f[-1])
            self._quad_d2_hi = float((m_end - m_in) / h_hi)

    @staticmethod
    def _np_fd_slope(xm, x0, xp, fm, f0, fp):
        """Host-side interior knot slope (the formula of _fd_slope)."""
        dx0 = xp - x0
        dx1 = x0 - xm
        num = fp * dx1 * dx1 - fm * dx0 * dx0 - f0 * (dx1 * dx1 - dx0 * dx0)
        return num / (dx0 * dx1 * dx1 + dx1 * dx0 * dx0)

    def _on(self, device):
        """(axes, f) on ``device``, copied there at first use."""
        tabs = self._tables.get(device)
        if tabs is None:
            axes, f = self._host
            tabs = ([a.to(device) for a in axes], f.to(device))
            self._tables[device] = tabs
        return tabs

    def _eval(self, *qs):
        qs = as_tensors(qs, self.device)
        axes, f = self._on(qs[0].device)
        qs = torch.broadcast_tensors(*[q.to(f.dtype) for q in qs])
        nd = len(axes)
        rng = self.extrapolation_range
        clipped = []
        invalid = None
        for d in range(nd):
            x, q = axes[d], qs[d]
            if self.extrapolation_type == "none":
                inv = (q < x[0]) | (q > x[-1])
            else:
                inv = (q < x[0] - rng) | (q > x[-1] + rng)
            clipped.append(torch.clamp(q, x[0], x[-1]))
            invalid = inv if invalid is None else (invalid | inv)

        # base value at the clipped (nearest) coordinates
        interp = self._multilinear if self.interpolation_type == "linear" \
            else self._multicubic
        val = interp(axes, f, clipped)

        # linear/quadratic extrapolation: multilinear Taylor expansion from
        # the nearest edge point, per-axis first derivatives plus the mixed
        # terms in corner regions (the reference's _evaluate_edge_xy adds
        # Dx*Dy*d2f/dxdy, interpolator2darray.pyx:837; the 3D extrapolator
        # adds the pairwise and triple products)
        if self.extrapolation_type in ("linear", "quadratic"):
            deltas = [qs[d] - clipped[d] for d in range(nd)]
            for mask in range(1, 2 ** nd):
                axes_sel = tuple(d for d in range(nd) if (mask >> d) & 1)
                corr = self._edge_derivative(interp, axes, f, clipped, axes_sel)
                outside = None
                for d in axes_sel:
                    corr = corr * deltas[d]
                    o = deltas[d] != 0.0
                    outside = o if outside is None else (outside & o)
                val = val + torch.where(outside, corr, 0.0)
            if self.extrapolation_type == "quadratic":
                dq = deltas[0]
                g2 = torch.where(dq < 0.0, self._quad_d2_lo, self._quad_d2_hi)
                val = val + torch.where(dq != 0.0, 0.5 * g2 * dq * dq, 0.0)
        return torch.where(invalid, torch.nan, val)

    @staticmethod
    def _edge_derivative(interp, axes, f, clipped, axes_sel):
        """The exact mixed partial derivative of the interpolant (one
        differentiation per axis in ``axes_sel``) at the clipped edge point,
        by autograd: a query's value depends on its own coordinates only, so
        the gradient of the sum is the per-query derivative."""
        with torch.enable_grad():
            qs = [c.detach().requires_grad_(d in axes_sel)
                  for d, c in enumerate(clipped)]
            out = interp(axes, f, qs)
            for d in axes_sel:
                if not out.requires_grad:
                    return torch.zeros_like(clipped[0])
                (out,) = torch.autograd.grad(out.sum(), qs[d], create_graph=True,
                                             allow_unused=True)
                if out is None:
                    return torch.zeros_like(clipped[0])
        return out.detach()

    @staticmethod
    def _cell_index(x, q):
        i = torch.searchsorted(x, q.contiguous(), right=True) - 1
        return torch.clamp(i, 0, x.shape[0] - 2)

    def _multilinear(self, axes, f, qs):
        nd = len(axes)
        idx, frac = [], []
        for d in range(nd):
            x = axes[d]
            i = self._cell_index(x, qs[d])
            # no clamp on t: queries are pre-clipped to the axis range
            t = (qs[d] - x[i]) / torch.clamp(x[i + 1] - x[i], min=1e-30)
            idx.append(i)
            frac.append(t)
        val = 0.0
        for corner in range(2 ** nd):
            w = 1.0
            gather = []
            for d in range(nd):
                bit = (corner >> d) & 1
                w = w * (frac[d] if bit else (1.0 - frac[d]))
                gather.append(idx[d] + bit)
            val = val + w * f[tuple(gather)]
        return val

    def _multicubic(self, axes, f, qs):
        nd = len(axes)
        offsets = torch.arange(-1, 3, device=f.device)
        i4 = [torch.clamp(self._cell_index(axes[d], qs[d])[..., None] + offsets,
                          0, axes[d].shape[0] - 1) for d in range(nd)]
        # gather the (4,)^nd neighbourhood: block [..., 4_0, ..., 4_{nd-1}]
        gather_ix = []
        for d in range(nd):
            shape = i4[d].shape[:-1] + tuple(4 if k == d else 1 for k in range(nd))
            gather_ix.append(i4[d].reshape(shape))
        block = f[tuple(gather_ix)]

        # reduce axes from the last to the first with 1D Hermite windows
        for d in reversed(range(nd)):
            x4 = axes[d][i4[d]]  # [..., 4]
            # block's last axis is axis d's window; broadcast x4/q across the
            # remaining (earlier) window axes
            extra = block.dim() - 1 - (x4.dim() - 1)
            x4b = x4.reshape(x4.shape[:-1] + (1,) * extra + (4,))
            qb = qs[d].reshape(qs[d].shape + (1,) * extra)
            block = _hermite_window(x4b.expand(block.shape), block, qb)
        return block


class Interpolator1DArray(Function1D, _GridInterpolator):
    """1D gridded interpolator (interpolate.pyx:45 API)."""

    def __init__(self, x, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range=float("inf"),
                 device=None):
        _GridInterpolator.__init__(self, [x], f, interpolation_type,
                                   extrapolation_type, extrapolation_range, ["x"],
                                   device)

    def __call__(self, x):
        return self._eval(x)


class Interpolator2DArray(Function2D, _GridInterpolator):
    """2D gridded interpolator (interpolator2darray.pyx:101 API)."""

    def __init__(self, x, y, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range_x=float("inf"),
                 extrapolation_range_y=float("inf"), device=None):
        _GridInterpolator.__init__(
            self, [x, y], f, interpolation_type, extrapolation_type,
            min(extrapolation_range_x, extrapolation_range_y), ["x", "y"],
            device)

    def __call__(self, x, y):
        return self._eval(x, y)


class Interpolator3DArray(Function3D, _GridInterpolator):
    """3D gridded interpolator (interpolator3darray.pyx:99 API)."""

    def __init__(self, x, y, z, f, interpolation_type="linear",
                 extrapolation_type="none", extrapolation_range_x=float("inf"),
                 extrapolation_range_y=float("inf"),
                 extrapolation_range_z=float("inf"), device=None):
        _GridInterpolator.__init__(
            self, [x, y, z], f, interpolation_type, extrapolation_type,
            min(extrapolation_range_x, extrapolation_range_y,
                extrapolation_range_z),
            ["x", "y", "z"], device)

    def __call__(self, x, y, z):
        return self._eval(x, y, z)
