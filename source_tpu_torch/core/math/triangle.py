"""Batched triangle / tetrahedra / polygon predicates on tensors.

Counterpart of source_tpu/core/math/triangle.py (the reference's nogil
scalar geometry utilities: raysect/core/math/cython/triangle.pyx:35
``inside_triangle``, :104 ``barycentric_coords``, :144/:159 barycentric
predicates/interpolation; cython/tetrahedra.pyx:35 ``inside_tetrahedra``,
:129 ``barycentric_coords_tetra``; cython/utility.pyx:752 ``winding2d``,
:786 ``point_inside_polygon``). The reference evaluates one point at a time
in C; these accept arbitrary leading batch dimensions and evaluate on the
device of their inputs (array-likes become tensors where numpy keeps them,
on the CPU), with the JAX package's order of operations.
"""

from __future__ import annotations

import torch

__all__ = [
    "barycentric_coords", "barycentric_inside_triangle",
    "barycentric_interpolation", "inside_triangle",
    "barycentric_coords_tetra", "barycentric_inside_tetrahedra",
    "barycentric_interpolation_tetra", "inside_tetrahedra",
    "winding2d", "point_inside_polygon",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _safe_inv(det):
    """1/det where det is nonzero, 0 where it is zero."""
    return torch.where(torch.abs(det) > 0,
                       1.0 / torch.where(det != 0, det, torch.ones_like(det)),
                       torch.zeros_like(det))


def barycentric_coords(v1, v2, v3, p):
    """Barycentric coordinates (alpha, beta, gamma) of 2D points ``p``
    w.r.t. triangle (v1, v2, v3) (triangle.pyx:104). Inputs [..., 2]."""
    v1, v2, v3, p = (_t(x) for x in (v1, v2, v3, p))
    x1, y1 = v1[..., 0], v1[..., 1]
    x2, y2 = v2[..., 0], v2[..., 1]
    x3, y3 = v3[..., 0], v3[..., 1]
    x, y = p[..., 0], p[..., 1]
    det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
    norm = _safe_inv(det)
    alpha = norm * ((y2 - y3) * (x - x3) + (x3 - x2) * (y - y3))
    beta = norm * ((y3 - y1) * (x - x3) + (x1 - x3) * (y - y3))
    gamma = 1.0 - alpha - beta
    return alpha, beta, gamma


def barycentric_inside_triangle(alpha, beta, gamma):
    """True where the barycentric point lies inside the triangle
    (triangle.pyx:144, boundary inclusive)."""
    return (alpha >= 0) & (beta >= 0) & (gamma >= 0)


def barycentric_interpolation(alpha, beta, gamma, va, vb, vc):
    """Interpolate vertex values by barycentric weights (triangle.pyx:159)."""
    return alpha * va + beta * vb + gamma * vc


def inside_triangle(v1, v2, v3, p):
    """Point-in-2D-triangle test (triangle.pyx:35). Inputs [..., 2]."""
    return barycentric_inside_triangle(*barycentric_coords(v1, v2, v3, p))


def _det3(u, v, w):
    return (u[..., 0] * (v[..., 1] * w[..., 2] - v[..., 2] * w[..., 1])
            - u[..., 1] * (v[..., 0] * w[..., 2] - v[..., 2] * w[..., 0])
            + u[..., 2] * (v[..., 0] * w[..., 1] - v[..., 1] * w[..., 0]))


def barycentric_coords_tetra(v1, v2, v3, v4, p):
    """Barycentric coordinates (alpha, beta, gamma, delta) of 3D points
    w.r.t. tetrahedron (v1..v4) (tetrahedra.pyx:129), by Cramer's rule on
    [a b c] (alpha, beta, gamma) = r. Inputs [..., 3]."""
    v1, v2, v3, v4, p = (_t(x) for x in (v1, v2, v3, v4, p))
    a = v1 - v4
    b = v2 - v4
    c = v3 - v4
    r = p - v4
    inv = _safe_inv(_det3(a, b, c))
    alpha = _det3(r, b, c) * inv
    beta = _det3(a, r, c) * inv
    gamma = _det3(a, b, r) * inv
    delta = 1.0 - alpha - beta - gamma
    return alpha, beta, gamma, delta


def barycentric_inside_tetrahedra(alpha, beta, gamma, delta):
    """True where the barycentric point lies inside the tetrahedron
    (tetrahedra.pyx:197)."""
    return (alpha >= 0) & (beta >= 0) & (gamma >= 0) & (delta >= 0)


def barycentric_interpolation_tetra(alpha, beta, gamma, delta, va, vb, vc, vd):
    """Interpolate vertex values by barycentric weights (tetrahedra.pyx:213)."""
    return alpha * va + beta * vb + gamma * vc + delta * vd


def inside_tetrahedra(v1, v2, v3, v4, p):
    """Point-in-tetrahedron test (tetrahedra.pyx:35). Inputs [..., 3]."""
    return barycentric_inside_tetrahedra(
        *barycentric_coords_tetra(v1, v2, v3, v4, p))


def winding2d(vertices):
    """True when a closed 2D polygon [..., N, 2] is clockwise-wound
    (utility.pyx:752: the sign of the summed edge cross products)."""
    v = _t(vertices)
    nxt = torch.roll(v, -1, dims=-2)
    area2 = torch.sum((nxt[..., 0] - v[..., 0]) * (nxt[..., 1] + v[..., 1]),
                      dim=-1)
    return area2 > 0


def point_inside_polygon(vertices, ptx, pty):
    """Even-odd point-in-polygon test for a simple 2D polygon
    (utility.pyx:786 crossing count). ``vertices`` [N, 2]; ptx/pty scalars
    or broadcastable batch tensors."""
    v = _t(vertices)
    x1, y1 = v[:, 0], v[:, 1]
    x2 = torch.roll(x1, -1)
    y2 = torch.roll(y1, -1)
    px = torch.as_tensor(ptx, dtype=v.dtype, device=v.device)[..., None]
    py = torch.as_tensor(pty, dtype=v.dtype, device=v.device)[..., None]
    straddle = (y1 > py) != (y2 > py)
    dy = torch.where(y2 != y1, y2 - y1, torch.ones_like(y1))
    x_cross = x1 + (py - y1) * (x2 - x1) / dy
    crossings = torch.sum(straddle & (px < x_cross), dim=-1)
    return crossings % 2 == 1
