"""2D polygon triangulation by ear clipping.

Counterpart of source_tpu/core/math/polygon.py (raysect/core/math/
polygon.pyx:44, ``triangulate2d`` with ``_locate_ear``). Host-side geometry
preprocessing (mesh construction from polygon outlines), plain numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["triangulate2d"]


def _winding(poly):
    """Signed area x2: positive for counter-clockwise."""
    x = poly[:, 0]
    y = poly[:, 1]
    return float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _inside_triangle(a, b, c, p, tol=0.0):
    """Point-in-triangle via sign of barycentric areas."""
    def cross(o, u, v):
        return (u[0] - o[0]) * (v[1] - o[1]) - (u[1] - o[1]) * (v[0] - o[0])

    d1 = cross(a, b, p)
    d2 = cross(b, c, p)
    d3 = cross(c, a, p)
    neg = (d1 < -tol) or (d2 < -tol) or (d3 < -tol)
    pos = (d1 > tol) or (d2 > tol) or (d3 > tol)
    return not (neg and pos)


def triangulate2d(vertices):
    """Triangulate a simple (non-self-intersecting) polygon.

    vertices: [N, 2] array of polygon vertices in order (either winding).
    Returns an int32 [N-2, 3] triangle index array.
    """
    poly = np.asarray(vertices, np.float64)
    if poly.ndim != 2 or poly.shape[1] != 2:
        raise ValueError("Vertices must be an [N, 2] array.")
    n = poly.shape[0]
    if n < 3:
        raise ValueError("A polygon requires at least 3 vertices.")

    indices = list(range(n))
    if _winding(poly) < 0:  # ensure counter-clockwise
        indices.reverse()

    triangles = []
    guard = 0
    while len(indices) > 3:
        guard += 1
        if guard > 2 * n * n:
            raise ValueError("Polygon triangulation failed (is it simple?).")
        m = len(indices)
        clipped = False
        for i in range(m):
            i0, i1, i2 = indices[(i - 1) % m], indices[i], indices[(i + 1) % m]
            a, b, c = poly[i0], poly[i1], poly[i2]
            # convex corner?
            if (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0]) <= 0:
                continue
            # no other vertex inside the candidate ear
            ear = True
            for j in indices:
                if j in (i0, i1, i2):
                    continue
                if _inside_triangle(a, b, c, poly[j]):
                    ear = False
                    break
            if ear:
                triangles.append((i0, i1, i2))
                indices.pop(i)
                clipped = True
                break
        if not clipped:
            raise ValueError("Polygon triangulation failed (is it simple?).")
    triangles.append(tuple(indices))
    return np.asarray(triangles, np.int32)
