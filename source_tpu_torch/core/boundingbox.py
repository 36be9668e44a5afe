"""Host-side bounding volumes: BoundingBox3D/2D, BoundingSphere3D.

Counterpart of source_tpu/core/boundingbox.py (raysect/core/
boundingbox.pyx:51-666 and boundingsphere.pyx:39-270). These are host-side
scene-construction utilities in numpy (AABB accumulation, padding,
enclosing spheres); the device's slab tests live in the kernels.
"""

from __future__ import annotations

import math

import numpy as np

from .math.vector import Point3D

__all__ = ["BoundingBox3D", "BoundingBox2D", "BoundingSphere3D"]


class BoundingBox3D:
    """Axis-aligned box (boundingbox.pyx:51)."""

    def __init__(self, lower=None, upper=None):
        if lower is None and upper is None:
            self.lower = np.full(3, np.inf)
            self.upper = np.full(3, -np.inf)
        else:
            self.lower = np.asarray(
                [lower.x, lower.y, lower.z] if hasattr(lower, "x") else lower,
                np.float64,
            )
            self.upper = np.asarray(
                [upper.x, upper.y, upper.z] if hasattr(upper, "x") else upper,
                np.float64,
            )
            if (self.lower > self.upper).any():
                raise ValueError("The lower point must be below the upper point.")

    def __repr__(self):
        return f"BoundingBox3D({tuple(self.lower)}, {tuple(self.upper)})"

    @property
    def is_empty(self):
        return bool((self.lower > self.upper).any())

    def contains(self, point, tolerance=0.0):
        p = np.asarray(
            [point.x, point.y, point.z] if hasattr(point, "x") else point
        )
        return bool(
            (p >= self.lower - tolerance).all() and (p <= self.upper + tolerance).all()
        )

    def union(self, box):
        self.lower = np.minimum(self.lower, box.lower)
        self.upper = np.maximum(self.upper, box.upper)

    def extend(self, point, padding=0.0):
        p = np.asarray(
            [point.x, point.y, point.z] if hasattr(point, "x") else point
        )
        self.lower = np.minimum(self.lower, p - padding)
        self.upper = np.maximum(self.upper, p + padding)

    def pad(self, padding):
        self.lower = self.lower - padding
        self.upper = self.upper + padding

    def pad_axis(self, axis, padding):
        self.lower[axis] -= padding
        self.upper[axis] += padding

    def surface_area(self):
        e = np.maximum(self.upper - self.lower, 0.0)
        return float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0]))

    def volume(self):
        e = np.maximum(self.upper - self.lower, 0.0)
        return float(e.prod())

    def vertices(self):
        lo, hi = self.lower, self.upper
        return [
            Point3D(x, y, z)
            for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])
        ]

    def extent(self, axis):
        return float(max(self.upper[axis] - self.lower[axis], 0.0))

    def largest_axis(self):
        return int(np.argmax(self.upper - self.lower))

    def largest_extent(self):
        return float(np.max(self.upper - self.lower))

    @property
    def centre(self):
        c = 0.5 * (self.lower + self.upper)
        return Point3D(*c)

    def enclosing_sphere(self):
        """Sphere through the box corners (boundingbox.pxd:58)."""
        centre = 0.5 * (self.lower + self.upper)
        radius = float(np.linalg.norm(self.upper - centre))
        return BoundingSphere3D(Point3D(*centre), radius)

    def hit(self, origin, direction):
        """Slab test for a single host-side ray (origin/direction 3-seq or
        Point3D/Vector3D). Returns (hit, t_near, t_far)."""
        o = np.asarray(
            [origin.x, origin.y, origin.z] if hasattr(origin, "x") else origin
        )
        d = np.asarray(
            [direction.x, direction.y, direction.z]
            if hasattr(direction, "x") else direction
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), np.inf)
        t0 = (self.lower - o) * inv
        t1 = (self.upper - o) * inv
        t_near = float(np.max(np.minimum(t0, t1)))
        t_far = float(np.min(np.maximum(t0, t1)))
        return t_far >= max(t_near, 0.0), t_near, t_far


class BoundingBox2D:
    """2D AABB (boundingbox.pyx:461)."""

    def __init__(self, lower=None, upper=None):
        if lower is None and upper is None:
            self.lower = np.full(2, np.inf)
            self.upper = np.full(2, -np.inf)
        else:
            self.lower = np.asarray(lower, np.float64)
            self.upper = np.asarray(upper, np.float64)
            if (self.lower > self.upper).any():
                raise ValueError("The lower point must be below the upper point.")

    def contains(self, point, tolerance=0.0):
        p = np.asarray(point)
        return bool(
            (p >= self.lower - tolerance).all() and (p <= self.upper + tolerance).all()
        )

    def union(self, box):
        self.lower = np.minimum(self.lower, box.lower)
        self.upper = np.maximum(self.upper, box.upper)

    def extend(self, point, padding=0.0):
        p = np.asarray(point)
        self.lower = np.minimum(self.lower, p - padding)
        self.upper = np.maximum(self.upper, p + padding)

    def surface_area(self):
        e = np.maximum(self.upper - self.lower, 0.0)
        return float(e.prod())


class BoundingSphere3D:
    """Bounding sphere (boundingsphere.pyx:39)."""

    def __init__(self, centre, radius):
        if radius <= 0:
            raise ValueError("Radius must be greater than zero.")
        self.centre = centre if hasattr(centre, "x") else Point3D(*centre)
        self.radius = float(radius)

    def __repr__(self):
        return f"BoundingSphere3D({self.centre}, {self.radius})"

    def contains(self, point, tolerance=0.0):
        p = point if hasattr(point, "x") else Point3D(*point)
        dx = p.x - self.centre.x
        dy = p.y - self.centre.y
        dz = p.z - self.centre.z
        return math.sqrt(dx * dx + dy * dy + dz * dz) <= self.radius + tolerance

    def union(self, sphere):
        """Grow to enclose another sphere (boundingsphere.pyx union)."""
        d = math.sqrt(
            (sphere.centre.x - self.centre.x) ** 2
            + (sphere.centre.y - self.centre.y) ** 2
            + (sphere.centre.z - self.centre.z) ** 2
        )
        if d + sphere.radius <= self.radius:
            return
        if d + self.radius <= sphere.radius:
            self.centre = sphere.centre
            self.radius = sphere.radius
            return
        new_r = 0.5 * (d + self.radius + sphere.radius)
        t = (new_r - self.radius) / max(d, 1e-300)
        self.centre = Point3D(
            self.centre.x + t * (sphere.centre.x - self.centre.x),
            self.centre.y + t * (sphere.centre.y - self.centre.y),
            self.centre.z + t * (sphere.centre.z - self.centre.z),
        )
        self.radius = new_r

    def extend(self, point, padding=0.0):
        p = point if hasattr(point, "x") else Point3D(*point)
        d = math.sqrt(
            (p.x - self.centre.x) ** 2 + (p.y - self.centre.y) ** 2
            + (p.z - self.centre.z) ** 2
        )
        if d + padding > self.radius:
            self.radius = d + padding

    def pad(self, padding):
        self.radius += padding
