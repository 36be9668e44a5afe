"""Host-side core Ray (reference raysect/core/ray.pyx:37-145).

The device compute path works on ray *batches* (tracer/wavefront.RayState);
this class is the user-facing scalar ray for interactive scene queries —
``world.hit(ray)`` / ``ray.point_on(t)`` — matching the reference's core API
(demos/core/ray_intersection_hitpoints.py usage).
"""

from __future__ import annotations

from .math.vector import Point3D, Vector3D

__all__ = ["Ray"]

_INF = float("inf")


class Ray:
    """A scalar ray: origin Point3D, direction Vector3D, max search distance
    (core/ray.pyx:38-75)."""

    def __init__(self, origin=None, direction=None, max_distance=_INF):
        self.origin = origin if origin is not None else Point3D(0.0, 0.0, 0.0)
        self.direction = (
            direction if direction is not None else Vector3D(0.0, 0.0, 1.0)
        )
        if max_distance <= 0.0:
            raise ValueError("Ray max_distance must be greater than zero.")
        self.max_distance = max_distance

    def point_on(self, t):
        """Point a parametric distance ``t`` along the ray
        (core/ray.pyx:108-122)."""
        o, d = self.origin, self.direction
        return Point3D(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t)

    def copy(self, origin=None, direction=None):
        """Duplicate with optional attribute overrides (core/ray.pyx:124-145)."""
        return Ray(
            origin if origin is not None else self.origin.copy(),
            direction if direction is not None else self.direction.copy(),
            self.max_distance,
        )

    def __repr__(self):
        return f"Ray({self.origin}, {self.direction}, {self.max_distance})"

    def __getstate__(self):
        return self.origin, self.direction, self.max_distance

    def __setstate__(self, state):
        self.origin, self.direction, self.max_distance = state
