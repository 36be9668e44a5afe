"""Host-side analytic primitive classes.

Scene-description counterparts of raysect/primitive/{sphere,box,cylinder,
cone,parabola,torus}.pyx. They carry parameters + transforms only; the
actual intersection math lives in the batched kernels of
:mod:`source_tpu_torch.primitive.analytic`, wired up by the scene compiler.
"""

from __future__ import annotations

import numpy as np

from ..core.math.vector import Point3D
from ..core.scenegraph.node import Primitive
from . import analytic as _a

__all__ = ["Sphere", "Box", "Cylinder", "Cone", "Parabola", "Torus", "OP_LEAF"]

# csg program opcodes (see compiler/scene.py)
OP_LEAF = 0
OP_UNION = 1
OP_INTERSECT = 2
OP_SUBTRACT = 3

_BOX_PAD = 1e-5


def _transform_aabb(local_lower, local_upper, m):
    """World AABB of a transformed local AABB (transform the 8 corners)."""
    lo = np.asarray(local_lower, dtype=np.float64)
    hi = np.asarray(local_upper, dtype=np.float64)
    pts = []
    for cx in (lo[0], hi[0]):
        for cy in (lo[1], hi[1]):
            for cz in (lo[2], hi[2]):
                p = Point3D(cx, cy, cz).transform(m)
                pts.append([p.x, p.y, p.z])
    pts = np.asarray(pts)
    pad = _BOX_PAD * max(1.0, float(np.abs(pts).max()))
    return pts.min(axis=0) - pad, pts.max(axis=0) + pad


class _AnalyticPrimitive(Primitive):
    """Shared compile hooks for single-leaf analytic solids."""

    _type_id = None

    def _params(self):
        raise NotImplementedError

    def _local_aabb(self):
        raise NotImplementedError

    def csg_leaves(self, world_transform):
        params = np.zeros(_a.PARAM_BLOCK, dtype=np.float64)
        vals = self._params()
        params[: len(vals)] = vals
        return [(self._type_id, world_transform, params)]

    def csg_program(self, leaf_base):
        return [(OP_LEAF, leaf_base)]

    def n_csg_leaves(self):
        return 1

    def bounding_box_world(self, world_transform):
        lo, hi = self._local_aabb()
        return _transform_aabb(lo, hi, world_transform)

    def bounding_box(self):
        return self.bounding_box_world(self.to_root())

    def instance(self, parent=None, transform=None, material=None, name=None):
        """Share geometry under a new node (reference instance())."""
        obj = type(self).__new__(type(self))
        Primitive.__init__(obj, parent, transform, material or self.material, name)
        for attr in self._geometry_attrs:
            setattr(obj, attr, getattr(self, attr))
        return obj


class Sphere(_AnalyticPrimitive):
    """Sphere of given radius centred at the local origin (sphere.pyx:45)."""

    _type_id = _a.TYPE_SPHERE
    _geometry_attrs = ("_radius",)

    def __init__(self, radius=0.5, parent=None, transform=None, material=None, name=None):
        if radius <= 0:
            raise ValueError("Sphere radius cannot be less than or equal to zero.")
        self._radius = float(radius)
        super().__init__(parent, transform, material, name)

    @property
    def radius(self):
        return self._radius

    @radius.setter
    def radius(self, value):
        if value <= 0:
            raise ValueError("Sphere radius cannot be less than or equal to zero.")
        self._radius = float(value)
        self.notify_geometry_change()

    def _params(self):
        return [self._radius]

    def _local_aabb(self):
        r = self._radius
        return (-r, -r, -r), (r, r, r)

    def bounding_sphere(self):
        c = Point3D(0, 0, 0).transform(self.to_root())
        return c, self._radius * 1.0001


class Box(_AnalyticPrimitive):
    """Axis-aligned box between two local points (box.pyx:56)."""

    _type_id = _a.TYPE_BOX
    _geometry_attrs = ("_lower", "_upper")

    def __init__(self, lower=None, upper=None, parent=None, transform=None, material=None, name=None):
        lower = lower if lower is not None else Point3D(-0.5, -0.5, -0.5)
        upper = upper if upper is not None else Point3D(0.5, 0.5, 0.5)
        if lower.x > upper.x or lower.y > upper.y or lower.z > upper.z:
            raise ValueError("The lower point must be below the upper point in all axes.")
        self._lower = lower.copy()
        self._upper = upper.copy()
        super().__init__(parent, transform, material, name)

    @property
    def lower(self):
        return self._lower

    @lower.setter
    def lower(self, value):
        self._lower = value.copy()
        self.notify_geometry_change()

    @property
    def upper(self):
        return self._upper

    @upper.setter
    def upper(self, value):
        self._upper = value.copy()
        self.notify_geometry_change()

    def _params(self):
        return [
            self._lower.x,
            self._lower.y,
            self._lower.z,
            self._upper.x,
            self._upper.y,
            self._upper.z,
        ]

    def _local_aabb(self):
        return tuple(self._lower), tuple(self._upper)


class Cylinder(_AnalyticPrimitive):
    """Capped cylinder along +z over [0, height] (cylinder.pyx:56)."""

    _type_id = _a.TYPE_CYLINDER
    _geometry_attrs = ("_radius", "_height")

    def __init__(self, radius=0.5, height=1.0, parent=None, transform=None, material=None, name=None):
        if radius <= 0:
            raise ValueError("Cylinder radius cannot be less than or equal to zero.")
        if height <= 0:
            raise ValueError("Cylinder height cannot be less than or equal to zero.")
        self._radius = float(radius)
        self._height = float(height)
        super().__init__(parent, transform, material, name)

    @property
    def radius(self):
        return self._radius

    @radius.setter
    def radius(self, value):
        if value <= 0:
            raise ValueError("Cylinder radius cannot be less than or equal to zero.")
        self._radius = float(value)
        self.notify_geometry_change()

    @property
    def height(self):
        return self._height

    @height.setter
    def height(self, value):
        if value <= 0:
            raise ValueError("Cylinder height cannot be less than or equal to zero.")
        self._height = float(value)
        self.notify_geometry_change()

    def _params(self):
        return [self._radius, self._height]

    def _local_aabb(self):
        r, h = self._radius, self._height
        return (-r, -r, 0.0), (r, r, h)


class Cone(_AnalyticPrimitive):
    """Capped cone: base radius at z=0, apex at z=height (cone.pyx:50)."""

    _type_id = _a.TYPE_CONE
    _geometry_attrs = ("_radius", "_height")

    def __init__(self, radius=0.5, height=1.0, parent=None, transform=None, material=None, name=None):
        if radius <= 0 or height <= 0:
            raise ValueError("Cone radius/height must be greater than zero.")
        self._radius = float(radius)
        self._height = float(height)
        super().__init__(parent, transform, material, name)

    @property
    def radius(self):
        return self._radius

    @radius.setter
    def radius(self, value):
        if value <= 0:
            raise ValueError("Cone radius cannot be less than or equal to zero.")
        self._radius = float(value)
        self.notify_geometry_change()

    @property
    def height(self):
        return self._height

    @height.setter
    def height(self, value):
        if value <= 0:
            raise ValueError("Cone height cannot be less than or equal to zero.")
        self._height = float(value)
        self.notify_geometry_change()

    def _params(self):
        return [self._radius, self._height]

    def _local_aabb(self):
        r, h = self._radius, self._height
        return (-r, -r, 0.0), (r, r, h)


class Parabola(_AnalyticPrimitive):
    """Capped paraboloid: base radius at z=0, vertex at z=height
    (parabola.pyx:51)."""

    _type_id = _a.TYPE_PARABOLA
    _geometry_attrs = ("_radius", "_height")

    def __init__(self, radius=0.5, height=1.0, parent=None, transform=None, material=None, name=None):
        if radius <= 0 or height <= 0:
            raise ValueError("Parabola radius/height must be greater than zero.")
        self._radius = float(radius)
        self._height = float(height)
        super().__init__(parent, transform, material, name)

    @property
    def radius(self):
        return self._radius

    @radius.setter
    def radius(self, value):
        if value <= 0:
            raise ValueError("Parabola radius cannot be less than or equal to zero.")
        self._radius = float(value)
        self.notify_geometry_change()

    @property
    def height(self):
        return self._height

    @height.setter
    def height(self, value):
        if value <= 0:
            raise ValueError("Parabola height cannot be less than or equal to zero.")
        self._height = float(value)
        self.notify_geometry_change()

    def _params(self):
        return [self._radius, self._height]

    def _local_aabb(self):
        r, h = self._radius, self._height
        return (-r, -r, 0.0), (r, r, h)


class Torus(_AnalyticPrimitive):
    """Torus with axis +z, spine in the x-y plane (torus.pyx:46)."""

    _type_id = _a.TYPE_TORUS
    _geometry_attrs = ("_major_radius", "_minor_radius")

    def __init__(self, major_radius=1.0, minor_radius=0.5, parent=None, transform=None, material=None, name=None):
        if major_radius <= 0 or minor_radius <= 0:
            raise ValueError("Torus radii must be greater than zero.")
        if minor_radius > major_radius:
            raise ValueError("Torus minor radius cannot exceed the major radius.")
        self._major_radius = float(major_radius)
        self._minor_radius = float(minor_radius)
        super().__init__(parent, transform, material, name)

    @property
    def major_radius(self):
        return self._major_radius

    @major_radius.setter
    def major_radius(self, value):
        if value <= 0:
            raise ValueError("Torus major radius must be greater than zero.")
        self._major_radius = float(value)
        self.notify_geometry_change()

    @property
    def minor_radius(self):
        return self._minor_radius

    @minor_radius.setter
    def minor_radius(self, value):
        if value <= 0:
            raise ValueError("Torus minor radius must be greater than zero.")
        self._minor_radius = float(value)
        self.notify_geometry_change()

    def _params(self):
        return [self._major_radius, self._minor_radius]

    def _local_aabb(self):
        R, r = self._major_radius, self._minor_radius
        return (-R - r, -R - r, -r), (R + r, R + r, r)
