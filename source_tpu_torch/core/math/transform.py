"""Affine transform factory functions.

Re-implements the reference transform factories
(raysect/core/math/transform.pyx:42-381) with identical semantics: angles in
degrees, coordinate-space (passive) transforms, intrinsic (-Y)(-X)'Z'' rotation
order for ``rotate(yaw, pitch, roll)``.
"""

from __future__ import annotations

import math

from .affinematrix import AffineMatrix3D
from .vector import Point3D, Vector3D

__all__ = [
    "translate",
    "rotate_x",
    "rotate_y",
    "rotate_z",
    "rotate_vector",
    "rotate",
    "rotate_basis",
    "to_cylindrical",
    "from_cylindrical",
    "extract_rotation",
    "extract_translation",
]

_D2R = math.pi / 180.0
_R2D = 180.0 / math.pi


def _mat(rows):
    m = AffineMatrix3D.__new__(AffineMatrix3D)
    m.m = [list(map(float, r)) for r in rows]
    return m


def translate(x, y, z):
    """Translation of the coordinate space (transform.pyx:40)."""
    return _mat(
        [[1, 0, 0, x], [0, 1, 0, y], [0, 0, 1, z], [0, 0, 0, 1]]
    )


def rotate_x(angle):
    """Rotation about the X axis, degrees (transform.pyx:76)."""
    r = _D2R * angle
    c, s = math.cos(r), math.sin(r)
    return _mat([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def rotate_y(angle):
    """Rotation about the Y axis, degrees."""
    r = _D2R * angle
    c, s = math.cos(r), math.sin(r)
    return _mat([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def rotate_z(angle):
    """Rotation about the Z axis, degrees."""
    r = _D2R * angle
    c, s = math.cos(r), math.sin(r)
    return _mat([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def rotate_vector(angle, v):
    """Rotation about an arbitrary axis by angle degrees (transform.pyx:178)."""
    vn = v.normalise()
    r = _D2R * angle
    s, c = math.sin(r), math.cos(r)
    ci = 1.0 - c
    x, y, z = vn.x, vn.y, vn.z
    return _mat(
        [
            [x * x + (1 - x * x) * c, x * y * ci - z * s, x * z * ci + y * s, 0],
            [x * y * ci + z * s, y * y + (1 - y * y) * c, y * z * ci - x * s, 0],
            [x * z * ci - y * s, y * z * ci + x * s, z * z + (1 - z * z) * c, 0],
            [0, 0, 0, 1],
        ]
    )


def rotate(yaw, pitch, roll):
    """Intrinsic rotation, axis order (-Y)(-X)'Z'' (transform.pyx:216)."""
    return rotate_y(-yaw) * rotate_x(-pitch) * rotate_z(roll)


def rotate_basis(forward, up):
    """Rotation matrix from forward/up vectors (transform.pyx:234).

    +Z aligns with forward; +Y is the component of up orthogonal to forward;
    X = Y cross Z.
    """
    if forward is None:
        raise ValueError("Forward vector must not be None.")
    if up is None:
        raise ValueError("Up vector must not be None.")
    z = forward.normalise()
    y = up.normalise()
    if y == z:
        raise ValueError("Forward and up vectors must not be coincident.")
    y = (y - y.dot(z) * z).normalise()
    x = y.cross(z)
    return _mat(
        [
            [x.x, y.x, z.x, 0.0],
            [x.y, y.y, z.y, 0.0],
            [x.z, y.z, z.z, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def to_cylindrical(point):
    """Cartesian Point3D -> (r, z, phi-degrees) (transform.pyx:291)."""
    r = math.sqrt(point.x * point.x + point.y * point.y)
    phi = math.atan2(point.y, point.x) * _R2D
    return r, point.z, phi


def from_cylindrical(r, z, phi):
    """(r, z, phi-degrees) -> cartesian Point3D (transform.pyx:315)."""
    if r < 0:
        raise ValueError("R coordinate cannot be less than 0.")
    x = r * math.cos(phi * _D2R)
    y = r * math.sin(phi * _D2R)
    return Point3D(x, y, z)


def extract_rotation(m, z_up=False):
    """Extract (yaw, pitch, roll) degrees from a rotation+translation matrix
    (transform.pyx:344)."""
    if z_up:
        yaw = -math.atan2(m.get_element(1, 0), m.get_element(0, 0)) * _R2D
        pitch = math.asin(m.get_element(2, 0)) * _R2D
        roll = math.atan2(m.get_element(2, 1), m.get_element(2, 2)) * _R2D
        return yaw, pitch, roll
    yaw = -math.atan2(m.get_element(0, 2), m.get_element(2, 2)) * _R2D
    pitch = math.asin(m.get_element(1, 2)) * _R2D
    roll = math.atan2(m.get_element(1, 0), m.get_element(1, 1)) * _R2D
    return yaw, pitch, roll


def extract_translation(m):
    """Extract the translation components (x, y, z)."""
    return m.get_element(0, 3), m.get_element(1, 3), m.get_element(2, 3)
