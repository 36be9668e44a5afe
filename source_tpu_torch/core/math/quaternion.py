"""Quaternion rotations, host-side.

Counterpart of source_tpu/core/math/quaternion.py (raysect/core/math/
quaternion.pyx:44), pure Python on Vector3D and AffineMatrix3D. Component order
matches the reference: ``Quaternion(x, y, z, s)`` with scalar part last.
"""

from __future__ import annotations

import math

from .affinematrix import AffineMatrix3D
from .vector import Vector3D

__all__ = ["Quaternion"]


class Quaternion:

    __slots__ = ("x", "y", "z", "s")

    def __init__(self, x=0.0, y=0.0, z=0.0, s=1.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)
        self.s = float(s)

    def __repr__(self):
        return f"Quaternion({self.x}, {self.y}, {self.z}, {self.s})"

    def __eq__(self, other):
        if isinstance(other, Quaternion):
            return (
                self.x == other.x
                and self.y == other.y
                and self.z == other.z
                and self.s == other.s
            )
        return NotImplemented

    def __neg__(self):
        return Quaternion(-self.x, -self.y, -self.z, -self.s)

    def __add__(self, other):
        if isinstance(other, Quaternion):
            return Quaternion(
                self.x + other.x, self.y + other.y, self.z + other.z, self.s + other.s
            )
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Quaternion):
            return Quaternion(
                self.x - other.x, self.y - other.y, self.z - other.z, self.s - other.s
            )
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, Quaternion):
            a, b = self, other
            return Quaternion(
                a.s * b.x + a.x * b.s + a.y * b.z - a.z * b.y,
                a.s * b.y - a.x * b.z + a.y * b.s + a.z * b.x,
                a.s * b.z + a.x * b.y - a.y * b.x + a.z * b.s,
                a.s * b.s - a.x * b.x - a.y * b.y - a.z * b.z,
            )
        if isinstance(other, (int, float)):
            f = float(other)
            return Quaternion(self.x * f, self.y * f, self.z * f, self.s * f)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quaternion):
            return self * other.inverse()
        if isinstance(other, (int, float)):
            if other == 0.0:
                raise ZeroDivisionError("Cannot divide a quaternion by zero.")
            inv = 1.0 / float(other)
            return Quaternion(self.x * inv, self.y * inv, self.z * inv, self.s * inv)
        return NotImplemented

    # --- properties ------------------------------------------------------------

    @property
    def length(self):
        return math.sqrt(
            self.x * self.x + self.y * self.y + self.z * self.z + self.s * self.s
        )

    @property
    def axis(self):
        """Rotation axis as a Vector3D."""
        n = math.sqrt(self.x * self.x + self.y * self.y + self.z * self.z)
        if n == 0.0:
            return Vector3D(0, 0, 1)
        return Vector3D(self.x / n, self.y / n, self.z / n)

    @property
    def angle(self):
        """Rotation angle in degrees."""
        n = math.sqrt(self.x * self.x + self.y * self.y + self.z * self.z)
        return math.degrees(2.0 * math.atan2(n, self.s))

    # --- operations -------------------------------------------------------------

    def copy(self):
        return Quaternion(self.x, self.y, self.z, self.s)

    def conjugate(self):
        return Quaternion(-self.x, -self.y, -self.z, self.s)

    def inverse(self):
        n2 = (
            self.x * self.x + self.y * self.y + self.z * self.z + self.s * self.s
        )
        if n2 == 0.0:
            raise ZeroDivisionError("A zero quaternion cannot be inverted.")
        inv = 1.0 / n2
        return Quaternion(-self.x * inv, -self.y * inv, -self.z * inv, self.s * inv)

    def normalise(self):
        length = self.length
        if length == 0.0:
            raise ZeroDivisionError("A zero length quaternion cannot be normalised.")
        inv = 1.0 / length
        return Quaternion(self.x * inv, self.y * inv, self.z * inv, self.s * inv)

    def is_unit(self, tolerance=1e-10):
        return abs(self.length - 1.0) < tolerance

    def transform(self, m):
        """Rotate this quaternion by the rotation part of an AffineMatrix3D."""
        return Quaternion.from_matrix(m) * self

    def quaternion_to(self, q):
        """Quaternion rotating this orientation onto q (quaternion.pyx:420)."""
        return q * self.inverse()

    def as_matrix(self):
        """Equivalent rotation matrix (quaternion.pyx:364)."""
        q = self.normalise()
        x, y, z, s = q.x, q.y, q.z, q.s
        return AffineMatrix3D(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * s), 2 * (x * z + y * s), 0],
                [2 * (x * y + z * s), 1 - 2 * (x * x + z * z), 2 * (y * z - x * s), 0],
                [2 * (x * z - y * s), 2 * (y * z + x * s), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ]
        )

    @classmethod
    def from_matrix(cls, m):
        """Quaternion from the rotation part of a matrix (quaternion.pyx:449)."""
        t = m.get_element(0, 0) + m.get_element(1, 1) + m.get_element(2, 2)
        if t > 0:
            k = 0.5 / math.sqrt(1.0 + t)
            return cls(
                k * (m.get_element(2, 1) - m.get_element(1, 2)),
                k * (m.get_element(0, 2) - m.get_element(2, 0)),
                k * (m.get_element(1, 0) - m.get_element(0, 1)),
                0.25 / k,
            ).normalise()
        m00, m11, m22 = (
            m.get_element(0, 0),
            m.get_element(1, 1),
            m.get_element(2, 2),
        )
        if m00 > m11 and m00 > m22:
            k = 2.0 * math.sqrt(1.0 + m00 - m11 - m22)
            return cls(
                0.25 * k,
                (m.get_element(0, 1) + m.get_element(1, 0)) / k,
                (m.get_element(0, 2) + m.get_element(2, 0)) / k,
                (m.get_element(2, 1) - m.get_element(1, 2)) / k,
            ).normalise()
        if m11 > m22:
            k = 2.0 * math.sqrt(1.0 + m11 - m00 - m22)
            return cls(
                (m.get_element(0, 1) + m.get_element(1, 0)) / k,
                0.25 * k,
                (m.get_element(1, 2) + m.get_element(2, 1)) / k,
                (m.get_element(0, 2) - m.get_element(2, 0)) / k,
            ).normalise()
        k = 2.0 * math.sqrt(1.0 + m22 - m00 - m11)
        return cls(
            (m.get_element(0, 2) + m.get_element(2, 0)) / k,
            (m.get_element(1, 2) + m.get_element(2, 1)) / k,
            0.25 * k,
            (m.get_element(1, 0) - m.get_element(0, 1)) / k,
        ).normalise()

    @classmethod
    def from_axis_angle(cls, axis, angle):
        """Quaternion from axis Vector3D + angle in degrees (quaternion.pyx:469)."""
        a = axis.normalise()
        half = 0.5 * math.radians(angle)
        s = math.sin(half)
        return cls(a.x * s, a.y * s, a.z * s, math.cos(half))
