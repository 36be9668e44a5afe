"""Host-side 3D/2D vector, point and normal types.

Re-design of the reference's Cython math substrate
(raysect/core/math/{_vec3,vector,point,normal}.pyx). These classes are only
used on the *host* during scene construction — all device-side math operates
on flat tensors (see :mod:`source_tpu_torch.core.math.batch`). They are
therefore plain-Python, numpy-float backed, and deliberately cheap.

API parity targets (reference file:line):
  - Vector3D: raysect/core/math/vector.pyx:40
  - Point3D:  raysect/core/math/point.pyx:39
  - Normal3D: raysect/core/math/normal.pyx:38 (inverse-transpose transform)
  - Vector2D/Point2D: vector.pyx:607, point.pyx:356
"""

from __future__ import annotations

import math

__all__ = ["Vector3D", "Point3D", "Normal3D", "Vector2D", "Point2D"]


class _Vec3:
    """Shared x/y/z base (reference: core/math/_vec3.pyx)."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    def __repr__(self):
        return f"{type(self).__name__}({self.x}, {self.y}, {self.z})"

    def __iter__(self):
        yield self.x
        yield self.y
        yield self.z

    def __getitem__(self, i):
        return (self.x, self.y, self.z)[i]

    def __setitem__(self, i, v):
        if i == 0:
            self.x = float(v)
        elif i == 1:
            self.y = float(v)
        elif i == 2:
            self.z = float(v)
        else:
            raise IndexError("index out of range")

    def __eq__(self, other):
        if isinstance(other, _Vec3):
            return self.x == other.x and self.y == other.y and self.z == other.z
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __hash__(self):
        return hash((type(self).__name__, self.x, self.y, self.z))

    def __getstate__(self):
        return (self.x, self.y, self.z)

    def __setstate__(self, state):
        self.x, self.y, self.z = state

    # --- shared numeric helpers -------------------------------------------------

    @property
    def length(self):
        return math.sqrt(self.x * self.x + self.y * self.y + self.z * self.z)

    def dot(self, other):
        return self.x * other.x + self.y * other.y + self.z * other.z


class Vector3D(_Vec3):
    """A 3D vector with the reference Vector3D's full API (vector.pyx:40).

    Default-constructs to the z unit vector (vector.pyx:65)."""

    __slots__ = ()

    def __init__(self, x=0.0, y=0.0, z=1.0):
        super().__init__(x, y, z)

    def __neg__(self):
        return Vector3D(-self.x, -self.y, -self.z)

    def __add__(self, other):
        if isinstance(other, _Vec3):
            return Vector3D(self.x + other.x, self.y + other.y, self.z + other.z)
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, _Vec3):
            return Vector3D(self.x - other.x, self.y - other.y, self.z - other.z)
        return NotImplemented

    def __mul__(self, m):
        if isinstance(m, (int, float)):
            return Vector3D(self.x * m, self.y * m, self.z * m)
        return NotImplemented

    def __rmul__(self, m):
        return self.__mul__(m)

    def __truediv__(self, d):
        if isinstance(d, (int, float)):
            if d == 0.0:
                raise ZeroDivisionError("Cannot divide a vector by zero.")
            inv = 1.0 / d
            return Vector3D(self.x * inv, self.y * inv, self.z * inv)
        return NotImplemented

    def cross(self, other):
        return Vector3D(
            self.y * other.z - self.z * other.y,
            self.z * other.x - self.x * other.z,
            self.x * other.y - self.y * other.x,
        )

    def normalise(self):
        length = self.length
        if length == 0.0:
            raise ZeroDivisionError("A zero length vector cannot be normalised.")
        inv = 1.0 / length
        return Vector3D(self.x * inv, self.y * inv, self.z * inv)

    def transform(self, m):
        """Transform by AffineMatrix3D (no translation component)."""
        return Vector3D(
            m.m[0][0] * self.x + m.m[0][1] * self.y + m.m[0][2] * self.z,
            m.m[1][0] * self.x + m.m[1][1] * self.y + m.m[1][2] * self.z,
            m.m[2][0] * self.x + m.m[2][1] * self.y + m.m[2][2] * self.z,
        )

    def lerp(self, other, t):
        return Vector3D(
            self.x + t * (other.x - self.x),
            self.y + t * (other.y - self.y),
            self.z + t * (other.z - self.z),
        )

    def slerp(self, other, t):
        # spherical interpolation between the two directions
        a = self.normalise()
        b = other.normalise()
        d = max(-1.0, min(1.0, a.dot(b)))
        theta = math.acos(d)
        if theta < 1e-12:
            return self.lerp(other, t)
        s = math.sin(theta)
        wa = math.sin((1.0 - t) * theta) / s
        wb = math.sin(t * theta) / s
        v = Vector3D(
            wa * a.x + wb * b.x, wa * a.y + wb * b.y, wa * a.z + wb * b.z
        )
        # interpolate magnitudes too
        mag = self.length + t * (other.length - self.length)
        return v.normalise() * mag

    def orthogonal(self):
        """An arbitrary unit vector orthogonal to this vector (vector.pyx)."""
        if abs(self.x) < abs(self.y):
            if abs(self.x) < abs(self.z):
                axis = Vector3D(1.0, 0.0, 0.0)
            else:
                axis = Vector3D(0.0, 0.0, 1.0)
        else:
            if abs(self.y) < abs(self.z):
                axis = Vector3D(0.0, 1.0, 0.0)
            else:
                axis = Vector3D(0.0, 0.0, 1.0)
        return self.cross(axis).normalise()

    def angle(self, other):
        """Angle between two vectors in degrees."""
        d = self.dot(other) / (self.length * other.length)
        return math.degrees(math.acos(max(-1.0, min(1.0, d))))

    def copy(self):
        return Vector3D(self.x, self.y, self.z)

    def as_point3d(self):
        return Point3D(self.x, self.y, self.z)

    def as_normal3d(self):
        return Normal3D(self.x, self.y, self.z)


class Normal3D(Vector3D):
    """Surface normal; transforms with the inverse-transpose (normal.pyx:38)."""

    __slots__ = ()

    def __neg__(self):
        return Normal3D(-self.x, -self.y, -self.z)

    def cross(self, other):
        v = Vector3D.cross(self, other)
        return v

    def normalise(self):
        length = self.length
        if length == 0.0:
            raise ZeroDivisionError("A zero length normal cannot be normalised.")
        inv = 1.0 / length
        return Normal3D(self.x * inv, self.y * inv, self.z * inv)

    def transform(self, m):
        """Transform with the supplied matrix assumed to be the INVERSE of the
        coordinate transform, applied transposed (normal.pyx semantics)."""
        return Normal3D(
            m.m[0][0] * self.x + m.m[1][0] * self.y + m.m[2][0] * self.z,
            m.m[0][1] * self.x + m.m[1][1] * self.y + m.m[2][1] * self.z,
            m.m[0][2] * self.x + m.m[1][2] * self.y + m.m[2][2] * self.z,
        )

    def transform_with_inverse(self, m_inv):
        return self.transform(m_inv)

    def as_vector3d(self):
        return Vector3D(self.x, self.y, self.z)

    def copy(self):
        return Normal3D(self.x, self.y, self.z)


class Point3D(_Vec3):
    """A 3D point (point.pyx:39)."""

    __slots__ = ()

    def __add__(self, other):
        if isinstance(other, Vector3D):
            return Point3D(self.x + other.x, self.y + other.y, self.z + other.z)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Vector3D):
            return Point3D(self.x - other.x, self.y - other.y, self.z - other.z)
        if isinstance(other, Point3D):
            # point - point -> vector from other to self
            return Vector3D(self.x - other.x, self.y - other.y, self.z - other.z)
        return NotImplemented

    def __mul__(self, m):
        return NotImplemented

    def vector_to(self, other):
        return Vector3D(other.x - self.x, other.y - self.y, other.z - self.z)

    def distance_to(self, other):
        dx = other.x - self.x
        dy = other.y - self.y
        dz = other.z - self.z
        return math.sqrt(dx * dx + dy * dy + dz * dz)

    def transform(self, m):
        """Full affine transform including translation (point.pyx)."""
        return Point3D(
            m.m[0][0] * self.x + m.m[0][1] * self.y + m.m[0][2] * self.z + m.m[0][3],
            m.m[1][0] * self.x + m.m[1][1] * self.y + m.m[1][2] * self.z + m.m[1][3],
            m.m[2][0] * self.x + m.m[2][1] * self.y + m.m[2][2] * self.z + m.m[2][3],
        )

    def copy(self):
        return Point3D(self.x, self.y, self.z)

    def as_vector3d(self):
        return Vector3D(self.x, self.y, self.z)


class Vector2D:
    """A 2D vector (vector.pyx:607). Default-constructs to the x unit
    vector (vector.pyx:630)."""

    __slots__ = ("x", "y")

    def __init__(self, x=1.0, y=0.0):
        self.x = float(x)
        self.y = float(y)

    def __repr__(self):
        return f"Vector2D({self.x}, {self.y})"

    def __iter__(self):
        yield self.x
        yield self.y

    def __getitem__(self, i):
        return (self.x, self.y)[i]

    def __eq__(self, other):
        if isinstance(other, Vector2D):
            return self.x == other.x and self.y == other.y
        return NotImplemented

    def __neg__(self):
        return Vector2D(-self.x, -self.y)

    def __add__(self, other):
        if isinstance(other, (Vector2D, Point2D)):
            return Vector2D(self.x + other.x, self.y + other.y)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, (Vector2D, Point2D)):
            return Vector2D(self.x - other.x, self.y - other.y)
        return NotImplemented

    def __mul__(self, m):
        if isinstance(m, (int, float)):
            return Vector2D(self.x * m, self.y * m)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, d):
        if isinstance(d, (int, float)):
            if d == 0.0:
                raise ZeroDivisionError("Cannot divide a vector by zero.")
            inv = 1.0 / d
            return Vector2D(self.x * inv, self.y * inv)
        return NotImplemented

    @property
    def length(self):
        return math.sqrt(self.x * self.x + self.y * self.y)

    def dot(self, other):
        return self.x * other.x + self.y * other.y

    def cross(self, other):
        return self.x * other.y - self.y * other.x

    def normalise(self):
        length = self.length
        if length == 0.0:
            raise ZeroDivisionError("A zero length vector cannot be normalised.")
        inv = 1.0 / length
        return Vector2D(self.x * inv, self.y * inv)

    def orthogonal(self):
        return Vector2D(-self.y, self.x)


class Point2D:
    """A 2D point (point.pyx:356)."""

    __slots__ = ("x", "y")

    def __init__(self, x=0.0, y=0.0):
        self.x = float(x)
        self.y = float(y)

    def __repr__(self):
        return f"Point2D({self.x}, {self.y})"

    def __iter__(self):
        yield self.x
        yield self.y

    def __getitem__(self, i):
        return (self.x, self.y)[i]

    def __eq__(self, other):
        if isinstance(other, Point2D):
            return self.x == other.x and self.y == other.y
        return NotImplemented

    def __add__(self, other):
        if isinstance(other, Vector2D):
            return Point2D(self.x + other.x, self.y + other.y)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Vector2D):
            return Point2D(self.x - other.x, self.y - other.y)
        if isinstance(other, Point2D):
            return Vector2D(self.x - other.x, self.y - other.y)
        return NotImplemented

    def vector_to(self, other):
        return Vector2D(other.x - self.x, other.y - self.y)

    def distance_to(self, other):
        dx = other.x - self.x
        dy = other.y - self.y
        return math.sqrt(dx * dx + dy * dy)

    def copy(self):
        return Point2D(self.x, self.y)
