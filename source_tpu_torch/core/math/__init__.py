"""Math substrate: host vector types + per-ray tensor helpers."""

from .vector import Vector3D, Point3D, Normal3D, Vector2D, Point2D
from .affinematrix import AffineMatrix3D
from .transform import (
    translate, rotate_x, rotate_y, rotate_z, rotate_vector, rotate,
    rotate_basis, to_cylindrical, from_cylindrical, extract_rotation,
    extract_translation,
)
from .units import (
    kilometre, metre, centimetre, millimetre, micrometre, nanometre,
    mile, yard, foot, inch, mil, degree, radian, km, cm, mm, um, nm,
)
from . import interp, polyroots

__all__ = [
    "Vector3D", "Point3D", "Normal3D", "Vector2D", "Point2D",
    "AffineMatrix3D",
    "translate", "rotate_x", "rotate_y", "rotate_z", "rotate_vector",
    "rotate", "rotate_basis", "to_cylindrical", "from_cylindrical",
    "extract_rotation", "extract_translation",
    "kilometre", "metre", "centimetre", "millimetre", "micrometre",
    "nanometre", "mile", "yard", "foot", "inch", "mil", "degree", "radian",
    "km", "cm", "mm", "um", "nm",
    "interp", "polyroots",
]
