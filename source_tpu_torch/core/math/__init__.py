"""Math substrate: host vector types + per-ray tensor helpers."""

from .vector import Vector3D, Point3D, Normal3D, Vector2D, Point2D
from .affinematrix import AffineMatrix3D
from .quaternion import Quaternion
from .transform import (
    translate, rotate_x, rotate_y, rotate_z, rotate_vector, rotate,
    rotate_basis, to_cylindrical, from_cylindrical, extract_rotation,
    extract_translation,
)
from .statsarray import StatsBin, StatsArray1D, StatsArray2D, StatsArray3D
from .sampler import (
    SolidAngleSampler, SphereSampler, HemisphereUniformSampler,
    HemisphereCosineSampler, ConeUniformSampler,
    DiskSampler3D, RectangleSampler3D, TriangleSampler3D,
    TargetedHemisphereSampler, TargetedSphereSampler,
)
from .units import (
    kilometre, metre, centimetre, millimetre, micrometre, nanometre,
    mile, yard, foot, inch, mil, degree, radian, km, cm, mm, um, nm,
)
from .triangle import (
    barycentric_coords, barycentric_coords_tetra, barycentric_interpolation,
    barycentric_interpolation_tetra, barycentric_inside_tetrahedra,
    barycentric_inside_triangle, inside_tetrahedra, inside_triangle,
    point_inside_polygon, winding2d,
)
from .polygon import triangulate2d
from .spatial import Item2D, Item3D, KDTree2D, KDTree3D
from . import batch, random, interp, polyroots, triangle

__all__ = [
    "Vector3D", "Point3D", "Normal3D", "Vector2D", "Point2D",
    "AffineMatrix3D", "Quaternion",
    "translate", "rotate_x", "rotate_y", "rotate_z", "rotate_vector",
    "rotate", "rotate_basis", "to_cylindrical", "from_cylindrical",
    "extract_rotation", "extract_translation",
    "StatsBin", "StatsArray1D", "StatsArray2D", "StatsArray3D",
    "SolidAngleSampler", "SphereSampler", "HemisphereUniformSampler",
    "HemisphereCosineSampler", "ConeUniformSampler",
    "DiskSampler3D", "RectangleSampler3D", "TriangleSampler3D",
    "TargetedHemisphereSampler", "TargetedSphereSampler",
    "kilometre", "metre", "centimetre", "millimetre", "micrometre",
    "nanometre", "mile", "yard", "foot", "inch", "mil", "degree", "radian",
    "km", "cm", "mm", "um", "nm",
    "inside_triangle", "barycentric_coords", "barycentric_inside_triangle",
    "barycentric_interpolation", "inside_tetrahedra",
    "barycentric_coords_tetra", "barycentric_inside_tetrahedra",
    "barycentric_interpolation_tetra", "winding2d", "point_inside_polygon",
    "triangulate2d",
    "Item2D", "Item3D", "KDTree2D", "KDTree3D",
    "batch", "random", "interp", "polyroots", "triangle",
]
