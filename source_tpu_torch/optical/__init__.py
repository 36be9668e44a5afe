"""Optical physics layer (reference raysect/optical)."""

from ..core import (
    Vector3D, Point3D, Normal3D, AffineMatrix3D, translate, rotate,
    rotate_x, rotate_y, rotate_z, rotate_vector, rotate_basis, Node,
)
from ..core.scenegraph import World
from .spectrum import (
    Spectrum, SpectralFunction, InterpolatedSF, ConstantSF,
    NumericallyIntegratedSF, photon_energy,
)

__all__ = [
    "Vector3D", "Point3D", "Normal3D", "AffineMatrix3D", "translate",
    "rotate", "rotate_x", "rotate_y", "rotate_z", "rotate_vector",
    "rotate_basis", "Node", "World",
    "Spectrum", "SpectralFunction", "InterpolatedSF", "ConstantSF",
    "NumericallyIntegratedSF", "photon_energy",
]
