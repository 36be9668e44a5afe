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
from .colour import (
    ciexyz_x, ciexyz_y, ciexyz_z, resample_ciexyz, spectrum_to_ciexyz,
    spectra_to_ciexyz, ciexyz_to_srgb, srgb_to_ciexyz, d65_white,
)
from .ray import Ray
from .loggingray import LoggingRay

__all__ = [
    "Vector3D", "Point3D", "Normal3D", "AffineMatrix3D", "translate",
    "rotate", "rotate_x", "rotate_y", "rotate_z", "rotate_vector",
    "rotate_basis", "Node", "World",
    "Spectrum", "SpectralFunction", "InterpolatedSF", "ConstantSF",
    "NumericallyIntegratedSF", "photon_energy",
    "ciexyz_x", "ciexyz_y", "ciexyz_z", "resample_ciexyz",
    "spectrum_to_ciexyz", "spectra_to_ciexyz", "ciexyz_to_srgb",
    "srgb_to_ciexyz", "d65_white",
    "Ray", "LoggingRay",
]
