"""Geometry primitives (reference raysect/primitive)."""

from .shapes import Sphere, Box, Cylinder, Cone, Parabola, Torus
from .csg import CSGPrimitive, Union, Intersect, Subtract
from .mesh import Mesh, MeshData

__all__ = ["Sphere", "Box", "Cylinder", "Cone", "Parabola", "Torus",
           "CSGPrimitive", "Union", "Intersect", "Subtract", "Mesh", "MeshData"]
