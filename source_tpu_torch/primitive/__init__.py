"""Geometry primitives (reference raysect/primitive)."""

from .shapes import Sphere, Box, Cylinder, Cone, Parabola, Torus
from .csg import CSGPrimitive, Union, Intersect, Subtract
from .mesh import Mesh, MeshData, MeshIntersection
from .utility import EncapsulatedPrimitive
from .lens import BiConvex, BiConcave, PlanoConvex, PlanoConcave, Meniscus

__all__ = ["Sphere", "Box", "Cylinder", "Cone", "Parabola", "Torus",
           "CSGPrimitive", "Union", "Intersect", "Subtract", "Mesh", "MeshData",
           "MeshIntersection", "EncapsulatedPrimitive",
           "BiConvex", "BiConcave", "PlanoConvex", "PlanoConcave", "Meniscus"]
