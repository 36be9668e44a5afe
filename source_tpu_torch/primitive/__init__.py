"""Geometry primitives (reference raysect/primitive)."""

from .shapes import Sphere, Box, Cylinder, Cone, Parabola, Torus
from .csg import CSGPrimitive, Union, Intersect, Subtract
from .mesh import (
    Mesh, MeshData, MeshIntersection,
    export_obj, export_ply, export_stl, export_vtk,
    import_obj, import_ply, import_stl, import_vtk,
    PLY_ASCII, PLY_AUTOMATIC, PLY_BINARY,
    STL_ASCII, STL_AUTOMATIC, STL_BINARY,
    VTK_ASCII, VTK_AUTOMATIC, VTK_BINARY,
)
from .utility import EncapsulatedPrimitive
from .lens import BiConvex, BiConcave, PlanoConvex, PlanoConcave, Meniscus

__all__ = [
    "Sphere", "Box", "Cylinder", "Cone", "Parabola", "Torus",
    "CSGPrimitive", "Union", "Intersect", "Subtract",
    "Mesh", "MeshData", "MeshIntersection", "EncapsulatedPrimitive",
    "BiConvex", "BiConcave", "PlanoConvex", "PlanoConcave", "Meniscus",
    "import_obj", "export_obj", "import_stl", "export_stl",
    "import_ply", "export_ply", "import_vtk", "export_vtk",
    "STL_ASCII", "STL_BINARY", "STL_AUTOMATIC",
    "PLY_ASCII", "PLY_BINARY", "PLY_AUTOMATIC",
    "VTK_ASCII", "VTK_BINARY", "VTK_AUTOMATIC",
]
