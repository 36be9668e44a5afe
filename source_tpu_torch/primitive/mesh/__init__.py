"""Triangle meshes: geometry, BVH, primitive node, file IO."""

from .data import MeshData
from .mesh import Mesh, MeshIntersection
from .io import (
    PLY_ASCII, PLY_AUTOMATIC, PLY_BINARY,
    STL_ASCII, STL_AUTOMATIC, STL_BINARY,
    VTK_ASCII, VTK_AUTOMATIC, VTK_BINARY,
    export_obj, export_ply, export_rsm, export_stl, export_vtk,
    import_obj, import_ply, import_rsm, import_stl, import_vtk,
)

__all__ = [
    "Mesh", "MeshData", "MeshIntersection",
    "import_obj", "export_obj", "import_stl", "export_stl",
    "import_ply", "export_ply", "import_vtk", "export_vtk",
    "import_rsm", "export_rsm",
    "STL_ASCII", "STL_BINARY", "STL_AUTOMATIC",
    "PLY_ASCII", "PLY_BINARY", "PLY_AUTOMATIC",
    "VTK_ASCII", "VTK_BINARY", "VTK_AUTOMATIC",
]
