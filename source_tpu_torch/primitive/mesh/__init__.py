"""Triangle meshes: geometry, BVH and the primitive node."""

from .data import MeshData
from .mesh import Mesh, MeshIntersection

__all__ = ["Mesh", "MeshData", "MeshIntersection"]
