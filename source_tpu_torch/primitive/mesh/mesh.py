"""Mesh primitive: a scenegraph node over shared MeshData.

Counterpart of source_tpu/primitive/mesh/mesh.py (the reference's
Mesh(Primitive), raysect/primitive/mesh/mesh.pyx:1090-1390): it carries a
transform and a material and shares its geometry between instances
(``instance``, :1162). The scene compiler sees ``is_mesh`` and emits a mesh
entity with its ``MeshTables`` instead of analytic leaves.
``MeshIntersection`` is what ``World.hit`` returns for a mesh hit.
"""

from __future__ import annotations

import numpy as np

from ...core.intersection import Intersection
from ...core.math.vector import Point3D
from ...core.scenegraph.node import Primitive
from ..shapes import _transform_aabb
from .data import MeshData

__all__ = ["Mesh", "MeshIntersection"]


class MeshIntersection(Intersection):
    """Intersection specialised for triangle meshes (reference
    primitive/mesh/mesh.pyx MeshIntersection): adds the winning triangle
    index and the barycentric coordinates (u, v, w) of the hit so shading
    code can interpolate per-vertex attributes."""

    def __init__(self, ray, ray_distance, primitive, hit_point, inside_point,
                 outside_point, normal, exiting, world_to_primitive,
                 primitive_to_world, triangle=-1, u=0.0, v=0.0, w=0.0):
        super().__init__(
            ray, ray_distance, primitive, hit_point, inside_point,
            outside_point, normal, exiting, world_to_primitive,
            primitive_to_world,
        )
        self.triangle = triangle
        self.u = u
        self.v = v
        self.w = w


class Mesh(Primitive):
    """Triangle-mesh primitive (instances share geometry and BVH)."""

    is_mesh = True

    def __init__(self, vertices=None, triangles=None, normals=None,
                 smoothing=True, closed=False, flip_normals=False,
                 parent=None, transform=None, material=None, name=None,
                 mesh_data=None):
        if mesh_data is not None:
            self._data = mesh_data
        else:
            if vertices is None or triangles is None:
                raise ValueError("Mesh requires vertices+triangles or mesh_data.")
            self._data = MeshData(
                vertices, triangles, normals=normals, smoothing=smoothing,
                closed=closed, flip_normals=flip_normals,
            )
        super().__init__(parent, transform, material, name)

    @property
    def data(self):
        return self._data

    def instance(self, parent=None, transform=None, material=None, name=None):
        """A new node sharing this mesh's geometry and BVH (mesh.pyx:1162)."""
        return Mesh(
            mesh_data=self._data, parent=parent, transform=transform,
            material=material or self.material, name=name,
        )

    def bounding_box_world(self, world_transform):
        lo, hi = self._data.local_aabb()
        return _transform_aabb(lo, hi, world_transform)

    def bounding_box(self):
        return self.bounding_box_world(self.to_root())

    def bounding_sphere(self):
        lo, hi = self.bounding_box()
        centre = 0.5 * (np.asarray(lo) + np.asarray(hi))
        radius = 0.5 * float(np.linalg.norm(np.asarray(hi) - np.asarray(lo)))
        return Point3D(*centre), radius * 1.0001

    def save(self, path):
        self._data.save(path)

    @classmethod
    def load(cls, path, parent=None, transform=None, material=None, name=None):
        return cls(mesh_data=MeshData.load(path), parent=parent,
                   transform=transform, material=material, name=name)

    def __repr__(self):
        return f"<Mesh: {self.name} ({self._data.n_triangles} tris)>"
