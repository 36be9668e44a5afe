"""Triangle-mesh geometry: host container, BVH build, serialization.

Counterpart of source_tpu/primitive/mesh/data.py (the reference's MeshData,
raysect/primitive/mesh/mesh.pyx:142: float32 vertices and triangles,
optional per-vertex normals, smoothing, closed, flip_normals; padded
per-triangle AABBs :467-504; a saved bundle :864-1046). The geometry is
immutable once built and shared between Mesh instances; the BVH is built on
the host (accel/bvh.py, the same native builder as the JAX package's, so both
build the same tree) and the bundle goes to the device as ``MeshTables``.

The JAX package also packs the TPU's 16-lane VMEM records and pages
(``pack_mesh_host``/``pack_mesh_paged_host``); they are not carried. The
CUDA kernel reads records of its own, packed from the tables by
``to_tables`` (tracer/mesh_bvh.py ``pack_mesh_records``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...accel.bvh import FlatBVH, build_bvh

__all__ = ["MeshData"]

_BOX_PADDING = 1e-6  # relative AABB padding (mesh.pyx:467-504)


class MeshData:
    """Immutable triangle-mesh geometry and its built BVH (host side)."""

    def __init__(self, vertices, triangles, normals=None, smoothing=True,
                 closed=False, flip_normals=False, max_leaf=4):
        vertices = np.ascontiguousarray(vertices, np.float32)
        triangles = np.ascontiguousarray(triangles, np.int32)
        if vertices.ndim != 2 or vertices.shape[1] != 3:
            raise ValueError("vertices must be [V,3]")
        if triangles.ndim != 2 or triangles.shape[1] not in (3, 6):
            raise ValueError("triangles must be [T,3] (or [T,6] with normal ids)")
        if triangles.shape[1] == 6:  # the reference's explicit normal ids
            normal_ids = triangles[:, 3:6]
            triangles = triangles[:, :3]
        else:
            normal_ids = None
        if triangles.size and (triangles.min() < 0 or triangles.max() >= len(vertices)):
            raise ValueError("triangle vertex index out of range")

        self.vertices = vertices
        self.smoothing = bool(smoothing)
        self.closed = bool(closed)

        v0 = vertices[triangles[:, 0]]
        v1 = vertices[triangles[:, 1]]
        v2 = vertices[triangles[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        area2 = np.linalg.norm(fn, axis=-1)
        fn_unit = fn / np.maximum(area2, 1e-30)[:, None]
        if flip_normals:
            triangles = triangles[:, ::-1].copy()
            fn_unit = -fn_unit
            fn = -fn

        # per-vertex normals: explicit, else the area-weighted average
        # (smoothing), else none
        if normals is not None:
            normals = np.ascontiguousarray(normals, np.float32)
            if normal_ids is not None:
                vn = np.zeros_like(vertices)
                np.add.at(vn, triangles.ravel(), normals[normal_ids.ravel()])
            else:
                vn = normals
            vn = vn / np.maximum(np.linalg.norm(vn, axis=-1), 1e-30)[:, None]
        elif self.smoothing:
            vn = np.zeros_like(vertices)
            for c in range(3):
                np.add.at(vn, triangles[:, c], fn)  # area-weighted (|fn| = 2A)
            vn = vn / np.maximum(np.linalg.norm(vn, axis=-1), 1e-30)[:, None]
        else:
            vn = np.zeros_like(vertices)

        # padded per-triangle AABBs -> BVH; the geometry is stored permuted
        # into leaf order, so a leaf is a contiguous range of triangles
        tri_pts = np.stack([v0, v1, v2], axis=1)
        lo = tri_pts.min(axis=1)
        hi = tri_pts.max(axis=1)
        pad = _BOX_PADDING * np.maximum(1.0, np.abs(tri_pts).max(axis=(1, 2)))[:, None]
        bvh = self.bvh = build_bvh(lo - pad, hi + pad, max_leaf=max_leaf)
        self.triangles = triangles[bvh.order]
        self.face_normals = fn_unit[bvh.order].astype(np.float32)
        self.vertex_normals = vn
        self.max_leaf = int(max(1, bvh.max_leaf_size))

    @property
    def n_vertices(self):
        return int(self.vertices.shape[0])

    @property
    def n_triangles(self):
        return int(self.triangles.shape[0])

    def local_aabb(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    # --- serialization (the reference's .rsm, mesh.pyx:864-1046) ----------------

    def save(self, path):
        """Save the geometry and the built BVH to an .npz bundle."""
        np.savez_compressed(
            path,
            vertices=self.vertices,
            triangles=self.triangles,
            face_normals=self.face_normals,
            vertex_normals=self.vertex_normals,
            node_lo=self.bvh.node_lo,
            node_hi=self.bvh.node_hi,
            node_skip=self.bvh.node_skip,
            node_first=self.bvh.node_first,
            node_count=self.bvh.node_count,
            order=self.bvh.order,
            flags=np.asarray([self.smoothing, self.closed, self.max_leaf], np.int32),
        )

    @classmethod
    def load(cls, path):
        """Load a bundle written by save() without rebuilding the BVH."""
        z = np.load(path)
        obj = cls.__new__(cls)
        obj.vertices = z["vertices"]
        obj.triangles = z["triangles"]
        obj.face_normals = z["face_normals"]
        obj.vertex_normals = z["vertex_normals"]
        obj.bvh = FlatBVH(
            node_lo=z["node_lo"], node_hi=z["node_hi"], node_skip=z["node_skip"],
            node_first=z["node_first"], node_count=z["node_count"], order=z["order"],
        )
        flags = z["flags"]
        obj.smoothing = bool(flags[0])
        obj.closed = bool(flags[1])
        obj.max_leaf = int(flags[2])
        return obj

    def to_tables(self, w2l, l2w, dtype=None, device="cpu"):
        """The device ``MeshTables`` of one instance transform."""
        from ...tracer.meshtrace import MeshTables

        dtype = torch.float32 if dtype is None else dtype

        def ten(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        tables = MeshTables(
            vertices=ten(self.vertices),
            triangles=ten(self.triangles, torch.int32),
            face_normals=ten(self.face_normals),
            vertex_normals=ten(self.vertex_normals),
            node_lo=ten(self.bvh.node_lo),
            node_hi=ten(self.bvh.node_hi),
            node_skip=ten(self.bvh.node_skip, torch.int32),
            node_first=ten(self.bvh.node_first, torch.int32),
            node_count=ten(self.bvh.node_count, torch.int32),
            w2l=ten(w2l),
            l2w=ten(l2w),
            n_nodes=self.bvh.n_nodes,
            max_leaf=self.max_leaf,
            smoothing=self.smoothing,
            closed=self.closed,
        )
        tables.records.current(tables)
        return tables
