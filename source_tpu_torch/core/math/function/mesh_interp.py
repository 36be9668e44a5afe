"""Unstructured-mesh interpolators (triangle / tetrahedral).

Counterpart of source_tpu/core/math/function/mesh_interp.py (the
reference's raysect/core/math/function/float/function2d/interpolate/
interpolator2dmesh.pyx:40 ``Interpolator2DMesh``, barycentric interpolation
over a triangle mesh with kd-tree point location; discrete2dmesh.pyx:39
``Discrete2DMesh``; function3d/.../discrete3dmesh.pyx:39 ``Discrete3DMesh``,
tetrahedral).

As in the JAX package, point location is a host-built uniform grid: each
query hashes to a grid cell and tests that cell's candidate list (padded
with -1 to the longest, K) for barycentric containment, and the first
candidate slot that contains the point wins. The JAX package tests all K
slots at once; here the slots are tested in chunks, each chunk only for the
queries still unresolved whose cell has candidates left, so the memory of a
call stays bounded when one cell holds many cells' worth of candidates (in
a tetrahedralised sphere every tetrahedron shares the centre vertex, and
one cell holds them all). Any chunk size gives the same answer.

The tables are float32 (int32 for indices), one copy per device; a call
evaluates on its queries' device, or for numbers and numpy arrays on the
interpolator's ``device`` (the card unless it was made with
``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Function2D, Function3D, as_tensors

__all__ = ["Interpolator2DMesh", "Discrete2DMesh", "Discrete3DMesh"]

# bytes of temporaries a (query, candidate slot) pair costs in a chunk (its
# gathered vertices, edges, cross products, barycentrics and masks); a chunk
# takes as many slots as fit CHUNK_BYTES for the queries still unresolved
SLOT_BYTES = 320
CHUNK_BYTES = 1 << 30
_TOL = 1e-9


def _build_grid2d(vertices, triangles, cells_hint=None):
    """Host: bin triangles into a uniform grid. Returns (origin, inv_cell,
    shape, cand[cells, K] padded with -1)."""
    tri_pts = vertices[triangles]  # [T,3,2]
    lo = tri_pts.min(axis=(0, 1))
    hi = tri_pts.max(axis=(0, 1))
    span = np.maximum(hi - lo, 1e-12)
    T = len(triangles)
    res = cells_hint or max(1, int(np.sqrt(T / 2)))
    shape = (res, res)
    cell = span / np.asarray(shape)
    bins = [[] for _ in range(res * res)]
    t_lo = tri_pts.min(axis=1)
    t_hi = tri_pts.max(axis=1)
    for t in range(T):
        i0 = np.clip(((t_lo[t] - lo) / cell).astype(int), 0, res - 1)
        i1 = np.clip(((t_hi[t] - lo) / cell).astype(int), 0, res - 1)
        for ix in range(i0[0], i1[0] + 1):
            for iy in range(i0[1], i1[1] + 1):
                bins[ix * res + iy].append(t)
    return lo, 1.0 / cell, shape, _pad_bins(bins)


def _build_grid3d(vertices, tetrahedra):
    """Host: bin tetrahedra into a uniform res^3 grid, res ~ (T/4)^(1/3).
    Returns (origin, inv_cell, res, cand[cells, K] padded with -1)."""
    tet_pts = vertices[tetrahedra]  # [T,4,3]
    lo = tet_pts.min(axis=(0, 1))
    hi = tet_pts.max(axis=(0, 1))
    span = np.maximum(hi - lo, 1e-12)
    T = len(tetrahedra)
    res = max(1, int(round((T / 4) ** (1.0 / 3.0))))
    cell = span / res
    bins = [[] for _ in range(res ** 3)]
    t_lo = tet_pts.min(axis=1)
    t_hi = tet_pts.max(axis=1)
    for k in range(T):
        i0 = np.clip(((t_lo[k] - lo) / cell).astype(int), 0, res - 1)
        i1 = np.clip(((t_hi[k] - lo) / cell).astype(int), 0, res - 1)
        for ix in range(i0[0], i1[0] + 1):
            for iy in range(i0[1], i1[1] + 1):
                for iz in range(i0[2], i1[2] + 1):
                    bins[(ix * res + iy) * res + iz].append(k)
    return lo, 1.0 / cell, res, _pad_bins(bins)


def _pad_bins(bins):
    K = max(1, max(len(b) for b in bins))
    cand = np.full((len(bins), K), -1, np.int32)
    for c, b in enumerate(bins):
        cand[c, : len(b)] = b
    return cand


class _GridLocator:
    """Per-device tables and the chunked first-containing-slot search shared
    by the mesh interpolators. Subclasses hand ``_init_tables`` their
    host arrays (at least ``cand``, ``grid_lo``, ``grid_inv``) and
    implement ``_cell_of`` and ``_barycentric``."""

    def _on(self, device):
        tabs = self._tables.get(device)
        if tabs is None:
            tabs = {k: v.to(device) for k, v in self._host.items()}
            self._tables[device] = tabs
        return tabs

    def _init_tables(self, device, **arrays):
        self.device = device
        self._host = {k: torch.as_tensor(v) for k, v in arrays.items()}
        self._host["cell_count"] = (self._host["cand"] >= 0).sum(1).to(torch.int32)
        self._tables = {torch.device("cpu"): self._host}

    def _locate(self, q):
        """(first containing candidate per query or -1, its barycentrics
        [P, nb]) for flat queries q [P, dim], testing as many candidate
        slots a pass as fit CHUNK_BYTES."""
        t = self._on(q.device)
        cell, off_grid = self._cell_of(t, q)
        cand_all = t["cand"]
        K = cand_all.shape[1]
        P = q.shape[0]
        found_id = torch.full((P,), -1, dtype=torch.int32, device=q.device)
        bary = torch.zeros((P, self._n_bary), dtype=q.dtype, device=q.device)
        # queries still searched: on the grid, with candidates in their cell
        live = torch.nonzero(~off_grid & (t["cell_count"][cell] > 0)).squeeze(1)
        start = 0
        while start < K and live.numel():
            k = max(1, CHUNK_BYTES // (SLOT_BYTES * live.numel()))
            k = min(k, K - start)
            cand = cand_all[:, start:start + k][cell[live]]  # [L, k]
            b = self._barycentric(t, cand, q[live])  # nb x [L, k]
            inside = cand >= 0
            for bi in b:
                inside &= bi >= -_TOL
            # the first slot of the chunk that contains the query
            hit = inside.any(1)
            first = torch.argmax(inside.to(torch.uint8), dim=1)[:, None]
            lanes = live[hit]
            found_id[lanes] = torch.gather(cand, 1, first)[hit, 0]
            bary[lanes] = torch.stack(
                [torch.gather(bi, 1, first)[hit, 0] for bi in b], dim=-1)
            start += k
            keep = ~hit & (t["cell_count"][cell[live]] > start)
            live = live[keep]
        return found_id, bary


class _TriMeshBase(_GridLocator):
    """Shared triangle-mesh location machinery."""

    _n_bary = 3

    def __init__(self, vertex_coords, triangles, limit, default_value, device):
        v = np.asarray(vertex_coords, np.float64)
        t = np.asarray(triangles, np.int32)
        if v.ndim != 2 or v.shape[1] != 2:
            raise ValueError("vertex_coords must be [V,2].")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError("triangles must be [T,3].")
        self.limit = bool(limit)
        self.default_value = float(default_value)
        lo, inv_cell, shape, cand = _build_grid2d(v, t)
        self._grid_shape = shape
        self._init_tables(device, v=v.astype(np.float32), t=t,
                          grid_lo=lo.astype(np.float32),
                          grid_inv=inv_cell.astype(np.float32), cand=cand)

    def _cell_of(self, t, q):
        cell = torch.floor((q - t["grid_lo"]) * t["grid_inv"]).to(torch.int32)
        rx, ry = self._grid_shape
        off_grid = ((cell[:, 0] < 0) | (cell[:, 0] >= rx)
                    | (cell[:, 1] < 0) | (cell[:, 1] >= ry))
        cidx = (torch.clamp(cell[:, 0], 0, rx - 1) * ry
                + torch.clamp(cell[:, 1], 0, ry - 1))
        return cidx.long(), off_grid

    def _barycentric(self, t, cand, q):
        """Barycentrics (triangle.pyx:104 semantics), 0 where degenerate."""
        tri = t["t"][torch.clamp(cand, 0, t["t"].shape[0] - 1).long()].long()
        p0 = t["v"][tri[..., 0]]
        p1 = t["v"][tri[..., 1]]
        p2 = t["v"][tri[..., 2]]
        d = q[:, None, :]
        v0 = p1 - p0
        v1 = p2 - p0
        v2 = d - p0
        den = v0[..., 0] * v1[..., 1] - v1[..., 0] * v0[..., 1]
        ok = torch.abs(den) > 1e-300
        inv = torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)
        b1 = (v2[..., 0] * v1[..., 1] - v1[..., 0] * v2[..., 1]) * inv
        b2 = (v0[..., 0] * v2[..., 1] - v2[..., 0] * v0[..., 1]) * inv
        b0 = 1.0 - b1 - b2
        # a degenerate candidate never contains the query
        return b0, b1, torch.where(ok, b2, -1.0)

    def _query(self, x, y):
        x, y = as_tensors((x, y), self.device)
        x, y = torch.broadcast_tensors(x.float(), y.float())
        q = torch.stack([x, y], dim=-1).reshape(-1, 2)
        tri_id, bary = self._locate(q)
        return x.shape, tri_id, bary


class Interpolator2DMesh(Function2D, _TriMeshBase):
    """Barycentric interpolation of per-vertex data over a triangle mesh
    (interpolator2dmesh.pyx:40). Outside the mesh: default_value if
    ``limit`` is False, else NaN (the reference raises)."""

    def __init__(self, vertex_coords, vertex_data, triangles, limit=True,
                 default_value=0.0, device=None):
        data = np.asarray(vertex_data, np.float64)
        if data.shape[0] != np.asarray(vertex_coords).shape[0]:
            raise ValueError("vertex_data must match vertex_coords length.")
        _TriMeshBase.__init__(self, vertex_coords, triangles, limit,
                              default_value, device)
        self._host["data"] = torch.as_tensor(data.astype(np.float32))

    def __call__(self, x, y):
        shape, tri_id, bary = self._query(x, y)
        t = self._on(tri_id.device)
        tri = t["t"][torch.clamp(tri_id, 0, t["t"].shape[0] - 1).long()].long()
        data = t["data"]
        val = (bary[:, 0] * data[tri[:, 0]] + bary[:, 1] * data[tri[:, 1]]
               + bary[:, 2] * data[tri[:, 2]])
        missing = torch.nan if self.limit else self.default_value
        return torch.where(tri_id >= 0, val, missing).reshape(shape)


class Discrete2DMesh(Function2D, _TriMeshBase):
    """Per-triangle constant values over a triangle mesh
    (discrete2dmesh.pyx:39)."""

    def __init__(self, vertex_coords, triangles, triangle_data, limit=True,
                 default_value=0.0, device=None):
        data = np.asarray(triangle_data, np.float64)
        if data.shape[0] != np.asarray(triangles).shape[0]:
            raise ValueError("triangle_data must match triangles length.")
        _TriMeshBase.__init__(self, vertex_coords, triangles, limit,
                              default_value, device)
        self._host["data"] = torch.as_tensor(data.astype(np.float32))

    def __call__(self, x, y):
        shape, tri_id, _ = self._query(x, y)
        data = self._on(tri_id.device)["data"]
        val = data[torch.clamp(tri_id, 0, data.shape[0] - 1).long()]
        missing = torch.nan if self.limit else self.default_value
        return torch.where(tri_id >= 0, val, missing).reshape(shape)


class Discrete3DMesh(Function3D, _GridLocator):
    """Per-tetrahedron constant values over a tet mesh
    (discrete3dmesh.pyx:39): barycentric containment of the grid-binned
    candidate tetrahedra, the first that contains the query wins."""

    _n_bary = 4

    def __init__(self, vertex_coords, tetrahedra, tetrahedra_data, limit=True,
                 default_value=0.0, device=None):
        v = np.asarray(vertex_coords, np.float64)
        t = np.asarray(tetrahedra, np.int32)
        if v.ndim != 2 or v.shape[1] != 3:
            raise ValueError("vertex_coords must be [V,3].")
        if t.ndim != 2 or t.shape[1] != 4:
            raise ValueError("tetrahedra must be [T,4].")
        data = np.asarray(tetrahedra_data, np.float64)
        self.limit = bool(limit)
        self.default_value = float(default_value)
        lo, inv_cell, res, cand = _build_grid3d(v, t)
        self._res = res
        self._init_tables(device, v=v.astype(np.float32), t=t,
                          data=data.astype(np.float32),
                          grid_lo=lo.astype(np.float32),
                          grid_inv=inv_cell.astype(np.float32), cand=cand)

    def _cell_of(self, t, q):
        res = self._res
        cell = torch.floor((q - t["grid_lo"]) * t["grid_inv"]).to(torch.int32)
        off_grid = torch.any((cell < 0) | (cell >= res), dim=-1)
        cc = torch.clamp(cell, 0, res - 1)
        return ((cc[:, 0] * res + cc[:, 1]) * res + cc[:, 2]).long(), off_grid

    def _barycentric(self, t, cand, q):
        """Barycentrics by the 3x3 solve of the JAX package
        (tetrahedra.pyx:129 semantics); a degenerate candidate never
        contains the query."""
        tet = t["t"][torch.clamp(cand, 0, t["t"].shape[0] - 1).long()].long()
        v = t["v"]
        p0 = v[tet[..., 0]]
        e1 = v[tet[..., 1]] - p0
        e2 = v[tet[..., 2]] - p0
        e3 = v[tet[..., 3]] - p0
        d = q[:, None, :] - p0
        c23 = torch.linalg.cross(e2, e3, dim=-1)
        det = torch.sum(e1 * c23, dim=-1)
        ok = torch.abs(det) > 1e-300
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        b1 = torch.sum(d * c23, dim=-1) * inv
        b2 = torch.sum(e1 * torch.linalg.cross(d, e3, dim=-1), dim=-1) * inv
        b3 = torch.sum(e1 * torch.linalg.cross(e2, d, dim=-1), dim=-1) * inv
        b0 = 1.0 - b1 - b2 - b3
        return b0, b1, b2, torch.where(ok, b3, -1.0)

    def locate(self, x, y, z):
        """The tetrahedron containing each point (-1 outside the mesh), in
        the shape of the broadcast coordinates."""
        x, y, z = as_tensors((x, y, z), self.device)
        x, y, z = torch.broadcast_tensors(x.float(), y.float(), z.float())
        q = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
        return self._locate(q)[0].reshape(x.shape)

    def __call__(self, x, y, z):
        tet_id = self.locate(x, y, z)
        data = self._on(tet_id.device)["data"]
        val = data[torch.clamp(tet_id, 0, data.shape[0] - 1).long()]
        missing = torch.nan if self.limit else self.default_value
        return torch.where(tet_id >= 0, val, missing)
