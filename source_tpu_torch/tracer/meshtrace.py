"""Nearest triangle hit on one mesh: tables, plain version, gradient.

Counterpart of source_tpu/tracer/meshtrace.py (the reference's mesh trace
chain, raysect/primitive/mesh/mesh.pyx:506-713: a kd-tree descent and the
watertight Woop test). Rays walk the mesh's threaded BVH (accel/bvh.py)
without a stack, one node pointer per ray,

    next = (slab hit and inner node) ? node + 1 : skip[node]

until they leave the tree; a leaf's triangles are tested in order with the
Woop test (tracer/watertight.py) and the strict ``t < t_best``, so ties fall
to the first triangle in node order.

``mesh_intersect`` is the entry point. For CUDA tensors it launches the
hand-written kernel (tracer/mesh_bvh.py, csrc/mesh_bvh.cu), whose
nearest-child-first walk over packed records returns the same winners, or
raises; for CPU tensors it runs ``mesh_intersect_plain``, this walk
vectorised over lanes. Its gradient re-solves the Moller-Trumbore system of
each ray's winning triangle (``_winners``), as the reference's custom VJP
does: the walk only selects which triangle reaches the output, and the
selection is piecewise constant.

``t`` is in the caller's parameter units: the local-frame direction is not
renormalised, so local hits share the world ray parameter (mesh.pyx:1178).

Not carried: the TPU's all-pairs dense formulation (``_mesh_intersect_dense``,
``mesh_forest_intersect``, ``DENSE_TRI_LIMIT``), an MXU form of the same
nearest hit: every mesh goes through the kernel, whatever its size; and
``mesh_hit_count``, which nothing in the reference calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.math import batch as vmath
from .mesh_bvh import MeshRecords, mesh_bvh_winner
from .watertight import woop_setup, woop_tri_test

__all__ = ["MeshTables", "mesh_intersect", "mesh_intersect_plain"]

_INF = float("inf")
_BIG = 3e38


@dataclasses.dataclass
class MeshTables:
    """One mesh instance on a device: geometry and threaded BVH, and the
    kernel's records packed from them (``records``, a ``MeshRecords``
    shared by copies, packed again when a table changes). The vertices
    are a scene parameter (the gradient reaches them)."""

    vertices: Any  # f32[V,3] local frame
    triangles: Any  # i32[T,3] in BVH leaf order
    face_normals: Any  # f32[T,3] unit, in BVH leaf order
    vertex_normals: Any  # f32[V,3] unit (zeros when smoothing is off)
    node_lo: Any  # f32[NN,3]
    node_hi: Any  # f32[NN,3]
    node_skip: Any  # i32[NN]
    node_first: Any  # i32[NN]
    node_count: Any  # i32[NN]
    w2l: Any  # f32[4,4] world -> local
    l2w: Any  # f32[4,4]
    n_nodes: int = 0
    max_leaf: int = 4
    smoothing: bool = True
    closed: bool = False
    records: Any = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.records is None:
            self.records = MeshRecords()

    @property
    def n_triangles(self):
        return int(self.triangles.shape[0])


def _safe_inv(x):
    """The traversal's reciprocal: 3e38 (sign dropped) where |x| <= 1e-12,
    so a ray parallel to a slab still tests it finitely."""
    ok = torch.abs(x) > 1e-12
    return torch.where(ok, torch.reciprocal(torch.where(ok, x, 1.0)), _BIG)


def _slab_test(lo, hi, o, inv_d, t_max):
    """AABB slab test per lane over component lists; entry beyond t_max is a
    miss."""
    t0 = [(lo[k] - o[k]) * inv_d[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv_d[k] for k in range(3)]
    t_near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                        torch.maximum(t0[1], t1[1])),
                          torch.maximum(t0[2], t1[2]))
    return (t_far >= torch.clamp(t_near, min=0.0)) & (t_near < t_max)


def _tri_test(v0, v1, v2, o, d, t_min, tol=1e-6):
    """Moller-Trumbore with an epsilon pad: (t, u, v, front, valid). The
    differentiable re-solve of an already chosen triangle; the hit decisions
    are the Woop test's."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = vmath.cross(d, e2)
    det = vmath.dot(e1, p)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, torch.reciprocal(torch.where(ok, det, 1.0)), 0.0)
    tv = o - v0
    u = vmath.dot(tv, p) * inv
    q = vmath.cross(tv, e1)
    v = vmath.dot(d, q) * inv
    t = vmath.dot(e2, q) * inv
    valid = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol) & (t > t_min)
    return t, u, v, det > 0.0, valid


def mesh_intersect_plain(mesh: MeshTables, origin, direction, t_min,
                         t_max=None):
    """Plain PyTorch version of the kernel (the reference's
    ``_mesh_intersect_xla``): the stackless walk vectorised over the lanes
    still in the tree. Returns t (+inf on a miss), tri (-1 on a miss), u, v,
    front, per ray the nodes visited (``nodes_visited``) and triangles
    tested (``tris_tested``), and per table record whether any ray read it
    (``nodes_touched`` bool[n_nodes], ``tris_touched`` bool[n_triangles])."""
    N = origin.shape[0]
    dev = origin.device
    o_all = origin.unbind(1)
    d_all = direction.unbind(1)
    inv_all = [_safe_inv(x) for x in d_all]
    setup_all = woop_setup(*o_all, *d_all)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    t_best = (torch.full((N,), _INF, dtype=origin.dtype, device=dev)
              if t_max is None else t_max.clone())
    tri_best = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(N, dtype=origin.dtype, device=dev)
    v_best = torch.zeros(N, dtype=origin.dtype, device=dev)
    front_best = torch.zeros(N, dtype=torch.bool, device=dev)
    nodes_visited = torch.zeros(N, dtype=torch.int32, device=dev)
    tris_tested = torch.zeros(N, dtype=torch.int32, device=dev)
    nodes_touched = torch.zeros(mesh.n_nodes, dtype=torch.bool, device=dev)
    tris_touched = torch.zeros(mesh.triangles.shape[0], dtype=torch.bool,
                               device=dev)
    lo_t, hi_t = mesh.node_lo.unbind(1), mesh.node_hi.unbind(1)
    skip_t = mesh.node_skip.long()
    first_t = mesh.node_first.long()
    count_t = mesh.node_count.long()
    tris = mesh.triangles.long()
    vx, vy, vz = mesh.vertices.unbind(1)
    slots = torch.arange(int(mesh.max_leaf), device=dev)
    while True:
        act = torch.nonzero(node < mesh.n_nodes).squeeze(1)
        if act.numel() == 0:
            break
        nodes_visited[act] += 1
        nd = node[act]
        nodes_touched[nd] = True
        o = [x[act] for x in o_all]
        hit_box = _slab_test([x[nd] for x in lo_t], [x[nd] for x in hi_t], o,
                             [x[act] for x in inv_all], t_best[act])
        count = count_t[nd]
        leaf = hit_box & (count > 0)
        if bool(leaf.any()):
            # every (lane, slot k < count) pair of the leaves hit, tested at
            # once; the updates then go slot by slot, in the kernel's order
            lanes, cnt = act[leaf], count[leaf]
            tris_tested[lanes] += cnt.to(torch.int32)
            pair = slots[None, :] < cnt[:, None]
            lane_k = lanes[:, None].expand_as(pair)[pair]
            k_of = slots[None, :].expand_as(pair)[pair]
            tri_id = (first_t[nd[leaf]][:, None] + slots[None, :])[pair]
            tris_touched[tri_id] = True
            abc = tris[tri_id]
            s = {key: x[lane_k] for key, x in setup_all.items()}
            vs = [c[abc[:, j]] for j in range(3) for c in (vx, vy, vz)]
            t, u, v, front, valid = woop_tri_test(s, *vs, t_min[lane_k])
            for k in range(int(cnt.max())):
                m = (k_of == k) & valid
                ln = lane_k[m]
                better = t[m] < t_best[ln]
                up, sel = ln[better], torch.nonzero(m).squeeze(1)[better]
                t_best[up] = t[sel]
                tri_best[up] = tri_id[sel].to(torch.int32)
                u_best[up] = u[sel]
                v_best[up] = v[sel]
                front_best[up] = front[sel]
        node[act] = torch.where(hit_box & (count == 0), nd + 1, skip_t[nd])
    return {"t": torch.where(tri_best >= 0, t_best, _INF), "tri": tri_best,
            "u": u_best, "v": v_best, "front": front_best,
            "nodes_visited": nodes_visited, "tris_tested": tris_tested,
            "nodes_touched": nodes_touched, "tris_touched": tris_touched}


_KEYS = ("t", "tri", "u", "v", "front")


def _nearest(mesh, origin, direction, t_min, t_max):
    """The kernel for CUDA tensors (or raise), the plain version for CPU
    tensors."""
    if origin.is_cuda:
        return mesh_bvh_winner(mesh, origin, direction, t_min, t_max)
    out = mesh_intersect_plain(mesh, origin, direction, t_min, t_max)
    return {k: out[k] for k in _KEYS}


def _winners(mesh, vertices, origin, direction, t_min, win_tri):
    """The Moller-Trumbore solve of each lane's winning triangle, as
    differentiable tensor ops: (t, u, v) with +inf / 0 on a miss."""
    hit = win_tri >= 0
    tri = mesh.triangles.long()[torch.clamp(win_tri, min=0).long()]
    t, u, v, _, _ = _tri_test(vertices[tri[:, 0]], vertices[tri[:, 1]],
                              vertices[tri[:, 2]], origin, direction, t_min)
    return (torch.where(hit, t, _INF), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0))


class _MeshIntersect(torch.autograd.Function):
    """Nearest hit forward; backward through the winners' re-solve (the
    reference's ``_winners_bwd``)."""

    @staticmethod
    def forward(ctx, vertices, origin, direction, t_min, t_max, mesh):
        tables = dataclasses.replace(mesh, vertices=vertices.detach())
        out = _nearest(tables, origin.detach().contiguous(),
                       direction.detach().contiguous(),
                       t_min.detach().contiguous(),
                       None if t_max is None else t_max.detach().contiguous())
        ctx.mesh = mesh
        ctx.save_for_backward(vertices, origin, direction, t_min, out["tri"])
        ctx.mark_non_differentiable(out["tri"], out["front"])
        return tuple(out[k] for k in _KEYS)

    @staticmethod
    def backward(ctx, g_t, _g_tri, g_u, g_v, _g_front):
        vertices, origin, direction, t_min, win_tri = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        inputs = [x.detach().requires_grad_(w)
                  for x, w in zip((vertices, origin, direction), want)]
        with torch.enable_grad():
            outs = _winners(ctx.mesh, *inputs, t_min, win_tri)
            found = iter(torch.autograd.grad(
                outs, [x for x, w in zip(inputs, want) if w], (g_t, g_u, g_v)))
        return (*[next(found) if w else None for w in want], None, None, None)


def mesh_intersect(mesh: MeshTables, origin, direction, t_min, t_max=None):
    """Nearest triangle hit for a batch of local-frame rays.

    ``origin``/``direction`` f32[N,3] (direction NOT normalised: t is in the
    caller's units), ``t_min`` f32[N] the minimum advance, ``t_max``
    optional f32[N] (a hit must lie strictly before it). Returns a dict:
    t f32[N] (+inf on a miss), tri i32[N] (-1 on a miss, BVH leaf order),
    u, v f32[N] (point = A + u(B-A) + v(C-A)), front bool[N] (det > 0).
    t, u and v are differentiable in ``mesh.vertices``, ``origin`` and
    ``direction`` through the winning triangle."""
    return dict(zip(_KEYS, _MeshIntersect.apply(
        mesh.vertices, origin, direction, t_min, t_max, mesh)))
