"""The mesh nearest-hit kernel: records, build, load, launch.

``mesh_bvh_winner`` launches csrc/mesh_bvh.cu, the hand-written CUDA kernel
that replaces both TPU mesh kernels of the JAX package,
source_tpu/tracer/pallas_mesh.py:192 ``_kernel`` (K7, a mesh whose packed
tables fit the TPU's VMEM) and :369 ``_paged_kernel`` (K8, the same hit for a
larger mesh cut into pages with private BVHs). Paging exists because the
tables do not fit VMEM; on the card a 1.31M-triangle mesh's records (about
90 MB) sit in device memory, so both are one walk over one BVH. The TPU's
ray->page sort has no counterpart: on an H100 a coherence sort of the rays
takes longer than it saves the kernel (PERF.md, Findings), so the wrapper
launches on the rays in the callers' order.

The kernel reads records packed from the mesh's threaded BVH
(``pack_mesh_records``): one 64-B row per inner node holding both children's
boxes and references, and one 48-B row per triangle holding its three
vertices in leaf order. It walks nearest child first with a per-thread
stack, under the order-free rule that a hit wins when (t, triangle id) is
lexicographically smaller and a box is pruned only when its entry lies
strictly beyond the best t; so its winner is the threaded walk's, the first
nearest triangle in leaf order. ``MeshRecords`` keeps the records beside a
``MeshTables`` and packs them again when its vertices change.

The specification is ``meshtrace.mesh_intersect_plain`` (the threaded walk),
the entry point that routes CPU tensors to it and carries the gradient
``meshtrace.mesh_intersect``. ``ordered_walk_plain`` is the kernel's own walk
vectorised over lanes, for holding the kernel to it lane by lane and for
counting the records it fetches; the main path does not run it.
"""

from __future__ import annotations

import ctypes

import torch

from . import fused as _f
from .watertight import woop_setup, woop_tri_test

__all__ = ["MeshRecords", "STACK", "build_library", "mesh_bvh_winner",
           "ordered_walk_plain", "pack_mesh_records"]

STACK = 64  # entries a thread may park; _lib() checks the library's own
_library = None


def _as_f32(x):
    """Integers as the bits of a float32 column."""
    return x.to(torch.int32).view(torch.float32)[:, None]


def pack_mesh_records(mesh):
    """The kernel's records of one ``MeshTables``, in plain torch on its
    device: (nodes f32[R,16], tris f32[T,12], depth).

    ``nodes`` row 0 holds the root's box as child 0 (child 1 unused); row
    r >= 1 holds the r-th inner node of the threaded BVH (in its DFS order)
    as child 0's lo, hi, child 1's lo, hi, four float4s. The children of
    threaded node n are n + 1 and skip[n + 1]. A child's lo.w is its
    reference as int bits (its row if it is inner, else ~first of its leaf
    range), its hi.w its triangle count (0 for an inner node). ``tris`` holds
    each triangle's vertices a, b, c as three float4s (w = 0), in leaf order.
    ``depth`` is the tree's depth in edges, the most entries a walk parks;
    raises ValueError where it exceeds ``STACK``."""
    count = mesh.node_count.long()
    skip = mesh.node_skip.long()
    inner = count == 0
    row = torch.cumsum(inner.long(), 0)
    ref = torch.where(inner, row, ~mesh.node_first.long())

    def child(c):
        return torch.cat([mesh.node_lo[c].float(), _as_f32(ref[c]),
                          mesh.node_hi[c].float(), _as_f32(count[c])], 1)

    c0 = torch.nonzero(inner).squeeze(1) + 1
    root = child(torch.zeros(1, dtype=torch.long, device=count.device))
    nodes = torch.cat([torch.cat([root, torch.zeros_like(root)], 1),
                       torch.cat([child(c0), child(skip[c0])], 1)])
    v = mesh.vertices.float()[mesh.triangles.long()]
    tris = torch.cat([v, torch.zeros_like(v[..., :1])], 2).reshape(-1, 12)
    depth, level = 0, torch.zeros(1, dtype=torch.long, device=count.device)
    while True:
        level = level[inner[level]] + 1
        if level.numel() == 0:
            break
        level = torch.cat([level, skip[level]])
        depth += 1
    if depth > STACK:
        raise ValueError(f"mesh BVH depth {depth} exceeds the kernel's stack "
                         f"of {STACK}")
    return nodes.contiguous(), tris.contiguous(), depth


_PACKED_FROM = ("vertices", "triangles", "node_lo", "node_hi", "node_skip",
                "node_first", "node_count")


class MeshRecords:
    """The records of ``pack_mesh_records`` for one mesh, kept beside its
    ``MeshTables`` and packed again whenever a table they came from (the
    vertices, the triangles or a BVH table) has been swapped, moved or edited
    in place (keyed on each tensor's ``data_ptr()`` and ``_version``, which
    ``detach()`` shares). An edit through ``tensor.data`` bumps no
    ``_version`` and is not seen: whoever edits so gives the tables a fresh
    ``MeshRecords``. Copies of the tables made by ``dataclasses.replace``
    share this object, so a repacking is seen by all of them."""

    def __init__(self):
        self.nodes = self.tris = None
        self.depth = 0
        self._key = None

    def current(self, mesh):
        """These records, packed again first if a table they came from
        changed."""
        tables = [getattr(mesh, name) for name in _PACKED_FROM]
        key = (mesh.vertices.device,
               *[(x.data_ptr(), x._version) for x in tables])
        if key != self._key:
            self.nodes, self.tris, self.depth = pack_mesh_records(mesh)
            self._key = key
        return self

    @property
    def nbytes(self):
        """Device bytes the records take."""
        return 4 * (self.nodes.numel() + self.tris.numel())


def _slab(lo, hi, o, inv_d, t_best):
    """The kernel's slab test per lane over component lists: (hit, entry
    distance); a box entered at t_best still hits (a tie survives)."""
    t0 = [(lo[k] - o[k]) * inv_d[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv_d[k] for k in range(3)]
    t_near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                        torch.maximum(t0[1], t1[1])),
                          torch.maximum(t0[2], t1[2]))
    return (t_far >= torch.clamp(t_near, min=0.0)) & (t_near <= t_best), t_near


def ordered_walk_plain(records, origin, direction, t_min, t_max=None):
    """The kernel's walk in plain PyTorch, vectorised over the lanes still
    walking, each with its own stack: the same records, slab and Woop
    arithmetic, visit order and tie rule, so t, tri, u, v and front equal
    the kernel's bit for bit. Returns those and, per ray, the node rows
    fetched (``node_fetches``, the root's counted), the leaves fetched
    (``leaf_fetches``), the triangles tested (``tris_tested``) and the
    32-B sectors those fetches span (``sectors``: the root's half row one,
    a row two, a leaf of c triangles ceil(48 c / 32)); and the records read
    at least once (``rows_touched`` bool[R], ``tris_touched`` bool[T])."""
    from .meshtrace import _safe_inv
    N = origin.shape[0]
    dev = origin.device
    o = origin.unbind(1)
    d = direction.unbind(1)
    inv = [_safe_inv(x) for x in d]
    setup = woop_setup(*o, *d)
    nodes, tris = records.nodes, records.tris
    bits = nodes.view(torch.int32)
    t_best = (torch.full((N,), float("inf"), device=dev) if t_max is None
              else t_max.clone())
    tri_best = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(N, device=dev)
    v_best = torch.zeros(N, device=dev)
    front_best = torch.zeros(N, dtype=torch.bool, device=dev)
    counts = {k: torch.zeros(N, dtype=torch.int32, device=dev)
              for k in ("node_fetches", "leaf_fetches", "tris_tested",
                        "sectors")}
    counts["node_fetches"] += 1
    counts["sectors"] += 1
    rows_touched = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
    rows_touched[0] = True
    tris_touched = torch.zeros(tris.shape[0], dtype=torch.bool, device=dev)
    depth = max(int(records.depth), 1)
    stack_ref = torch.zeros((N, depth), dtype=torch.int32, device=dev)
    stack_count = torch.zeros_like(stack_ref)
    stack_t = torch.zeros((N, depth), device=dev)
    sp = torch.zeros(N, dtype=torch.long, device=dev)
    walking, _ = _slab(nodes[0, 0:3], nodes[0, 4:7], o, inv, t_best)
    ref = bits[0, 3].expand(N).clone()
    count = bits[0, 7].expand(N).clone()
    while True:
        act = torch.nonzero(walking).squeeze(1)
        if act.numel() == 0:
            break
        is_inner = ref[act] > 0
        pop = [act[~is_inner]]
        lanes = act[is_inner]
        if lanes.numel():
            counts["node_fetches"][lanes] += 1
            counts["sectors"][lanes] += 2
            rows, rb = nodes[ref[lanes].long()], bits[ref[lanes].long()]
            rows_touched[ref[lanes].long()] = True
            ol, il = [x[lanes] for x in o], [x[lanes] for x in inv]
            h0, t0 = _slab(rows[:, 0:3].unbind(1), rows[:, 4:7].unbind(1), ol,
                           il, t_best[lanes])
            h1, t1 = _slab(rows[:, 8:11].unbind(1), rows[:, 12:15].unbind(1),
                           ol, il, t_best[lanes])
            second = t1 < t0  # the nearer first; child 0 on a tie
            both = h0 & h1
            b, sb, pos = lanes[both], second[both], sp[lanes[both]]
            stack_ref[b, pos] = torch.where(sb, rb[both, 3], rb[both, 11])
            stack_count[b, pos] = torch.where(sb, rb[both, 7], rb[both, 15])
            stack_t[b, pos] = torch.where(sb, t0[both], t1[both])
            sp[b] += 1
            go1 = (both & second) | (~h0 & h1)
            go = h0 | h1
            ref[lanes[go]] = torch.where(go1, rb[:, 11], rb[:, 3])[go]
            count[lanes[go]] = torch.where(go1, rb[:, 15], rb[:, 7])[go]
            pop.append(lanes[~go])
        leaves = pop[0]
        if leaves.numel():
            cnt = count[leaves]
            counts["leaf_fetches"][leaves] += 1
            counts["tris_tested"][leaves] += cnt
            counts["sectors"][leaves] += (48 * cnt + 31) // 32
            slots = torch.arange(int(cnt.max()), device=dev)
            pair = slots[None, :] < cnt[:, None]
            lane_k = leaves[:, None].expand_as(pair)[pair]
            k_of = slots[None, :].expand_as(pair)[pair]
            tri_id = ((~ref[leaves]).long()[:, None] + slots[None, :])[pair]
            rec = tris[tri_id]
            tris_touched[tri_id] = True
            s = {key: x[lane_k] for key, x in setup.items()}
            vs = [rec[:, 4 * j + k] for j in range(3) for k in range(3)]
            t, u, v, front, valid = woop_tri_test(s, *vs, t_min[lane_k])
            for k in range(int(slots.numel())):
                m = (k_of == k) & valid
                ln, tk, idk = lane_k[m], t[m], tri_id[m]
                better = (tk < t_best[ln]) | ((tk == t_best[ln])
                                              & (idk < tri_best[ln]))
                up, sel = ln[better], torch.nonzero(m).squeeze(1)[better]
                t_best[up] = t[sel]
                tri_best[up] = tri_id[sel].to(torch.int32)
                u_best[up] = u[sel]
                v_best[up] = v[sel]
                front_best[up] = front[sel]
        # the nearest parked box not beyond t_best, or the walk ends
        lanes = torch.cat(pop)
        walking[lanes] = False
        while lanes.numel():
            lanes = lanes[sp[lanes] > 0]
            sp[lanes] -= 1
            top = sp[lanes]
            keep = stack_t[lanes, top] <= t_best[lanes]
            k = lanes[keep]
            ref[k] = stack_ref[k, top[keep]]
            count[k] = stack_count[k, top[keep]]
            walking[k] = True
            lanes = lanes[~keep]
    return {"t": torch.where(tri_best >= 0, t_best, float("inf")),
            "tri": tri_best, "u": u_best, "v": v_best, "front": front_best,
            "rows_touched": rows_touched, "tris_touched": tris_touched,
            **counts}


def build_library(verbose=False):
    """Compile csrc/mesh_bvh.cu into ``_build/`` (if the source is newer than
    the library); returns (library path, compiler log)."""
    return _f.nvcc_build("mesh_bvh.cu", (), "libmesh_bvh.so", (), verbose)


def _lib():
    global _library
    if _library is None:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # o, d, t_min, t_max (or NULL), N, nodes, tris, out t, tri, u, v,
        # front, stream
        lib.mesh_bvh_winner.argtypes = [p, p, p, p, i, p, p] + [p] * 6
        lib.mesh_bvh_winner.restype = i
        lib.mesh_bvh_stack.argtypes = []
        lib.mesh_bvh_stack.restype = i
        if lib.mesh_bvh_stack() != STACK:
            raise RuntimeError(
                f"{path}: the kernel's stack holds {lib.mesh_bvh_stack()} "
                f"entries, the packer checks depths against {STACK}")
        _library = lib
    return _library


def _launch(mesh, o, d, t_min, t_max=None):
    """One launch on rays in the order given; raw records (front as i32)."""
    N = o.shape[0]
    dev = o.device
    rec = mesh.records.current(mesh)
    f32 = [("origin", o), ("direction", d), ("t_min", t_min),
           ("nodes", rec.nodes), ("tris", rec.tris)]
    if t_max is not None:
        f32.append(("t_max", t_max))
    for name, t in f32:
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous float32 tensor on "
                             f"{dev}")
    if (tuple(o.shape) != (N, 3) or tuple(d.shape) != (N, 3)
            or tuple(t_min.shape) != (N,)
            or (t_max is not None and tuple(t_max.shape) != (N,))):
        raise ValueError("rays must be [N,3], t_min and t_max [N]")
    out = {"t": torch.empty(N, dtype=torch.float32, device=dev),
           "tri": torch.empty(N, dtype=torch.int32, device=dev),
           "u": torch.empty(N, dtype=torch.float32, device=dev),
           "v": torch.empty(N, dtype=torch.float32, device=dev),
           "front": torch.empty(N, dtype=torch.int32, device=dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().mesh_bvh_winner(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
            None if t_max is None else t_max.data_ptr(), N,
            rec.nodes.data_ptr(), rec.tris.data_ptr(),
            *[out[k].data_ptr() for k in ("t", "tri", "u", "v", "front")],
            stream)
    if err != 0:
        raise RuntimeError(f"mesh_bvh_winner: CUDA launch failed with error "
                           f"{err}")
    mesh_bvh_winner.launches += 1
    return out


def mesh_bvh_winner(mesh, origin, direction, t_min, t_max=None):
    """Nearest hit of CUDA rays on one mesh by the kernel: t, tri, u, v,
    front as ``meshtrace.mesh_intersect`` returns them. Raises for tensors
    not on a CUDA device (the plain versions are
    ``meshtrace.mesh_intersect_plain`` and ``ordered_walk_plain``)."""
    if not origin.is_cuda:
        raise ValueError("mesh_bvh_winner launches the CUDA kernel: the rays "
                         "must be CUDA tensors")
    out = _launch(mesh, origin, direction, t_min, t_max)
    out["front"] = out["front"] > 0
    return out


mesh_bvh_winner.launches = 0
