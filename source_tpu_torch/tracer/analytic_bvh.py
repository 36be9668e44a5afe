"""Nearest hit over analytic leaves on a threaded SAH BVH: tables, plain
version and the CUDA kernel.

Counterpart of source_tpu/tracer/pallas_analytic.py (the reference's
primitive kd-tree, raysect/core/acceleration/kdtree.pyx:41-180): rays walk a
world-space SAH BVH over the leaf AABBs and test only the items whose bounds
they enter, instead of every leaf. The items are

  * simple leaves of the six analytic types, each tested in its own local
    frame (the 3x4 world->local rows ride the record);
  * world-space fast records: a rigid (+ uniform scale) sphere as a world
    sphere (``KT_SPHERE_W``), a rotation-free box as a world AABB
    (``KT_BOX_W``);
  * small CSG entities (``KT_CSG``, up to ``MAX_CSG_CHILD`` convex children):
    every boundary of the solid lies on an endpoint of a child's ray
    interval, so the postfix program evaluated just before and just after
    each endpoint finds the entity's first crossing with no sorting.

``pack_leaf_bvh_host`` builds the tables on the host: row-major node
records f32[n_nodes, 9] (AABB, skip, first, count), item records
f32[n_items, 23] and CSG rows f32[n_csg, 127], the same tables the JAX
package builds. ``analytic_bvh_winner`` is the entry point: for CUDA tensors
it launches the hand-written kernel ``analytic_bvh_winner``
(csrc/analytic_bvh.cu, one ray per thread, a stackless walk along the skip
pointers) or raises; for CPU tensors it runs ``analytic_bvh_winner_plain``,
the same walk vectorised over lanes with one node pointer per lane. Both
keep the reference's node order and its strict ``t < t_best`` update, so
ties fall as in the reference. The winner is an argmin, piecewise constant:
nothing here carries a gradient (the differentiable path recomputes the
winner's crossing, tracer/intersect.py).

The torus is a BVH type (its quartic is the fused kernel's); a torus child
still sends its CSG entity to the streaming resolve, since a torus can meet
a ray in two intervals (``CSG_CHILD_TYPES``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..compiler.scene import _program_to_closure
from ..primitive.analytic import (
    TYPE_BOX,
    TYPE_CONE,
    TYPE_CYLINDER,
    TYPE_PARABOLA,
    TYPE_SPHERE,
    TYPE_TORUS,
)
from . import fused as _f

__all__ = ["BVH_TYPES", "CSG_CHILD_TYPES", "KT_SPHERE_W", "KT_BOX_W",
           "KT_CSG", "MAX_CSG_CHILD", "pack_leaf_bvh_host",
           "analytic_bvh_winner", "analytic_bvh_winner_plain",
           "build_library"]

# types the kernel evaluates inline
BVH_TYPES = (TYPE_SPHERE, TYPE_BOX, TYPE_CYLINDER, TYPE_CONE, TYPE_PARABOLA,
             TYPE_TORUS)
# small-CSG children are ONE convex ray interval each: convex types only
CSG_CHILD_TYPES = (TYPE_SPHERE, TYPE_BOX, TYPE_CYLINDER, TYPE_CONE,
                   TYPE_PARABOLA)

# kernel record types beyond the six analytic ones
KT_SPHERE_W = 6  # rigid (+ uniform scale) sphere: [cx, cy, cz, r_world]
KT_BOX_W = 7     # rotation-free box: world AABB [lo3, hi3]
KT_CSG = 8       # small-CSG entity: [csg row, signature]
MAX_CSG_CHILD = 6

# the reference's ceiling on the node + item + CSG tables (its kernel keeps
# them in the TPU's scalar memory); above it both packages stream instead,
# so they take the same route for the same scene
TABLE_BUDGET_BYTES = 192 * 1024
_BIG = 3e38
# rays per packet tile of the reference: below it no ray sort
_TILE = 1024

# csg table row: [n_children | child0 (gid + 12 w2l + 8 params) | child1 ...]
_CSG_CHILD_FIELDS = 21
_CSG_ROW = 1 + MAX_CSG_CHILD * _CSG_CHILD_FIELDS
# kernel signature record (int32): [n_children, n_ops, child types x6,
# (op, arg) x 12]; csrc/analytic_bvh.cu repeats it
_SIG_WORDS = 32
_MAX_OPS = 12


def _local_aabb(type_id, p):
    """Local-frame AABB of one analytic leaf from its param block."""
    if type_id == TYPE_SPHERE:
        r = p[0]
        return (-r, -r, -r), (r, r, r)
    if type_id == TYPE_BOX:
        return (p[0], p[1], p[2]), (p[3], p[4], p[5])
    if type_id in (TYPE_CYLINDER, TYPE_CONE, TYPE_PARABOLA):
        r, h = p[0], p[1]
        return (-r, -r, 0.0), (r, r, h)
    if type_id == TYPE_TORUS:
        R, r = p[0], p[1]
        return (-(R + r), -(R + r), -r), (R + r, R + r, r)
    raise ValueError(f"Unknown analytic type {type_id}")


def _world_aabb(type_id, l2w, params):
    """World AABB of one analytic leaf (8 transformed local corners)."""
    llo, lhi = _local_aabb(int(type_id), np.asarray(params))
    cs = np.array([[x, y, z] for x in (llo[0], lhi[0])
                   for y in (llo[1], lhi[1]) for z in (llo[2], lhi[2])],
                  np.float64)
    wc = cs @ np.asarray(l2w)[:3, :3].T + np.asarray(l2w)[:3, 3]
    return wc.min(axis=0), wc.max(axis=0)


def pack_leaf_bvh_host(leaf_types, l2w, w2l, params, leaf_ids,
                       leaf_entities=None, max_leaf=4, csg_items=()):
    """SAH BVH over the world AABBs of the given items plus BVH-ordered
    record tables.

    Simple items: ``leaf_types`` int[n] (all in BVH_TYPES), ``l2w``/``w2l``
    f64[n,4,4], ``params`` f64[n,8], ``leaf_ids`` int[n] the GLOBAL leaf
    index of each row (the kernel's output), ``leaf_entities`` int[n].
    Small-CSG items (``csg_items``): (entity_id, program, children) with
    children = [(gid, type_id, l2w, w2l, params), ...], at most
    MAX_CSG_CHILD convex children; the boolean solid is ONE BVH item.

    Returns (tables dict of f32 numpy arrays "nodes", "leaves", "csg", meta)
    or (None, None) when ineligible; meta = (n_nodes, max_leaf,
    present_types, root_lo, root_hi, present_orig, csg_sigs), csg_sigs the
    distinct (program, child_types) signatures.
    """
    from ..accel.bvh import build_bvh

    n = len(leaf_ids)
    n_csg = len(csg_items)
    n_items = n + n_csg
    if n_items == 0 or n_items >= (1 << 24):
        return None, None
    table_bytes = ((2 * n_items + 1) * 9 * 4 + n_items * 23 * 4
                   + max(1, n_csg) * _CSG_ROW * 4)
    if table_bytes > TABLE_BUDGET_BYTES:
        return None, None

    lo = np.empty((n_items, 3), np.float64)
    hi = np.empty((n_items, 3), np.float64)
    for i in range(n):
        lo[i], hi[i] = _world_aabb(leaf_types[i], l2w[i], params[i])
    # csg item AABB: union of the children's (conservative for every op)
    sig_index = {}
    csg_sigs = []
    csg_rows = np.zeros((max(1, n_csg), _CSG_ROW), np.float64)
    csg_rec = np.zeros((max(1, n_csg), 3), np.float64)  # row, sig, entity
    for j, (entity_id, program, children) in enumerate(csg_items):
        clo = None
        chi = None
        for (gid, tid, cl2w, cw2l, cp) in children:
            a, b = _world_aabb(tid, cl2w, cp)
            clo = a if clo is None else np.minimum(clo, a)
            chi = b if chi is None else np.maximum(chi, b)
        lo[n + j] = clo
        hi[n + j] = chi
        key = (tuple(program), tuple(int(c[1]) for c in children))
        if key not in sig_index:
            sig_index[key] = len(csg_sigs)
            csg_sigs.append(key)
        csg_rows[j, 0] = len(children)
        for c, (gid, tid, cl2w, cw2l, cp) in enumerate(children):
            base = 1 + c * _CSG_CHILD_FIELDS
            csg_rows[j, base] = gid
            csg_rows[j, base + 1: base + 13] = np.asarray(cw2l)[:3, :].reshape(12)
            csg_rows[j, base + 13: base + 21] = np.asarray(cp)[:8]
        csg_rec[j] = (j, sig_index[key], entity_id)

    pad = 1e-6 * np.maximum(1.0, np.abs(np.stack([lo, hi])).max(axis=(0, 2)))
    bvh = build_bvh((lo - pad[:, None]).astype(np.float32),
                    (hi + pad[:, None]).astype(np.float32), max_leaf=max_leaf)
    order = np.asarray(bvh.order)

    w2l_a = (np.asarray(w2l, np.float64).reshape(n, 4, 4)
             if n else np.zeros((0, 4, 4)))
    l2w_a = (np.asarray(l2w, np.float64).reshape(n, 4, 4)
             if n else np.zeros((0, 4, 4)))
    params_a = (np.asarray(params, np.float64).reshape(n, -1)
                if n else np.zeros((0, 8)))
    ents_a = (np.zeros(n) if leaf_entities is None
              else np.asarray(leaf_entities, np.float64))
    leaves = np.zeros((n_items, 23), np.float64)
    types_o = np.zeros(n_items, np.int64)
    for row, item in enumerate(order):
        if item < n:
            i = int(item)
            tid = int(leaf_types[i])
            R = l2w_a[i][:3, :3]
            G = R.T @ R
            s2 = G[0, 0]
            if tid == TYPE_SPHERE and np.allclose(
                    G, s2 * np.eye(3), rtol=1e-6, atol=1e-9 * max(1.0, s2)):
                leaves[row, :3] = l2w_a[i][:3, 3]
                leaves[row, 3] = np.sqrt(s2) * params_a[i][0]
                tid = KT_SPHERE_W
            elif tid == TYPE_BOX:
                nz = np.abs(R) > 1e-9 * max(1.0, np.abs(R).max())
                if (nz.sum(axis=0) == 1).all() and (nz.sum(axis=1) == 1).all():
                    cs = np.array([
                        [x, y, z]
                        for x in (params_a[i][0], params_a[i][3])
                        for y in (params_a[i][1], params_a[i][4])
                        for z in (params_a[i][2], params_a[i][5])])
                    wc = cs @ R.T + l2w_a[i][:3, 3]
                    leaves[row, :3] = wc.min(axis=0)
                    leaves[row, 3:6] = wc.max(axis=0)
                    tid = KT_BOX_W
            if tid < KT_SPHERE_W:
                leaves[row, :12] = w2l_a[i][:3, :].reshape(12)
                leaves[row, 12:20] = params_a[i][:8]
            types_o[row] = tid
            leaves[row, 20] = tid
            leaves[row, 21] = leaf_ids[i]
            leaves[row, 22] = ents_a[i]
        else:
            j = int(item) - n
            types_o[row] = KT_CSG
            leaves[row, 0] = csg_rec[j, 0]
            leaves[row, 1] = csg_rec[j, 1]
            leaves[row, 20] = KT_CSG
            leaves[row, 21] = -1.0
            leaves[row, 22] = csg_rec[j, 2]

    nodes = np.stack(
        [bvh.node_lo[:, 0], bvh.node_lo[:, 1], bvh.node_lo[:, 2],
         bvh.node_hi[:, 0], bvh.node_hi[:, 1], bvh.node_hi[:, 2],
         bvh.node_skip.astype(np.float64), bvh.node_first.astype(np.float64),
         bvh.node_count.astype(np.float64)], axis=1)
    tables = {"nodes": nodes.astype(np.float32),
              "leaves": leaves.astype(np.float32),
              "csg": csg_rows.astype(np.float32)}
    present = tuple(sorted({int(t) for t in types_o}))
    # the differentiable winner recompute dispatches on the ORIGINAL
    # analytic types (children included), not the kernel's record codes
    present_orig = tuple(sorted(
        {int(t) for t in leaf_types}
        | {int(c[1]) for (_e, _p, ch) in csg_items for c in ch}))
    root_lo = tuple(float(x) for x in bvh.node_lo[0])
    root_hi = tuple(float(x) for x in bvh.node_hi[0])
    return tables, (int(bvh.n_nodes), int(max(1, bvh.max_leaf_size)), present,
                    root_lo, root_hi, present_orig, tuple(csg_sigs))


# --- the ray sort -------------------------------------------------------------


def _part1by2(x):
    """Spread 10 bits of x to every third bit (Morton interleave step)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _coherence_order(origin, direction, root_lo, root_hi):
    """Coherence sort key: direction octant (3 high bits) then a 15-bit
    Morton code of the origin inside the root AABB; the permutation that
    sorts it, stably. Neighbouring threads then walk similar node paths."""
    lo = torch.as_tensor(root_lo, dtype=origin.dtype, device=origin.device)
    hi = torch.as_tensor(root_hi, dtype=origin.dtype, device=origin.device)
    span = torch.clamp(hi - lo, min=1e-6)
    i32 = torch.int32
    octant = ((direction[:, 0] > 0).to(i32) * 4
              + (direction[:, 1] > 0).to(i32) * 2
              + (direction[:, 2] > 0).to(i32))
    q = torch.clamp((origin - lo[None]) / span[None], 0.0, 1.0)
    qi = (q * 31.0).to(i32)  # 5 bits per axis
    morton = ((_part1by2(qi[:, 0]) << 2) | (_part1by2(qi[:, 1]) << 1)
              | _part1by2(qi[:, 2]))
    key = (octant << 15) | morton
    return torch.sort(key, stable=True).indices


# --- plain version --------------------------------------------------------------
# The per-type closed forms are the fused tracer's (tracer/fused.py): the
# same arithmetic as the reference's kernel-local ones. The convex ray
# intervals of the CSG children are this module's own.


def _safe_inv(x):
    ok = torch.abs(x) > 1e-12
    return torch.where(ok, 1.0 / torch.where(ok, x, 1.0), _BIG)


def _ival_from_cands(cands):
    """Convex interval as (min, max) over the valid boundary crossings."""
    lo = hi = any_v = None
    for t, v in cands:
        tl = torch.where(v, t, _BIG)
        th = torch.where(v, t, -_BIG)
        lo = tl if lo is None else torch.minimum(lo, tl)
        hi = th if hi is None else torch.maximum(hi, th)
        any_v = v if any_v is None else (any_v | v)
    return lo, hi, any_v


def _ival_sphere(o, d, p):
    r = p[0]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = 2.0 * (o[0] * d[0] + o[1] * d[1] + o[2] * d[2])
    c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - r * r
    return _f._quad(a, b, c)


def _ival_box(o, d, p):
    ix, iy, iz = _f._inv_dir(d[0]), _f._inv_dir(d[1]), _f._inv_dir(d[2])
    t0x = (p[0] - o[0]) * ix
    t1x = (p[3] - o[0]) * ix
    t0y = (p[1] - o[1]) * iy
    t1y = (p[4] - o[1]) * iy
    t0z = (p[2] - o[2]) * iz
    t1z = (p[5] - o[2]) * iz
    lo = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                     torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    hi = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return lo, hi, hi >= lo


def _ival_cylinder(o, d, p):
    r, h = p[0], p[1]
    a = d[0] * d[0] + d[1] * d[1]
    b = 2.0 * (o[0] * d[0] + o[1] * d[1])
    c = o[0] * o[0] + o[1] * o[1] - r * r
    qlo, qhi, qv = _f._quad(a, b, c)
    axial = a <= 1e-20
    in_tube = c <= 0.0
    tube_lo = torch.where(axial, torch.where(in_tube, -_BIG, _BIG),
                          torch.where(qv, qlo, _BIG))
    tube_hi = torch.where(axial, torch.where(in_tube, _BIG, -_BIG),
                          torch.where(qv, qhi, -_BIG))
    flat = torch.abs(d[2]) <= 1e-30
    sdz = torch.where(flat, 1e-30, d[2])
    s0 = (0.0 - o[2]) / sdz
    s1 = (h - o[2]) / sdz
    in_slab = (o[2] >= 0.0) & (o[2] <= h)
    slab_lo = torch.where(flat, torch.where(in_slab, -_BIG, _BIG),
                          torch.minimum(s0, s1))
    slab_hi = torch.where(flat, torch.where(in_slab, _BIG, -_BIG),
                          torch.maximum(s0, s1))
    lo = torch.maximum(tube_lo, slab_lo)
    hi = torch.minimum(tube_hi, slab_hi)
    return lo, hi, hi >= lo


def _ival_cone(o, d, p):
    r, h = p[0], p[1]
    k = r / h
    wo = h - o[2]
    wd = -d[2]
    a = d[0] * d[0] + d[1] * d[1] - k * k * wd * wd
    b = 2.0 * (o[0] * d[0] + o[1] * d[1] - k * k * wo * wd)
    c = o[0] * o[0] + o[1] * o[1] - k * k * wo * wo
    qlo, qhi, qv = _f._quad(a, b, c)
    z0 = o[2] + qlo * d[2]
    z1 = o[2] + qhi * d[2]
    v0 = qv & (z0 >= 0.0) & (z0 <= h)
    v1 = qv & (z1 >= 0.0) & (z1 <= h)
    nz = torch.abs(d[2]) > 1e-30
    tc = -o[2] / torch.where(nz, d[2], 1e-30)
    px = o[0] + tc * d[0]
    py = o[1] + tc * d[1]
    vc = nz & (px * px + py * py <= r * r)
    return _ival_from_cands([(qlo, v0), (qhi, v1), (tc, vc)])


def _ival_parabola(o, d, p):
    r, h = p[0], p[1]
    a4 = r * r / h
    a = d[0] * d[0] + d[1] * d[1]
    b = 2.0 * (o[0] * d[0] + o[1] * d[1]) + a4 * d[2]
    c = o[0] * o[0] + o[1] * o[1] + a4 * (o[2] - h)
    qlo, qhi, qv = _f._quad(a, b, c)
    z0 = o[2] + qlo * d[2]
    z1 = o[2] + qhi * d[2]
    v0 = qv & (z0 >= 0.0) & (z0 <= h)
    v1 = qv & (z1 >= 0.0) & (z1 <= h)
    lin = a <= 1e-20
    b_ok = torch.abs(b) > 1e-30
    tl = -c / torch.where(b_ok, b, 1e-30)
    zl = o[2] + tl * d[2]
    vl = lin & b_ok & (zl >= 0.0) & (zl <= h)
    t0 = torch.where(lin, tl, qlo)
    v0 = (lin & vl) | (~lin & v0)
    v1 = v1 & ~lin
    nz = torch.abs(d[2]) > 1e-30
    tc = -o[2] / torch.where(nz, d[2], 1e-30)
    px = o[0] + tc * d[0]
    py = o[1] + tc * d[1]
    vc = nz & (px * px + py * py <= r * r)
    return _ival_from_cands([(t0, v0), (qhi, v1), (tc, vc)])


_IVAL_FNS = {
    TYPE_SPHERE: _ival_sphere,
    TYPE_BOX: _ival_box,
    TYPE_CYLINDER: _ival_cylinder,
    TYPE_CONE: _ival_cone,
    TYPE_PARABOLA: _ival_parabola,
}


def _n_local(tid, p, pp):
    """Local outward normal (unnormalised) at ``p`` of a leaf of type tid."""
    if tid == TYPE_SPHERE:
        return p
    return _f._NORMAL[tid](p, pp)


def _to_world(m, n):
    return (m[0] * n[0] + m[4] * n[1] + m[8] * n[2],
            m[1] * n[0] + m[5] * n[1] + m[9] * n[2],
            m[2] * n[0] + m[6] * n[1] + m[10] * n[2])


def _csg_item(sig, rows, o, d, t_min):
    """One small-CSG signature on the lanes of ``rows`` (their CSG table
    rows): (t, inside, world normal, global leaf id, crossing index)."""
    program, child_types = sig
    ivals, child = [], []
    for c, tid in enumerate(child_types):
        base = 1 + c * _CSG_CHILD_FIELDS
        m, lo, ld = _f._leaf_local(lambda k: rows[:, k], base + 1, o, d)
        pp = [rows[:, base + 13 + k] for k in range(8)]
        ivals.append(_IVAL_FNS[tid](lo, ld, pp))
        child.append((rows[:, base].to(torch.int32), m, pp))
    t_b = torch.full_like(o[0], _BIG)
    win_c = torch.zeros_like(o[0], dtype=torch.int32)
    ishi_b = torch.zeros_like(win_c)
    inside_b = torch.zeros_like(o[0], dtype=torch.bool)
    inside_fn = _program_to_closure(program)
    for c in range(len(child_types)):
        for kind in (0, 1):
            e = ivals[c][kind]
            pb = inside_fn(torch.stack(
                [(lo < e) & (e <= hi) & v for lo, hi, v in ivals], dim=-1))
            pa = inside_fn(torch.stack(
                [(lo <= e) & (e < hi) & v for lo, hi, v in ivals], dim=-1))
            better = ivals[c][2] & (e > t_min) & (pb != pa) & (e < t_b)
            t_b = torch.where(better, e, t_b)
            win_c = torch.where(better, c, win_c)
            ishi_b = torch.where(better, kind, ishi_b)
            inside_b = torch.where(better, pb, inside_b)
    # the winning child's outward normal at the crossing (world point back
    # into the child frame)
    t_sn = torch.where(t_b < 1e30, t_b, 0.0)
    pw = (o[0] + t_sn * d[0], o[1] + t_sn * d[1], o[2] + t_sn * d[2])
    n = [torch.zeros_like(t_b) for _ in range(3)]
    gid_out = torch.full_like(win_c, -1)
    for c, tid in enumerate(child_types):
        mc = win_c == c
        gid_c, m, pp = child[c]
        ph = (m[0] * pw[0] + m[1] * pw[1] + m[2] * pw[2] + m[3],
              m[4] * pw[0] + m[5] * pw[1] + m[6] * pw[2] + m[7],
              m[8] * pw[0] + m[9] * pw[1] + m[10] * pw[2] + m[11])
        nw = _to_world(m, _n_local(tid, ph, pp))
        n = [torch.where(mc, a, b) for a, b in zip(nw, n)]
        gid_out = torch.where(mc, gid_c, gid_out)
    return t_b, inside_b, n, gid_out, ishi_b


def _test_items(kind, rows, o, d, t_min, inv, csg, csg_sigs):
    """Items of one record kind on their lanes: (t, inside, world normal,
    global leaf id, crossing index)."""
    zero = torch.zeros_like(o[0], dtype=torch.int32)
    if kind == KT_CSG:
        t = torch.full_like(o[0], _BIG)
        ins = torch.zeros_like(o[0], dtype=torch.bool)
        n = [torch.zeros_like(t) for _ in range(3)]
        gid, ishi = zero - 1, zero
        sig_of = rows[:, 1].to(torch.int64)
        crow = csg[rows[:, 0].to(torch.int64)]
        for s, sig in enumerate(csg_sigs):
            m = sig_of == s
            if not bool(m.any()):
                continue
            res = _csg_item(sig, crow[m], [x[m] for x in o], [x[m] for x in d],
                            t_min[m])
            t, ins, gid, ishi = (x.index_put((m,), y) for x, y in
                                 zip((t, ins, gid, ishi),
                                     (res[0], res[1], res[3], res[4])))
            n = [x.index_put((m,), y) for x, y in zip(n, res[2])]
        return t, ins, n, gid, ishi
    gid = rows[:, 21].to(torch.int32)
    if kind == KT_SPHERE_W:
        p = (o[0] - rows[:, 0], o[1] - rows[:, 1], o[2] - rows[:, 2])
        t, ins = _f._hit_sphere(p, d, [rows[:, 3]], t_min)
        n = [p[k] + t * d[k] for k in range(3)]
        return t, ins, n, gid, zero
    if kind == KT_BOX_W:
        b = [rows[:, k] for k in range(6)]
        t0 = [(b[k] - o[k]) * inv[k] for k in range(3)]
        t1 = [(b[3 + k] - o[k]) * inv[k] for k in range(3)]
        lo = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
        hi = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                         torch.maximum(t0[1], t1[1])),
                           torch.maximum(t0[2], t1[2]))
        v = hi >= lo
        t = _f._first_after(t_min, (lo, v), (hi, v))
        ins = ((o[0] >= b[0]) & (o[0] <= b[3]) & (o[1] >= b[1])
               & (o[1] <= b[4]) & (o[2] >= b[2]) & (o[2] <= b[5]))
        n = _f._n_box(tuple(o[k] + t * d[k] for k in range(3)), b)
        return t, ins, list(n), gid, zero
    m, lo, ld = _f._leaf_local(lambda k: rows[:, k], 0, o, d)
    pp = [rows[:, 12 + k] for k in range(8)]
    t, ins = _f._HIT[kind](lo, ld, pp, t_min)
    p = tuple(lo[k] + t * ld[k] for k in range(3))
    return t, ins, list(_to_world(m, _n_local(kind, p, pp))), gid, zero


def analytic_bvh_winner_plain(tables, meta, origin, direction, t_min):
    """Plain PyTorch version of the kernel: the stackless walk vectorised
    over lanes, one node pointer per lane. Returns the raw per-ray records
    (t, leaf, entity, inside, normal, crossing_hi as the kernel writes
    them) plus ``nodes_visited`` and ``items_visited`` per ray, the item
    tests by record kind (``kind_tests``, i64[9]) and the CSG children they
    evaluated (``csg_children``)."""
    nodes, leaves, csg = tables["nodes"], tables["leaves"], tables["csg"]
    n_nodes, max_leaf, present = meta[:3]
    csg_sigs = meta[6] if len(meta) > 6 else ()
    N = origin.shape[0]
    dev = origin.device
    o_all = origin.unbind(1)
    d_all = direction.unbind(1)
    inv_all = [_safe_inv(x) for x in d_all]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    t_best = torch.full((N,), _BIG, dtype=origin.dtype, device=dev)
    leaf = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ent = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ins = torch.zeros(N, dtype=torch.bool, device=dev)
    nrm = torch.zeros((N, 3), dtype=origin.dtype, device=dev)
    ishi = torch.zeros(N, dtype=torch.int32, device=dev)
    nodes_visited = torch.zeros(N, dtype=torch.int32, device=dev)
    items_visited = torch.zeros(N, dtype=torch.int32, device=dev)
    kind_tests = torch.zeros(KT_CSG + 1, dtype=torch.int64, device=dev)
    csg_children = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(node < n_nodes).squeeze(1)
        if act.numel() == 0:
            break
        nodes_visited[act] += 1
        nd = nodes[node[act]]
        o = [x[act] for x in o_all]
        inv = [x[act] for x in inv_all]
        t0 = [(nd[:, k] - o[k]) * inv[k] for k in range(3)]
        t1 = [(nd[:, 3 + k] - o[k]) * inv[k] for k in range(3)]
        tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                            torch.minimum(t0[1], t1[1])),
                              torch.minimum(t0[2], t1[2]))
        tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        lane_hit = (tfar >= torch.clamp(tnear, min=0.0)) & (tnear < t_best[act])
        skip = nd[:, 6].to(torch.int64)
        first = nd[:, 7].to(torch.int64)
        count = nd[:, 8].to(torch.int64)
        for k in range(int(max_leaf)):
            sel = lane_hit & (k < count)
            if not bool(sel.any()):
                continue
            lanes = act[sel]
            items_visited[lanes] += 1
            rows = leaves[first[sel] + k]
            typ = rows[:, 20].to(torch.int64)
            for kind in present:
                m = typ == kind
                if not bool(m.any()):
                    continue
                ln = lanes[m]
                kind_tests[kind] += m.sum()
                if kind == KT_CSG:
                    csg_children += csg[rows[m][:, 0].to(torch.int64), 0].sum(
                        dtype=torch.int64)
                t, i_, n, g, h = _test_items(
                    kind, rows[m], [x[ln] for x in o_all],
                    [x[ln] for x in d_all], t_min[ln],
                    [x[ln] for x in inv_all], csg, csg_sigs)
                better = t < t_best[ln]
                up = ln[better]
                t_best[up] = t[better]
                leaf[up] = g[better]
                ent[up] = rows[m][better, 22].to(torch.int32)
                ins[up] = i_[better]
                nrm[up] = torch.stack(n, dim=1)[better].to(nrm.dtype)
                ishi[up] = h[better]
        node[act] = torch.where(lane_hit & (count == 0), node[act] + 1, skip)
    inv_len = torch.rsqrt((nrm * nrm).sum(1, keepdim=True) + 1e-24)
    return {"t": t_best, "leaf": leaf, "entity": ent,
            "inside": ins.to(torch.int32), "normal": nrm * inv_len,
            "crossing_hi": ishi, "nodes_visited": nodes_visited,
            "items_visited": items_visited, "kind_tests": kind_tests,
            "csg_children": csg_children}


# --- the kernel -------------------------------------------------------------------

_OUT_KEYS = ("t", "leaf", "entity", "inside", "normal", "crossing_hi")
_library = None
_sig_tables = {}  # (csg signatures, device) -> int32 records on the device


def build_library(verbose=False):
    """Compile csrc/analytic_bvh.cu into ``_build/`` (if the sources are newer
    than the library); returns (library path, compiler log)."""
    return _f.nvcc_build("analytic_bvh.cu", ("fused_bounce.cuh",),
                         "libanalytic_bvh.so", (), verbose)


def _lib():
    global _library
    if _library is None:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        # o, d, t_min, N, nodes, n_nodes, leaves, csg, sigs, out t, leaf,
        # entity, inside, normal, crossing_hi, stream
        lib.analytic_bvh_winner.argtypes = [p, p, p, i, p, i, p, p, p] + [p] * 7
        lib.analytic_bvh_winner.restype = i
        _library = lib
    return _library


def _sig_table(csg_sigs, device):
    """The kernel's int32 signature records of ``csg_sigs``."""
    rows = np.zeros((max(1, len(csg_sigs)), _SIG_WORDS), np.int32)
    for s, (program, child_types) in enumerate(csg_sigs):
        if len(child_types) > MAX_CSG_CHILD or len(program) > _MAX_OPS:
            raise ValueError(f"CSG signature {s} exceeds the kernel's limits")
        rows[s, 0] = len(child_types)
        rows[s, 1] = len(program)
        rows[s, 2:2 + len(child_types)] = child_types
        for k, (op, arg) in enumerate(program):
            rows[s, 8 + 2 * k] = op
            rows[s, 9 + 2 * k] = arg
    return torch.as_tensor(rows, device=device)


def _launch(tables, meta, o, d, t_min):
    N = o.shape[0]
    dev = o.device
    nodes, leaves, csg = tables["nodes"], tables["leaves"], tables["csg"]
    for name, t in (("origin", o), ("direction", d), ("t_min", t_min),
                    ("nodes", nodes), ("leaves", leaves), ("csg", csg)):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous float32 tensor on {dev}")
    if (tuple(nodes.shape) != (meta[0], 9) or leaves.shape[1] != 23
            or csg.shape[1] != _CSG_ROW):
        raise ValueError("BVH tables do not match their meta")
    csg_sigs = meta[6] if len(meta) > 6 else ()
    sigs = _sig_tables.get((csg_sigs, dev))
    if sigs is None:
        sigs = _sig_tables[(csg_sigs, dev)] = _sig_table(csg_sigs, dev)
    out = {"t": torch.empty(N, dtype=torch.float32, device=dev),
           "leaf": torch.empty(N, dtype=torch.int32, device=dev),
           "entity": torch.empty(N, dtype=torch.int32, device=dev),
           "inside": torch.empty(N, dtype=torch.int32, device=dev),
           "normal": torch.empty((N, 3), dtype=torch.float32, device=dev),
           "crossing_hi": torch.empty(N, dtype=torch.int32, device=dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().analytic_bvh_winner(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), N,
            nodes.data_ptr(), int(meta[0]), leaves.data_ptr(), csg.data_ptr(),
            sigs.data_ptr(), *[out[k].data_ptr() for k in _OUT_KEYS], stream)
    if err != 0:
        raise RuntimeError(f"analytic_bvh_winner: CUDA launch failed with "
                           f"error {err}")
    analytic_bvh_winner.launches += 1
    return out


def winner_records(tables, meta, origin, direction, t_min, sort_rays=True):
    """The raw per-ray records of the kernel (CUDA tensors) or of its plain
    version (CPU tensors), in the callers' lane order; with ``sort_rays``
    and more than one reference tile of rays, the rays are walked in
    coherence order and scattered back."""
    origin = origin.detach().contiguous()
    direction = direction.detach().contiguous()
    t_min = t_min.detach().contiguous()
    N = origin.shape[0]
    order = None
    if sort_rays and N > _TILE:
        order = _coherence_order(origin, direction, meta[3], meta[4])
        origin, direction, t_min = origin[order], direction[order], t_min[order]
    if origin.is_cuda:
        out = _launch(tables, meta, origin, direction, t_min)
    else:
        out = analytic_bvh_winner_plain(tables, meta, origin, direction, t_min)
        out = {k: out[k] for k in _OUT_KEYS}
    if order is not None:
        out = {k: torch.empty_like(v).index_put_((order,), v)
               for k, v in out.items()}
    return out


def analytic_bvh_winner(tables, meta, origin, direction, t_min,
                        sort_rays=True):
    """Nearest hit over the packed analytic items.

    ``origin``/``direction`` f32[N,3] world space, ``t_min`` f32[N] (the
    minimum advance). Returns a dict of per-ray winner fields, none of which
    carries a gradient:
      t           f32[N]   crossing distance (+inf on a miss)
      leaf        i32[N]   global leaf id (-1 on a miss)
      entity      i32[N]   owning entity (-1 on a miss)
      inside      bool[N]  ray origin inside the solid (reference 'exiting')
      normal      f32[N,3] unit outward world normal at the crossing
      crossing_hi bool[N]  a CSG winner is its child's interval exit
    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version. ``tables`` holds "nodes", "leaves", "csg" on the rays' device.
    """
    with torch.no_grad():
        r = winner_records(tables, meta, origin, direction, t_min, sort_rays)
        hit = r["leaf"] >= 0
        return {
            "t": torch.where(hit, r["t"], float("inf")),
            "leaf": r["leaf"],
            "entity": torch.where(hit, r["entity"], -1),
            "inside": r["inside"] > 0,
            "normal": r["normal"],
            "crossing_hi": r["crossing_hi"] > 0,
        }


analytic_bvh_winner.launches = 0
