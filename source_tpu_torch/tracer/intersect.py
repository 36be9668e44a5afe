"""Batched scene intersection for the wavefront route.

Counterpart of source_tpu/tracer/intersect.py (the reference's World.hit ->
kd-tree -> per-object Primitive.hit chain). For every ray of a batch it finds
the nearest boundary crossing over the scene's entities and returns a
``HitRecord`` SoA. Three branches, as in the reference:

  (a) the analytic-BVH winner (tracer/analytic_bvh.py, the CUDA kernel K6 on
      the card) over the simple leaves and the small CSG entities: consumed
      whole on the forward path when the BVH covers every leaf, else
      recomputed from the winner's leaf row as differentiable tensor ops
      (for a kernel-resolved CSG winner, by its crossing index);
  (b) the leaves the BVH leaves over (children of CSG entities it cannot
      resolve), streamed beside it;
  (c) without BVH tables, the streaming route: every leaf's candidates by
      type, per-entity minima for simple entities, and the CSG
      crossing-parity resolve (csg.pyx:132-241 as bounded all-hits: sort the
      children's crossings and take the first at which the program's
      inside-state flips).

Mesh entities follow: each mesh is intersected in its local frame by
``meshtrace.mesh_intersect`` (the CUDA kernel ``mesh_bvh_winner`` on the
card), the local direction deliberately not renormalised so t stays in world
units, and merges into the running nearest hit with a strict ``t < t_best``.
A mesh winner's normal is the barycentric blend of its vertex normals
(smoothing) or its face normal; it is exiting where it hit a back face.

Float32 epsilon strategy: scale-relative offsets ``eps * max(1, |t|, |p|)``
where the reference uses 1e-9 absolute offsets in f64 (sphere.pyx:42).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..compiler.scene import CompiledScene, _program_to_closure
from ..core.math import batch as vmath
from ..primitive import analytic as _a
from .analytic_bvh import analytic_bvh_winner
from .meshtrace import mesh_intersect

__all__ = ["HitRecord", "intersect_scene", "leaf_candidates", "leaf_contains",
           "entity_contains", "mesh_contains", "T_EPS"]

_INF = float("inf")
T_EPS = 1e-4  # minimum ray-parameter advance (relative-scaled below)

# benign parameter block for masked-out lanes of the per-type dispatch: the
# unit box [0,1]^3 doubles as unit radius/height for the quadric types
_SAFE_PARAMS = np.asarray([1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 1.0, 1.0], np.float32)


@dataclasses.dataclass
class HitRecord:
    """Per-ray intersection result (reference Intersection,
    core/intersection.pyx:35, flattened to SoA)."""

    hit: Any  # bool[N]
    t: Any  # f32[N]
    entity: Any  # i32[N] (-1 on miss)
    leaf: Any  # i32[N]
    point: Any  # f32[N,3] world hit point
    normal: Any  # f32[N,3] oriented away from the solid's side of the ray
    exiting: Any  # bool[N] ray was inside the solid (reference 'exiting')
    inside_point: Any  # f32[N,3] epsilon-displaced relaunch point inside
    outside_point: Any  # f32[N,3] epsilon-displaced relaunch point outside
    tri: Any = None  # i32[N] winning triangle of a mesh entity (-1 otherwise)
    bary_u: Any = None  # f32[N] barycentric u of the mesh hit
    bary_v: Any = None  # f32[N] barycentric v of the mesh hit


def _safe(params, m):
    safe = torch.as_tensor(_SAFE_PARAMS[: params.shape[-1]],
                           device=params.device)
    return torch.where(m[:, None], params, safe)


def _rays_to_local(w2l, origin, direction):
    """Rays into every leaf frame of a slice: (o_loc, d_loc) [N, l, 3]."""
    return (vmath.transform_point(w2l[None], origin[:, None, :]),
            vmath.transform_vector(w2l[None], direction[:, None, :]))


def leaf_candidates(scene: CompiledScene, origin, direction):
    """All boundary crossings per (ray, leaf): t[N, L, K] sorted, +inf pad."""
    parts = []
    for type_id, start, stop in scene.type_slices:
        o_loc, d_loc = _rays_to_local(scene.leaf_w2l[start:stop], origin,
                                      direction)
        parts.append(_a.CANDIDATE_FNS[type_id](
            o_loc, d_loc, scene.leaf_params[start:stop][None]))
    return torch.cat(parts, dim=1)


def leaf_contains(scene: CompiledScene, point):
    """Point-in-leaf tests: bool[..., L] for points [..., 3]."""
    parts = []
    for type_id, start, stop in scene.type_slices:
        p_loc = vmath.transform_point(scene.leaf_w2l[start:stop],
                                      point[..., None, :])
        parts.append(_a.CONTAINS_FNS[type_id](
            p_loc, scene.leaf_params[start:stop]))
    return torch.cat(parts, dim=-1)


def mesh_contains(mesh, point):
    """Point-in-mesh for a closed mesh: a +z probe ray from each point
    [N,3]; inside iff the nearest face it meets is a back face
    (mesh.pyx:805-831). An open mesh contains nothing."""
    if not mesh.closed:
        return torch.zeros(point.shape[:-1], dtype=torch.bool,
                           device=point.device)
    o_loc = vmath.transform_point(mesh.w2l[None], point)
    up = torch.zeros_like(point)
    up[:, 2] = 1.0
    d_loc = vmath.transform_vector(mesh.w2l[None], up)
    res = mesh_intersect(mesh, o_loc, d_loc, torch.zeros_like(point[:, 0]))
    return (res["tri"] >= 0) & ~res["front"]


def entity_contains(scene: CompiledScene, point):
    """Point-in-entity tests: bool[..., E] (reference World.contains,
    core/scenegraph/world.pyx:149)."""
    out = torch.zeros(point.shape[:-1] + (scene.n_entities,), dtype=torch.bool,
                      device=point.device)
    if scene.n_leaves:
        lc = leaf_contains(scene, point)
        for e, leaf_idx in enumerate(scene.simple_leaf_of_entity):
            if leaf_idx >= 0:
                out[..., e] = lc[..., leaf_idx]
        for e, leaf_ids, program in scene.csg_entities:
            out[..., e] = _program_to_closure(program)(lc[..., list(leaf_ids)])
    for e, slot in scene.mesh_entities:
        out[..., e] = mesh_contains(scene.meshes[slot], point.reshape(-1, 3)
                                    ).reshape(point.shape[:-1])
    return out


def _leaf_type_of(scene: CompiledScene, leaf_idx):
    """Per-ray analytic type of a (gathered) leaf index."""
    leaf_type = torch.zeros_like(leaf_idx)
    for type_id, start, stop in scene.type_slices:
        leaf_type = torch.where((leaf_idx >= start) & (leaf_idx < stop),
                                type_id, leaf_type)
    return leaf_type


def _leaf_rows(scene: CompiledScene, leaf_idx):
    """Per-ray (w2l[N,4,4], params[N,PB], entity[N]) of a gathered leaf,
    differentiable in the tables."""
    return (vmath.select_rows(scene.leaf_w2l, leaf_idx),
            vmath.select_rows(scene.leaf_params, leaf_idx),
            vmath.select_rows(scene.leaf_entity, leaf_idx))


def _single_leaf_candidates(scene: CompiledScene, leaf_idx, origin, direction,
                            types=None, rows=None):
    """All crossings of ONE (gathered) leaf per ray: t[N, K], differentiable.
    Recomputing the BVH winner's crossing this way gives the cotangents of
    differentiating the whole traversal: only the winner contributes."""
    w2l, params = (_leaf_rows(scene, leaf_idx) if rows is None else rows)[:2]
    o_loc = vmath.transform_point(w2l, origin)
    d_loc = vmath.transform_vector(w2l, direction)
    lt = _leaf_type_of(scene, leaf_idx)
    cand = torch.full(origin.shape[:-1] + (_a.MAX_HITS,), _INF,
                      dtype=origin.dtype, device=origin.device)
    present = {t for t, _, _ in scene.type_slices}
    if types is not None:
        present &= set(types)
    for tid, fn in _a.CANDIDATE_FNS.items():
        if tid not in present:
            continue
        m = lt == tid
        cand = torch.where(m[:, None], fn(o_loc, d_loc, _safe(params, m)), cand)
    return cand


def _leaf_contains_single(scene: CompiledScene, leaf_idx, point, rows=None):
    """Point-in-leaf for ONE (gathered) leaf per ray: bool[N]."""
    w2l, params = (_leaf_rows(scene, leaf_idx) if rows is None else rows)[:2]
    p_loc = vmath.transform_point(w2l, point)
    lt = _leaf_type_of(scene, leaf_idx)
    out = torch.zeros(point.shape[:-1], dtype=torch.bool, device=point.device)
    present = {t for t, _, _ in scene.type_slices}
    for tid, fn in _a.CONTAINS_FNS.items():
        if tid not in present:
            continue
        m = lt == tid
        out = torch.where(m, fn(p_loc, _safe(params, m)), out)
    return out


def _leaf_normal(scene: CompiledScene, leaf_idx, p_local, params=None):
    """Local outward normal of the (gathered) winning leaf at p_local [N,3],
    every present type computed and selected (masked lanes get benign
    params, so no NaN leaks through a backward pass)."""
    if params is None:
        params = vmath.select_rows(scene.leaf_params, leaf_idx)
    leaf_type = _leaf_type_of(scene, leaf_idx)
    n = torch.zeros_like(p_local)
    present = {t for t, _, _ in scene.type_slices}
    for type_id, fn in _a.NORMAL_FNS.items():
        if type_id not in present:
            continue
        m = leaf_type == type_id
        n = torch.where(m[:, None], fn(p_local, _safe(params, m)), n)
    return n


def _first_min_onehot(t):
    """One-hot of the first minimum along the last axis, and the minimum."""
    bt = torch.amin(t, dim=-1)
    is_min = t <= bt[..., None]
    return is_min & (torch.cumsum(is_min.to(torch.int32), dim=-1) == 1), bt


def intersect_scene(scene: CompiledScene, origin, direction, t_min_scale=None,
                    need_grad=True, leaf_bvh=True):
    """Nearest-hit query for a ray batch: ``origin``/``direction`` f32[N,3]
    world space (direction unit length). Returns a HitRecord.

    ``need_grad=False`` (forward-only tracing) lets a scene whose BVH covers
    every leaf consume the BVH winner's whole record (t, entity, normal,
    exiting) without the differentiable recompute. ``leaf_bvh=False`` takes
    the streaming route even where the scene has BVH tables (the reference's
    SOURCE_TPU_LEAF_BVH=0)."""
    N = origin.shape[0]
    dev = origin.device
    eps = T_EPS * torch.clamp(torch.amax(torch.abs(origin), dim=-1), min=1.0)
    if t_min_scale is not None:
        eps = eps * t_min_scale

    E = scene.n_entities
    use_bvh = scene.leaf_bvh is not None and leaf_bvh
    t_best = torch.full((N,), _INF, dtype=origin.dtype, device=dev)
    ent_best = torch.full((N,), -1, dtype=torch.int32, device=dev)
    leaf_best = torch.zeros((N,), dtype=torch.int32, device=dev)

    csg_leaf_ids = set()
    for _, leaf_ids, _ in scene.csg_entities:
        csg_leaf_ids.update(leaf_ids)

    csg_cand = {}  # global leaf id -> [N, K] candidates
    fast_path = False
    win = None
    rows_w = None
    full_cover = len(scene.bvh_leaf_ids) == scene.n_leaves
    if scene.n_leaves and use_bvh:
        # (a) the BVH winner, then (unless forward-only on a fully covered
        # scene) a differentiable recompute of the winner's crossing
        win = analytic_bvh_winner(
            scene.leaf_bvh, scene.leaf_bvh_meta, origin, direction, eps,
            # the sort pays only when the tree is deep enough for
            # neighbouring rays to walk very different node sets
            sort_rays=len(scene.bvh_leaf_ids) >= 64)
        win_leaf = win["leaf"]
        fast_path = (not need_grad) and full_cover
        if fast_path:
            valid = win_leaf >= 0
            t_best = torch.where(valid, win["t"], t_best)
            ent_best = torch.where(valid, win["entity"], ent_best)
            leaf_best = torch.where(valid, win_leaf, leaf_best)
        else:
            leaf_c = torch.clamp(win_leaf, min=0)
            rows_w = _leaf_rows(scene, leaf_c)
            cand_w = _single_leaf_candidates(
                scene, leaf_c, origin, direction,
                types=scene.leaf_bvh_meta[5], rows=rows_w)
            pos_w = torch.where(cand_w > eps[:, None], cand_w, _INF)
            t_w = torch.amin(pos_w, dim=-1)
            if scene.kernel_csg_entities:
                # a kernel-resolved CSG boundary may be its winning child's
                # EXIT crossing: recompute by the kernel's crossing index
                # (convex children: candidates are [entry, exit, inf, inf])
                is_csg = torch.zeros_like(win_leaf, dtype=torch.bool)
                for e in scene.kernel_csg_entities:
                    is_csg = is_csg | (win["entity"] == e)
                t_idx = torch.where(win["crossing_hi"], cand_w[:, 1],
                                    cand_w[:, 0])
                t_w = torch.where(is_csg, t_idx, t_w)
            valid = (win_leaf >= 0) & torch.isfinite(t_w)
            t_best = torch.where(valid, t_w, t_best)
            ent_best = torch.where(valid, rows_w[2], ent_best)
            leaf_best = torch.where(valid, win_leaf, leaf_best)

        # (b) the leaves left over stream beside the BVH: children of CSG
        # entities the kernel does not resolve
        bvh_set = set(scene.bvh_leaf_ids)
        for type_id, start, stop in scene.type_slices:
            left = [i for i in range(start, stop) if i not in bvh_set]
            if not left:
                continue
            ids = torch.as_tensor(left, device=dev)
            o_loc, d_loc = _rays_to_local(scene.leaf_w2l[ids], origin,
                                          direction)
            cand_slice = _a.CANDIDATE_FNS[type_id](
                o_loc, d_loc, scene.leaf_params[ids][None])
            simple_local = [j for j, g in enumerate(left)
                            if g not in csg_leaf_ids]
            if simple_local:
                cand_pos = torch.where(cand_slice > eps[:, None, None],
                                       cand_slice, _INF)
                t_sub = torch.amin(cand_pos, dim=-1)[:, simple_local]
                onehot, tmin_row = _first_min_onehot(t_sub)
                g_ids = torch.as_tensor([left[j] for j in simple_local],
                                        device=dev)
                win_g = torch.sum(torch.where(onehot, g_ids[None], 0), dim=1)
                ent_g = torch.sum(torch.where(
                    onehot, scene.leaf_entity[g_ids][None], 0), dim=1)
                better = tmin_row < t_best
                t_best = torch.where(better, tmin_row, t_best)
                ent_best = torch.where(better, ent_g.to(torch.int32), ent_best)
                leaf_best = torch.where(better, win_g.to(torch.int32),
                                        leaf_best)
            for j, g in enumerate(left):
                if g in csg_leaf_ids:
                    csg_cand[g] = cand_slice[:, j, :]
    elif scene.n_leaves:
        # (c) streaming by type: each slice folds into per-entity minima at
        # once; only CSG children keep all their candidates
        t_entity = torch.full((N, E), _INF, dtype=origin.dtype, device=dev)
        entity_of_leaf = {g: e for e, g in
                          enumerate(scene.simple_leaf_of_entity) if g >= 0}
        for type_id, start, stop in scene.type_slices:
            o_loc, d_loc = _rays_to_local(scene.leaf_w2l[start:stop], origin,
                                          direction)
            cand_slice = _a.CANDIDATE_FNS[type_id](
                o_loc, d_loc, scene.leaf_params[start:stop][None])
            cand_pos = torch.where(cand_slice > eps[:, None, None],
                                   cand_slice, _INF)
            t_leaf_slice = torch.amin(cand_pos, dim=-1)
            simple_sel = [i for i in range(start, stop)
                          if i not in csg_leaf_ids]
            if simple_sel:
                ent_ids = [entity_of_leaf[i] for i in simple_sel]
                t_simple = t_leaf_slice[:, [i - start for i in simple_sel]]
                # one leaf per simple entity: the scatter-min is a minimum
                # over distinct columns
                t_entity[:, ent_ids] = torch.minimum(t_entity[:, ent_ids],
                                                     t_simple)
            for g in range(start, stop):
                if g in csg_leaf_ids:
                    csg_cand[g] = cand_slice[:, g - start, :]
        ent0 = torch.argmin(t_entity, dim=-1).to(torch.int32)
        t0 = torch.amin(t_entity, dim=-1)
        simple_leaf = torch.as_tensor(
            [max(i, 0) for i in scene.simple_leaf_of_entity],
            dtype=torch.int32, device=dev)
        leaf0 = vmath.select_rows(simple_leaf, ent0)
        fin0 = torch.isfinite(t0)
        t_best = torch.where(fin0, t0, t_best)
        ent_best = torch.where(fin0, ent0, ent_best)
        leaf_best = torch.where(fin0, leaf0, leaf_best)

    # CSG winners the kernel did not resolve: crossing-parity resolve
    csg_t = []
    for e, leaf_ids, program in scene.csg_entities:
        if use_bvh and e in scene.kernel_csg_entities:
            continue
        inside_fn = _program_to_closure(program)
        ids = torch.as_tensor(leaf_ids, device=dev)
        l = len(leaf_ids)
        K = _a.MAX_HITS
        t_flat = torch.stack([csg_cand[g] for g in leaf_ids], dim=1).reshape(
            N, l * K)
        local_leaf = torch.arange(l, device=dev).repeat_interleave(K)
        src_leaf = ids.repeat_interleave(K)
        t_sorted, perm = torch.sort(t_flat, dim=-1, stable=True)
        leaf_sorted = src_leaf[perm]
        local_sorted = local_leaf[perm]
        finite = torch.isfinite(t_sorted) & (t_sorted > eps[:, None])
        # each valid crossing of a leaf toggles that leaf's containment:
        # state before crossing j = state at the origin XOR parity of the
        # leaf's valid crossings before j
        onehot = ((local_sorted[..., None] == torch.arange(l, device=dev))
                  & finite[..., None]).to(torch.int32)
        cum_incl = torch.cumsum(onehot, dim=1)
        cum_excl = cum_incl - onehot
        o_parts = torch.zeros((N, l), dtype=torch.bool, device=dev)
        for type_id, start, stop in scene.type_slices:
            sel = [i for i, g in enumerate(leaf_ids) if start <= g < stop]
            if not sel:
                continue
            g_ids = torch.as_tensor([leaf_ids[i] for i in sel], device=dev)
            p_loc = vmath.transform_point(scene.leaf_w2l[g_ids][None],
                                          origin[:, None, :])
            o_parts[:, sel] = _a.CONTAINS_FNS[type_id](
                p_loc, scene.leaf_params[g_ids][None])
        leaf_before = o_parts[:, None, :] ^ (cum_excl % 2 == 1)
        leaf_after = o_parts[:, None, :] ^ (cum_incl % 2 == 1)
        inside_b = inside_fn(leaf_before)
        inside_a = inside_fn(leaf_after)
        boundary = finite & (inside_b != inside_a)
        t_valid = torch.where(boundary, t_sorted, _INF)
        onehot1, bt = _first_min_onehot(t_valid)
        bleaf = torch.sum(torch.where(onehot1, leaf_sorted, 0), dim=-1)
        binside = torch.any(onehot1 & inside_b, dim=-1)
        better = bt < t_best
        t_best = torch.where(better, bt, t_best)
        ent_best = torch.where(better, e, ent_best)
        leaf_best = torch.where(better, bleaf.to(torch.int32), leaf_best)
        csg_t.append((e, binside))

    # meshes, each in its local frame (direction NOT renormalised: t stays
    # in world units), merged with the strict t < t_best
    mesh_win = []
    for e, slot in scene.mesh_entities:
        mesh = scene.meshes[slot]
        res = mesh_intersect(mesh, vmath.transform_point(mesh.w2l[None], origin),
                             vmath.transform_vector(mesh.w2l[None], direction),
                             eps)
        t_m = torch.where(res["tri"] >= 0, res["t"], _INF)
        better = t_m < t_best
        t_best = torch.where(better, t_m, t_best)
        ent_best = torch.where(better, e, ent_best)
        mesh_win.append((e, mesh, res))

    entity = ent_best
    t = t_best
    hit = torch.isfinite(t) & (entity >= 0)
    t_safe = torch.where(hit, t, 0.0)
    point = origin + t_safe[:, None] * direction
    delta = torch.clamp(T_EPS * torch.abs(t_safe), min=T_EPS)

    if scene.n_leaves and fast_path:
        # the kernel's winner normal and origin-containment flag
        leaf = leaf_best
        n_world = win["normal"]
        inside_before = win["inside"]
    elif scene.n_leaves:
        leaf = leaf_best
        # a BVH covering every leaf makes the BVH winner every lane's winner,
        # so its gathered rows serve again
        rows = rows_w if (use_bvh and rows_w is not None and full_cover) \
            else _leaf_rows(scene, leaf)
        w2l, leaf_params = rows[:2]
        p_local = vmath.transform_point(w2l, point)
        n_local = _leaf_normal(scene, leaf, p_local, params=leaf_params)
        n_world = vmath.normalise(vmath.transform_normal(w2l, n_local))
        # the winning leaf's containment just before the crossing
        p_before = origin + (t_safe - delta)[:, None] * direction
        inside_before = _leaf_contains_single(scene, leaf, p_before, rows=rows)
    else:
        leaf = torch.zeros((N,), dtype=torch.int32, device=dev)
        n_world = torch.zeros_like(point)
        inside_before = torch.zeros((N,), dtype=torch.bool, device=dev)
    for e, binside in csg_t:
        inside_before = torch.where(entity == e, binside, inside_before)
    if use_bvh and win is not None:
        # kernel-resolved CSG lanes: 'exiting' is the ENTITY's inside state
        # from the kernel's boolean resolve, not the winning child's own
        for e in scene.kernel_csg_entities:
            inside_before = torch.where(entity == e, win["inside"],
                                        inside_before)

    # mesh winners: smoothed (or face) normal; exiting from the face's
    # orientation (mesh.pyx:718-804)
    win_tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
    win_u = torch.zeros((N,), dtype=origin.dtype, device=dev)
    win_v = torch.zeros((N,), dtype=origin.dtype, device=dev)
    for e, mesh, res in mesh_win:
        m = (entity == e) & hit
        tri_idx = torch.clamp(res["tri"], min=0).long()
        if mesh.smoothing:
            tri = mesh.triangles.long()[tri_idx]
            vn = mesh.vertex_normals
            w0 = (1.0 - res["u"] - res["v"])[:, None]
            n_loc = (w0 * vn[tri[:, 0]] + res["u"][:, None] * vn[tri[:, 1]]
                     + res["v"][:, None] * vn[tri[:, 2]])
        else:
            n_loc = mesh.face_normals[tri_idx]
        n_w = vmath.normalise(vmath.transform_normal(mesh.w2l[None], n_loc))
        n_world = torch.where(m[:, None], n_w, n_world)
        inside_before = torch.where(m, ~res["front"], inside_before)
        win_tri = torch.where(m, res["tri"], win_tri)
        win_u = torch.where(m, res["u"], win_u)
        win_v = torch.where(m, res["v"], win_v)

    # orient the normal away from the solid: along the ray when exiting,
    # against it when entering
    d_dot_n = vmath.dot(direction, n_world)
    flip = torch.where(inside_before, d_dot_n < 0.0, d_dot_n > 0.0)
    n_world = torch.where(flip[:, None], -n_world, n_world)

    # epsilon-displaced relaunch points (intersection.pyx:45-50)
    off = (T_EPS * torch.clamp(torch.amax(torch.abs(point), dim=-1),
                               min=1.0))[:, None]
    return HitRecord(
        hit=hit,
        t=t,
        entity=torch.where(hit, entity, -1),
        leaf=leaf,
        point=point,
        normal=n_world,
        exiting=inside_before,
        inside_point=point - n_world * off,
        outside_point=point + n_world * off,
        tri=win_tri,
        bary_u=win_u,
        bary_v=win_v,
    )
