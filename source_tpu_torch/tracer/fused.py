"""Fused bounce tracer for analytic scenes: spec, table, plain version, kernels.

For scenes that qualify (all-analytic simple entities, built-in material
set, Beer/homogeneous volumes) a whole path-tracing bounce — Russian
roulette, intersection of every leaf, winner select, volumes, material
dispatch, state update — is ONE function per ray. Reference analogue: the
whole recursive ``Ray.trace`` loop (raysect/optical/ray.pyx:338-455 +
material dispatch).

Three layers, one function:

  * ``bounce_core(spec, tget, state, u, bits)`` is the bounce as plain
    PyTorch ops on flat per-ray tensors. With ``bits=None`` it makes the
    discrete decisions (winner leaf, dielectric transmit, MIS light pick,
    ...) inline and returns them packed in an i32 bitfield per ray; given
    ``bits`` it replays them. It is the plain version the CPU tests run and
    the hand-written kernels are held against.
  * ``fused_bounce_fwd`` launches the CUDA kernel ``fused_bounce_fwd``
    (csrc/fused_kernels.cu): one bounce for every ray, one thread per ray.
  * ``fused_span_fwd`` launches ``fused_span_fwd``: ``n_steps`` bounces in
    one kernel with the ray state in registers; only the uniforms are read
    and the choice bitfields written per bounce.

Both wrappers take the plain version for CPU tensors and launch the kernel
— or raise — for CUDA tensors; each counts its launches.
``fused_forward_span`` drives a span of bounces for ``wavefront.trace_rays``.

The kernels are data-driven: one compiled library per bin count serves every
scene, steered by an int32 descriptor of the spec (``spec_descriptor``) and
the flat f32 table (``pack_tabvec``), both copied to shared memory per block.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..optical.material.base import (
    MAT_ABSORBER,
    MAT_CHECKERBOARD,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_EMITTER,
    MAT_EMITTER_ANISO,
    MAT_LAMBERT,
    MAT_LIGHT,
    MAT_NULL,
    MAT_PERFECT_REFLECT,
    MAT_ROUGH_CONDUCTOR,
    VOL_BEER,
    VOL_HOMOGENEOUS,
)
from ..primitive.analytic import (
    TYPE_BOX,
    TYPE_CONE,
    TYPE_CYLINDER,
    TYPE_PARABOLA,
    TYPE_SPHERE,
    TYPE_TORUS,
)

__all__ = ["FusedSpec", "fused_spec", "pack_tabvec", "spec_descriptor",
           "bounce_core", "fused_bounce_fwd", "fused_span_fwd",
           "fused_forward_span", "build_library"]

_BIG = 3e38
_PI = 3.14159265358979323846
_T_EPS = 1e-4  # relative minimum advance of a continued ray

# material types the fused dispatch implements
_SUPPORTED_MATS = frozenset({
    MAT_ABSORBER, MAT_LAMBERT, MAT_EMITTER, MAT_NULL, MAT_CONDUCTOR,
    MAT_ROUGH_CONDUCTOR, MAT_DIELECTRIC, MAT_EMITTER_ANISO,
    MAT_CHECKERBOARD, MAT_LIGHT, MAT_PERFECT_REFLECT,
})
_SUPPORTED_TYPES = frozenset({
    TYPE_SPHERE, TYPE_BOX, TYPE_CYLINDER, TYPE_CONE, TYPE_PARABOLA,
    TYPE_TORUS,
})
MAX_FUSED_LEAVES = 48
MAX_FUSED_IMP = 31
N_UNIFORMS = 10  # uniform draws one bounce consumes per ray

# choice bitfield layout (i32 per ray per bounce); csrc/fused_bounce.cuh
# repeats it
B_ALIVE = 0        # post-roulette pre-hit alive (segments accounting)
B_HIT = 1
B_TRANSMIT = 2     # dielectric path roulette chose transmission
B_TIR = 3
B_PICKLIGHT = 4    # one-sample MIS chose the light direction
B_CONT = 5         # material continues the path
B_CNTD = 6         # bounce counts toward depth (null surfaces exempt)
B_ALIVENEXT = 7
B_EXIT = 8         # ray origin inside the winning solid ('exiting')
B_PARITY = 14      # checkerboard cell parity (cap hits sit exactly on a
                   # cell boundary, so a replay must take the saved pick,
                   # not recompute it from floats)
LIGHT_SHIFT = 9    # 5 bits: important-sphere index
WIN_SHIFT = 16     # 9 bits: winning leaf index


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static kernel spec derived from a CompiledScene + RayConfig."""

    # (type_id, entity, mat_id, fast_kind) per leaf; fast_kind: 0 general
    # local-frame, 1 world sphere (pure translation), 2 world AABB
    # (axis-permutation box) — fast records skip the 12-scalar transform
    leaves: Tuple[Tuple[int, int, int, int], ...]
    mat_types: Tuple[int, ...]                # mat id -> MAT_* code
    volumes: Tuple[Tuple[int, int, int, int], ...]  # (entity, mat, kind, leaf)
    check_entities: Tuple[int, ...]  # entities needing their own w2l rows
    n_imp: int
    has_importance: bool
    bins: int
    # RayConfig statics
    max_depth: int
    extinction_prob: float
    extinction_min_depth: int
    importance_sampling: bool
    important_path_weight: float
    max_distance: float


def fused_spec(scene, cfg):
    """FusedSpec for an eligible (scene, cfg), else None.

    Eligible: every entity is a simple analytic leaf of a supported type,
    every material is in the built-in closed set (no user BSDFs, mixes or
    Roughen), volumes are Beer-Lambert / homogeneous only, and counts fit
    the bitfield.
    """
    if (scene.mesh_entities or scene.csg_entities or scene.custom_materials
            or scene.mix_remaps or scene.has_roughen):
        return None
    if scene.n_leaves == 0 or scene.n_leaves > MAX_FUSED_LEAVES:
        return None
    if not scene.entity_material_static:
        return None
    for t, _, _ in scene.type_slices:
        if t not in _SUPPORTED_TYPES:
            return None
    for mt in scene.mat_types:
        if mt not in _SUPPORTED_MATS:
            return None
    for e, leaf in enumerate(scene.simple_leaf_of_entity):
        if leaf < 0:
            return None  # non-simple entity
    vols = []
    for (e, mat_idx, kind, _obj, leaf_idx, _slot, _iv) in scene.volume_entities:
        if kind not in (VOL_BEER, VOL_HOMOGENEOUS) or leaf_idx < 0:
            return None
        vols.append((e, mat_idx, kind, leaf_idx))
    I = int(scene.imp_cdf.shape[0])
    if I > MAX_FUSED_IMP:
        return None

    # leaf type from static type slices; entity/material from static maps
    leaf_type = {}
    for t, start, stop in scene.type_slices:
        for g in range(start, stop):
            leaf_type[g] = t
    leaf_entity = {}
    for e, leaf in enumerate(scene.simple_leaf_of_entity):
        leaf_entity[leaf] = e
    if len(leaf_entity) != scene.n_leaves:
        return None
    fast = scene.leaf_fast_static or (0,) * scene.n_leaves
    leaves = []
    for g in range(scene.n_leaves):
        e = leaf_entity[g]
        leaves.append((leaf_type[g], e, scene.entity_material_static[e],
                       fast[g]))
    check_entities = tuple(sorted({
        e for (_, e, m, _k) in leaves
        if scene.mat_types[m] == MAT_CHECKERBOARD
    }))
    return FusedSpec(
        leaves=tuple(leaves),
        mat_types=tuple(scene.mat_types),
        volumes=tuple(vols),
        check_entities=check_entities,
        n_imp=I,
        has_importance=bool(scene.has_importance),
        bins=int(scene.n_bins),
        max_depth=int(cfg.max_depth),
        extinction_prob=float(cfg.extinction_prob),
        extinction_min_depth=int(cfg.extinction_min_depth),
        importance_sampling=bool(cfg.importance_sampling),
        important_path_weight=float(cfg.important_path_weight),
        max_distance=float(cfg.max_distance),
    )


# --- table vector layout ----------------------------------------------------
# Per leaf g:    20 scalars  [w2l rows 0..11 | params 0..7]
# Per material:  10+2B       [params 0..7 | n_int | n_ext | spec0[B] | spec1[B]]
# Per imp i:     6           [cx cy cz r w cdf]
# Per check ent: 12          [entity w2l rows]


def _off_leaf(spec, g):
    return g * 20


def _mat_base(spec):
    return 20 * len(spec.leaves)


def _off_mat(spec, m):
    return _mat_base(spec) + m * (10 + 2 * spec.bins)


def _imp_base(spec):
    return _mat_base(spec) + len(spec.mat_types) * (10 + 2 * spec.bins)


def _off_imp(spec, i):
    return _imp_base(spec) + 6 * i


def _check_base(spec):
    return _imp_base(spec) + 6 * spec.n_imp


def _off_check(spec, e):
    return _check_base(spec) + 12 * spec.check_entities.index(e)


def tab_size(spec):
    return _check_base(spec) + 12 * len(spec.check_entities)


def pack_tabvec(scene, spec):
    """Flat f32[T] view of the scene tables the bounce reads, on the
    scene's device.

    Fast-record leaves bake WORLD-space fields (sphere centre+radius, box
    AABB) computed from inv(w2l). The table is a few hundred floats, so it
    is assembled on the host in f32 (the 8-corner product as explicit
    mul-add, never a reduced-precision matrix product) and copied over."""
    L = len(spec.leaves)
    w2l = scene.leaf_w2l.detach().to("cpu", torch.float32)
    params = scene.leaf_params.detach().to("cpu", torch.float32)
    leaf_rows = torch.cat([w2l[:L, :3, :].reshape(L, 12), params[:L]], dim=1)
    if any(k for (_t, _e, _m, k) in spec.leaves):
        rows = []
        for g, (_tid, _e, _m, kind) in enumerate(spec.leaves):
            if kind == 0:
                rows.append(leaf_rows[g])
                continue
            p = params[g]
            if kind == 1:  # world sphere (pure translation: c = -w2l[:,3])
                c = -w2l[g, :3, 3]
                row = torch.cat([c, p[0][None], torch.zeros(16)])
            else:  # world AABB from the 8 transformed corners
                l2w = torch.linalg.inv(w2l[g])
                corners = torch.stack([
                    torch.stack([p[3 * x], p[1 + 3 * y], p[2 + 3 * z]])
                    for x in (0, 1) for y in (0, 1) for z in (0, 1)
                ])
                wc = torch.stack([
                    corners[:, 0] * l2w[c, 0] + corners[:, 1] * l2w[c, 1]
                    + corners[:, 2] * l2w[c, 2] + l2w[c, 3]
                    for c in range(3)], dim=1)
                row = torch.cat([wc.min(dim=0).values, wc.max(dim=0).values,
                                 torch.zeros(14)])
            rows.append(row)
        leaf_rows = torch.stack(rows)
    parts = [leaf_rows.reshape(-1)]

    def host(x):
        return x.detach().to("cpu", torch.float32)

    mat_spectra = host(scene.mat_spectra)
    parts.append(torch.cat(
        [host(scene.mat_params)[:, :8], host(scene.mat_scalars)[:, :2],
         mat_spectra[:, 0, :], mat_spectra[:, 1, :]], dim=1).reshape(-1))
    parts.append(torch.cat(
        [host(scene.imp_centre), host(scene.imp_radius)[:, None],
         host(scene.imp_weight)[:, None], host(scene.imp_cdf)[:, None]],
        dim=1).reshape(-1))
    entity_w2l = host(scene.entity_w2l)
    for e in spec.check_entities:
        parts.append(entity_w2l[e, :3, :].reshape(12))
    return torch.cat(parts).to(scene.leaf_w2l.device)


def _maximum(a, b):
    """Elementwise maximum where either side may be a Python scalar; a NaN
    propagates, as in the reference (``fmaxf`` would drop it)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    return torch.clamp(b, min=a)


def _minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    return torch.clamp(b, max=a)


# --- guarded component math ---------------------------------------------------


def _ssqrt(x):
    ok = x > 0.0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _sdiv(a, b, eps=1e-30):
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _spow(base, e):
    ok = base > 0.0
    return torch.where(ok, torch.where(ok, base, 1.0) ** e, 0.0)


def _norm3(x, y, z):
    n2 = x * x + y * y + z * z
    ok = n2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _make_frame(nx, ny, nz):
    """Duff et al. branchless ONB with an fp-noise-tolerant sign threshold
    (so exact-zero fast records and transform-produced noisy zeros choose
    the same frame)."""
    s = torch.where(nz >= -1e-6, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = (1.0 + s * nx * nx * a, s * b, -s * nx)
    bt = (b, s + ny * ny * a, -ny)
    return t, bt, (nx, ny, nz)


def _from_frame(v, t, b, n):
    return (v[0] * t[0] + v[1] * b[0] + v[2] * n[0],
            v[0] * t[1] + v[1] * b[1] + v[2] * n[1],
            v[0] * t[2] + v[1] * b[2] + v[2] * n[2])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _reflect(d, n):
    k = 2.0 * _dot3(d, n)
    return (d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2])


def _hemisphere_cosine(u1, u2):
    z = _ssqrt(u1)
    r = _ssqrt(1.0 - u1)
    phi = 2.0 * _PI * u2
    return (r * torch.cos(phi), r * torch.sin(phi), z)


def _cone_uniform(u1, u2, cos_max):
    z = 1.0 - u1 * (1.0 - cos_max)
    r = _ssqrt(1.0 - z * z)
    phi = 2.0 * _PI * u2
    return (r * torch.cos(phi), r * torch.sin(phi), z)


# --- nearest-positive-crossing closed forms -----------------------------------
# Per-ray forms of the six solids' candidate/normal/contains functions with
# double-where guards, so masked/miss lanes never produce a NaN or an
# infinity (the guards are part of the function: the hand-written kernels
# repeat them literally). Each hit fn
# returns (t, inside): the smallest crossing strictly greater than t_min
# (else +_BIG) and the ray-origin containment flag (convex solids: origin
# containment == 'exiting' at the first crossing).


def _quad(a, b, c):
    disc = b * b - 4.0 * a * c
    v = disc >= 0.0
    sq = _ssqrt(disc)
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    a_ok = torch.abs(a) > 1e-30
    q_ok = torch.abs(q) > 1e-30
    r0 = torch.where(a_ok, _sdiv(q, a), _BIG)
    r1 = torch.where(q_ok, _sdiv(c, q), r0)
    return _minimum(r0, r1), _maximum(r0, r1), v & a_ok


def _first_after(t_min, *cands):
    best = torch.full_like(t_min, _BIG)
    for t, v in cands:
        take = v & (t > t_min) & (t < best)
        best = torch.where(take, t, best)
    return best


def _hit_sphere(o, d, p, t_min):
    r = p[0]
    a = _dot3(d, d)
    b = 2.0 * _dot3(o, d)
    c = _dot3(o, o) - r * r
    lo, hi, v = _quad(a, b, c)
    return _first_after(t_min, (lo, v), (hi, v)), c < 0.0


def _n_sphere(p, pp):
    return p


def _inv_dir(x):
    ok = torch.abs(x) > 1e-30
    return torch.where(ok, _sdiv(1.0, x), torch.where(x >= 0.0, _BIG, -_BIG))


def _hit_box(o, d, p, t_min):
    ix, iy, iz = _inv_dir(d[0]), _inv_dir(d[1]), _inv_dir(d[2])
    t0x = (p[0] - o[0]) * ix
    t1x = (p[3] - o[0]) * ix
    t0y = (p[1] - o[1]) * iy
    t1y = (p[4] - o[1]) * iy
    t0z = (p[2] - o[2]) * iz
    t1z = (p[5] - o[2]) * iz
    lo = _maximum(_maximum(_minimum(t0x, t1x), _minimum(t0y, t1y)),
                     _minimum(t0z, t1z))
    hi = _minimum(_minimum(_maximum(t0x, t1x), _maximum(t0y, t1y)),
                     _maximum(t0z, t1z))
    v = hi >= lo
    inside = ((o[0] >= p[0]) & (o[0] <= p[3]) & (o[1] >= p[1]) & (o[1] <= p[4])
              & (o[2] >= p[2]) & (o[2] <= p[5]))
    return _first_after(t_min, (lo, v), (hi, v)), inside


def _n_box(p, pp):
    """Smallest-distance-to-face-plane pick (analytic.normal_box rule)."""
    cx, cy, cz = 0.5 * (pp[0] + pp[3]), 0.5 * (pp[1] + pp[4]), 0.5 * (pp[2] + pp[5])
    ex, ey, ez = 0.5 * (pp[3] - pp[0]), 0.5 * (pp[4] - pp[1]), 0.5 * (pp[5] - pp[2])
    qx, qy, qz = p[0] - cx, p[1] - cy, p[2] - cz
    dx_ = torch.abs(ex - torch.abs(qx))
    dy_ = torch.abs(ey - torch.abs(qy))
    dz_ = torch.abs(ez - torch.abs(qz))
    on_x = (dx_ <= dy_) & (dx_ <= dz_)
    on_y = ~on_x & (dy_ <= dz_)
    on_z = ~on_x & ~on_y
    sgn = lambda q: torch.where(q >= 0.0, 1.0, -1.0)
    return (torch.where(on_x, sgn(qx), 0.0), torch.where(on_y, sgn(qy), 0.0),
            torch.where(on_z, sgn(qz), 0.0))


def _hit_cylinder(o, d, p, t_min):
    r, h = p[0], p[1]
    a = d[0] * d[0] + d[1] * d[1]
    b = 2.0 * (o[0] * d[0] + o[1] * d[1])
    c = o[0] * o[0] + o[1] * o[1] - r * r
    qlo, qhi, qv = _quad(a, b, c)
    axial = a <= 1e-20
    in_tube = c <= 0.0
    tube_lo = torch.where(axial, torch.where(in_tube, -_BIG, _BIG),
                        torch.where(qv, qlo, _BIG))
    tube_hi = torch.where(axial, torch.where(in_tube, _BIG, -_BIG),
                        torch.where(qv, qhi, -_BIG))
    flat = torch.abs(d[2]) <= 1e-30
    s0 = _sdiv(0.0 - o[2], torch.where(flat, 1e-30, d[2]), 1e-35)
    s1 = _sdiv(h - o[2], torch.where(flat, 1e-30, d[2]), 1e-35)
    in_slab = (o[2] >= 0.0) & (o[2] <= h)
    slab_lo = torch.where(flat, torch.where(in_slab, -_BIG, _BIG),
                        _minimum(s0, s1))
    slab_hi = torch.where(flat, torch.where(in_slab, _BIG, -_BIG),
                        _maximum(s0, s1))
    lo = _maximum(tube_lo, slab_lo)
    hi = _minimum(tube_hi, slab_hi)
    v = hi >= lo
    inside = in_tube & in_slab
    return _first_after(t_min, (lo, v), (hi, v)), inside


def _n_cylinder(p, pp):
    r, h = pp[0], pp[1]
    rad = torch.sqrt(p[0] * p[0] + p[1] * p[1] + 1e-12)
    d_side = torch.abs(rad - r)
    d_bot = torch.abs(p[2])
    d_top = torch.abs(p[2] - h)
    side = (d_side <= d_bot) & (d_side <= d_top)
    bot = ~side & (d_bot <= d_top)
    top = ~side & ~bot
    return (torch.where(side, p[0] / rad, 0.0), torch.where(side, p[1] / rad, 0.0),
            torch.where(bot, -1.0, torch.where(top, 1.0, 0.0)))


def _hit_cone(o, d, p, t_min):
    r, h = p[0], p[1]
    k = _sdiv(r, h, 1e-30)
    wo = h - o[2]
    wd = -d[2]
    a = d[0] * d[0] + d[1] * d[1] - k * k * wd * wd
    b = 2.0 * (o[0] * d[0] + o[1] * d[1] - k * k * wo * wd)
    c = o[0] * o[0] + o[1] * o[1] - k * k * wo * wo
    qlo, qhi, qv = _quad(a, b, c)
    z0 = o[2] + qlo * d[2]
    z1 = o[2] + qhi * d[2]
    v0 = qv & (z0 >= 0.0) & (z0 <= h)
    v1 = qv & (z1 >= 0.0) & (z1 <= h)
    nz = torch.abs(d[2]) > 1e-30
    tc = _sdiv(-o[2], torch.where(nz, d[2], 1.0))
    px = o[0] + tc * d[0]
    py = o[1] + tc * d[1]
    vc = nz & (px * px + py * py <= r * r)
    lim = k * (h - o[2])
    inside = (o[2] >= 0.0) & (o[2] <= h) & (o[0] * o[0] + o[1] * o[1] <= lim * lim)
    return _first_after(t_min, (qlo, v0), (qhi, v1), (tc, vc)), inside


def _n_cone(p, pp):
    r, h = pp[0], pp[1]
    k = _sdiv(r, h, 1e-30)
    rad = torch.sqrt(p[0] * p[0] + p[1] * p[1] + 1e-12)
    d_cap = torch.abs(p[2])
    inv = 1.0 / torch.sqrt(1.0 + k * k)
    d_cone = torch.abs(rad - k * (h - p[2])) * inv
    cap = d_cap <= d_cone
    return (torch.where(cap, 0.0, p[0] / rad * inv),
            torch.where(cap, 0.0, p[1] / rad * inv),
            torch.where(cap, -1.0, k * inv))


def _hit_parabola(o, d, p, t_min):
    r, h = p[0], p[1]
    a4 = _sdiv(r * r, h, 1e-30)
    a = d[0] * d[0] + d[1] * d[1]
    b = 2.0 * (o[0] * d[0] + o[1] * d[1]) + a4 * d[2]
    c = o[0] * o[0] + o[1] * o[1] + a4 * (o[2] - h)
    qlo, qhi, qv = _quad(a, b, c)
    z0 = o[2] + qlo * d[2]
    z1 = o[2] + qhi * d[2]
    v0 = qv & (z0 >= 0.0) & (z0 <= h)
    v1 = qv & (z1 >= 0.0) & (z1 <= h)
    lin = a <= 1e-20
    b_ok = torch.abs(b) > 1e-30
    tl = _sdiv(-c, torch.where(b_ok, b, 1.0))
    zl = o[2] + tl * d[2]
    vl = lin & b_ok & (zl >= 0.0) & (zl <= h)
    t0 = torch.where(lin, tl, qlo)
    v0 = (lin & vl) | (~lin & v0)
    v1 = v1 & ~lin
    nz = torch.abs(d[2]) > 1e-30
    tc = _sdiv(-o[2], torch.where(nz, d[2], 1.0))
    px = o[0] + tc * d[0]
    py = o[1] + tc * d[1]
    vc = nz & (px * px + py * py <= r * r)
    inside = (o[2] >= 0.0) & (o[2] <= h) & (
        o[0] * o[0] + o[1] * o[1] <= a4 * (h - o[2]))
    return _first_after(t_min, (t0, v0), (qhi, v1), (tc, vc)), inside


def _n_parabola(p, pp):
    r, h = pp[0], pp[1]
    a4 = _sdiv(r * r, h, 1e-30)
    d_cap = torch.abs(p[2])
    surf = torch.abs(p[0] * p[0] + p[1] * p[1] + a4 * (p[2] - h))
    cap = d_cap <= surf * 0.5
    return (torch.where(cap, 0.0, 2.0 * p[0]), torch.where(cap, 0.0, 2.0 * p[1]),
            torch.where(cap, -1.0, a4))


# --- torus quartic -------------------------------------------------------------


def _hit_torus(o, d, p, t_min):
    """Z-axis torus, major/minor radii p[0]/p[1] (torus.pyx:46 quartic)."""
    R, r = p[0], p[1]
    dd = _dot3(d, d)
    od = _dot3(o, d)
    oo = _dot3(o, o)
    k = oo - r * r - R * R
    a4 = dd * dd
    a3 = 4.0 * dd * od
    a2 = 2.0 * dd * k + 4.0 * od * od + 4.0 * R * R * d[2] * d[2]
    a1 = 4.0 * k * od + 8.0 * R * R * o[2] * d[2]
    a0 = k * k - 4.0 * R * R * (r * r - o[2] * o[2])
    from ..core.math.polyroots import solve_quartic_components
    from ..primitive.analytic import torus_root_valid

    pairs = []
    for (t_r, v) in solve_quartic_components(a4, a3, a2, a1, a0,
                                             newton_iters=3):
        ts = torch.where(v, t_r, 0.0)
        px = o[0] + ts * d[0]
        py = o[1] + ts * d[1]
        pz = o[2] + ts * d[2]
        # plug-back pseudo-root filter
        pairs.append((t_r, v & torus_root_valid(ts, px, py, pz, R, r)))
    t = _first_after(t_min, *pairs)
    rad = torch.sqrt(o[0] * o[0] + o[1] * o[1] + 1e-12)
    inside = (rad - R) * (rad - R) + o[2] * o[2] <= r * r
    return t, inside


def _n_torus(p, pp):
    """Gradient direction toward the nearest spine-circle point
    (analytic.normal_torus); normalised by the caller's _norm3."""
    R = pp[0]
    rad = torch.sqrt(p[0] * p[0] + p[1] * p[1] + 1e-12)
    return (p[0] - p[0] / rad * R, p[1] - p[1] / rad * R, p[2])


def _contains(tid, p, pp):
    if tid == TYPE_TORUS:
        R, r = pp[0], pp[1]
        rad = torch.sqrt(p[0] * p[0] + p[1] * p[1] + 1e-12)
        return (rad - R) * (rad - R) + p[2] * p[2] <= r * r
    if tid == TYPE_SPHERE:
        return _dot3(p, p) <= pp[0] * pp[0]
    if tid == TYPE_BOX:
        return ((p[0] >= pp[0]) & (p[0] <= pp[3]) & (p[1] >= pp[1])
                & (p[1] <= pp[4]) & (p[2] >= pp[2]) & (p[2] <= pp[5]))
    if tid == TYPE_CYLINDER:
        return ((p[0] * p[0] + p[1] * p[1] <= pp[0] * pp[0])
                & (p[2] >= 0.0) & (p[2] <= pp[1]))
    if tid == TYPE_CONE:
        k = _sdiv(pp[0], pp[1], 1e-30)
        lim = k * (pp[1] - p[2])
        return ((p[2] >= 0.0) & (p[2] <= pp[1])
                & (p[0] * p[0] + p[1] * p[1] <= lim * lim))
    if tid == TYPE_PARABOLA:
        a4 = _sdiv(pp[0] * pp[0], pp[1], 1e-30)
        return (p[2] >= 0.0) & (p[0] * p[0] + p[1] * p[1] <= a4 * (pp[1] - p[2]))
    raise ValueError(f"unsupported type {tid}")


_HIT = {TYPE_SPHERE: _hit_sphere, TYPE_BOX: _hit_box,
        TYPE_CYLINDER: _hit_cylinder, TYPE_CONE: _hit_cone,
        TYPE_PARABOLA: _hit_parabola, TYPE_TORUS: _hit_torus}
_NORMAL = {TYPE_SPHERE: _n_sphere, TYPE_BOX: _n_box,
           TYPE_CYLINDER: _n_cylinder, TYPE_CONE: _n_cone,
           TYPE_PARABOLA: _n_parabola, TYPE_TORUS: _n_torus}


def _conductor_fresnel(ci, n, k):
    """Spectral conducting Fresnel (conductor.pyx:77-149); scalar per bin."""
    ci2 = ci * ci
    n2k2 = n * n + k * k
    two_n_ci = 2.0 * n * ci
    rs = (n2k2 - two_n_ci + ci2) / _maximum(n2k2 + two_n_ci + ci2, 1e-30)
    rp = (n2k2 * ci2 - two_n_ci + 1.0) / _maximum(
        n2k2 * ci2 + two_n_ci + 1.0, 1e-30)
    return 0.5 * (rs + rp)


# --- the bounce --------------------------------------------------------------


def _leaf_local(tget, off, o, d):
    """Ray into a leaf frame via the 12 w2l row scalars at ``off``."""
    m = [tget(off + k) for k in range(12)]
    lo = (m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[3],
          m[4] * o[0] + m[5] * o[1] + m[6] * o[2] + m[7],
          m[8] * o[0] + m[9] * o[1] + m[10] * o[2] + m[11])
    ld = (m[0] * d[0] + m[1] * d[1] + m[2] * d[2],
          m[4] * d[0] + m[5] * d[1] + m[6] * d[2],
          m[8] * d[0] + m[9] * d[1] + m[10] * d[2])
    return m, lo, ld


def _bit(bits, k):
    return ((bits >> k) & 1) > 0


def _bool_to_bit(m, k):
    return m.to(torch.int32) << k


def bounce_core(spec: FusedSpec, tget, state, u, bits):
    """One full wavefront bounce as plain PyTorch ops on flat per-ray
    tensors: the plain version of the hand-written kernels.

    state: dict(o=(x,y,z), d=(x,y,z), thr=tuple[B], alive=bool, depth=f32)
    u:     tuple of 10 per-lane uniform draws
    bits:  None (decide: make decisions inline) or a saved i32 bitfield
           (replay: take the discrete choices from it).
    Returns dict(o, d, thr, rad_delta, alive_next, depth, bits).
    """
    B = spec.bins
    L = len(spec.leaves)
    o, d = state["o"], state["d"]
    thr = list(state["thr"])
    alive_in = state["alive"]
    depth = state["depth"]

    def dec(computed, bitpos):
        """Discrete decision: inline in decide mode, else replayed."""
        if bits is None:
            return computed
        return _bit(bits, bitpos)

    # --- Russian roulette (optical/ray.pyx:380-388) --------------------------
    p_ext = spec.extinction_prob
    roulette_active = alive_in & (depth >= spec.extinction_min_depth)
    killed = roulette_active & (u[6] < p_ext)
    survive_scale = torch.where(roulette_active & ~killed,
                              1.0 / (1.0 - p_ext), 1.0)
    alive = alive_in & ~killed & (depth < spec.max_depth)
    thr = [t * survive_scale for t in thr]

    # --- intersection: static leaf unroll ------------------------------------
    eps = _T_EPS * _maximum(
        1.0, _maximum(torch.abs(o[0]), _maximum(torch.abs(o[1]),
                                                    torch.abs(o[2]))))
    t_leaf = []
    ins_leaf = []
    nrm_leaf = []
    for g, (tid, _e, _m, kind) in enumerate(spec.leaves):
        off = _off_leaf(spec, g)
        if kind == 1:
            # world sphere: 4 scalars, no transforms
            c = (tget(off), tget(off + 1), tget(off + 2))
            r = tget(off + 3)
            p0 = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
            a = _dot3(d, d)
            b = 2.0 * _dot3(p0, d)
            cc = _dot3(p0, p0) - r * r
            lo_t, hi_t, v = _quad(a, b, cc)
            t_g = _first_after(eps, (lo_t, v), (hi_t, v))
            ins_g = cc < 0.0
            t_s = torch.where(t_g < 1e30, t_g, 0.0)
            nw = (p0[0] + t_s * d[0], p0[1] + t_s * d[1], p0[2] + t_s * d[2])
        elif kind == 2:
            # world AABB: 6 scalars, slab test + face pick in world space
            pp = [tget(off + k) for k in range(6)]
            t_g, ins_g = _hit_box(o, d, pp, eps)
            t_s = torch.where(t_g < 1e30, t_g, 0.0)
            pw = (o[0] + t_s * d[0], o[1] + t_s * d[1], o[2] + t_s * d[2])
            nw = _n_box(pw, pp)
        else:
            m12, lo, ld = _leaf_local(tget, off, o, d)
            pp = [tget(off + 12 + k) for k in range(8)]
            t_g, ins_g = _HIT[tid](lo, ld, pp, eps)
            # sanitize miss lanes before the hit-point/normal math (BIG * d
            # overflows to inf)
            t_s = torch.where(t_g < 1e30, t_g, 0.0)
            # local hit point as w2l·(world hit point), NOT lo + t·ld:
            # ill-conditioned face picks on degenerate thin boxes must
            # resolve the same way in every implementation of the bounce
            pw = (o[0] + t_s * d[0], o[1] + t_s * d[1], o[2] + t_s * d[2])
            ph = (m12[0] * pw[0] + m12[1] * pw[1] + m12[2] * pw[2] + m12[3],
                  m12[4] * pw[0] + m12[5] * pw[1] + m12[6] * pw[2] + m12[7],
                  m12[8] * pw[0] + m12[9] * pw[1] + m12[10] * pw[2] + m12[11])
            nl = _NORMAL[tid](ph, pp)
            # local -> world normal via (w2l)^T (inverse-transpose)
            nw = (m12[0] * nl[0] + m12[4] * nl[1] + m12[8] * nl[2],
                  m12[1] * nl[0] + m12[5] * nl[1] + m12[9] * nl[2],
                  m12[2] * nl[0] + m12[6] * nl[1] + m12[10] * nl[2])
        t_leaf.append((t_g, t_s))
        ins_leaf.append(ins_g)
        nrm_leaf.append(nw)

    if bits is None:
        t_best = torch.full_like(o[0], _BIG)
        win = torch.zeros_like(o[0], dtype=torch.int32)
        for g in range(L):
            better = t_leaf[g][0] < t_best
            t_best = torch.where(better, t_leaf[g][0], t_best)
            win = torch.where(better, g, win)
        hit = t_best < 1e30
        if spec.max_distance != float("inf"):
            hit = hit & (t_best <= spec.max_distance)
    else:
        win = (bits >> WIN_SHIFT) & 0x1FF
        hit = _bit(bits, B_HIT)

    # one-hot winner combine (value select over the static leaf loop)
    t_sel = torch.zeros_like(o[0])
    ins_sel = torch.zeros_like(alive)
    nwx = torch.zeros_like(o[0])
    nwy = torch.zeros_like(o[0])
    nwz = torch.zeros_like(o[0])
    for g in range(L):
        mg = win == g
        t_sel = torch.where(mg, t_leaf[g][1], t_sel)
        ins_sel = (mg & ins_leaf[g]) | (~mg & ins_sel)
        nwx = torch.where(mg, nrm_leaf[g][0], nwx)
        nwy = torch.where(mg, nrm_leaf[g][1], nwy)
        nwz = torch.where(mg, nrm_leaf[g][2], nwz)
    t_safe = torch.where(hit, t_sel, 0.0)
    nwx, nwy, nwz = _norm3(nwx, nwy, nwz)
    exiting = dec(ins_sel, B_EXIT)
    # orient outward-away-from-solid (intersect.py flip rule)
    ddn = d[0] * nwx + d[1] * nwy + d[2] * nwz
    flip = (exiting & (ddn < 0.0)) | (~exiting & (ddn > 0.0))
    fs = torch.where(flip, -1.0, 1.0)
    n = (nwx * fs, nwy * fs, nwz * fs)

    point = (o[0] + t_safe * d[0], o[1] + t_safe * d[1], o[2] + t_safe * d[2])
    off_p = _T_EPS * _maximum(
        1.0, _maximum(torch.abs(point[0]),
                         _maximum(torch.abs(point[1]), torch.abs(point[2]))))
    outside_p = (point[0] + n[0] * off_p, point[1] + n[1] * off_p,
                 point[2] + n[2] * off_p)
    inside_p = (point[0] - n[0] * off_p, point[1] - n[1] * off_p,
                point[2] - n[2] * off_p)

    # --- volume stage (optical/ray.pyx:422-455) ------------------------------
    t_seg = t_safe
    rad_delta = [torch.zeros_like(o[0]) for _ in range(B)]
    if spec.volumes:
        mid = (o[0] + 0.5 * t_seg * d[0], o[1] + 0.5 * t_seg * d[1],
               o[2] + 0.5 * t_seg * d[2])
        vol_em = [torch.zeros_like(o[0]) for _ in range(B)]
        thr_v = list(thr)
        for (_e, mat, kind, leaf) in spec.volumes:
            tid = spec.leaves[leaf][0]
            fastk = spec.leaves[leaf][3]
            offl = _off_leaf(spec, leaf)
            if fastk == 1:  # world sphere containment
                cx, cy, cz = tget(offl), tget(offl + 1), tget(offl + 2)
                r = tget(offl + 3)
                dx_ = mid[0] - cx
                dy_ = mid[1] - cy
                dz_ = mid[2] - cz
                inside_v = dx_ * dx_ + dy_ * dy_ + dz_ * dz_ <= r * r
            elif fastk == 2:  # world AABB containment
                pp = [tget(offl + k) for k in range(6)]
                inside_v = _contains(TYPE_BOX, mid, pp)
            else:
                m12 = [tget(offl + k) for k in range(12)]
                pl_ = (m12[0] * mid[0] + m12[1] * mid[1]
                       + m12[2] * mid[2] + m12[3],
                       m12[4] * mid[0] + m12[5] * mid[1]
                       + m12[6] * mid[2] + m12[7],
                       m12[8] * mid[0] + m12[9] * mid[1]
                       + m12[10] * mid[2] + m12[11])
                pp = [tget(offl + 12 + k) for k in range(8)]
                inside_v = _contains(tid, pl_, pp)
            # gate on alive too: a dead lane's segment contributes nothing
            m = inside_v & hit & alive
            mo = _off_mat(spec, mat)
            if kind == VOL_BEER:
                for b in range(B):
                    base = tget(mo + 10 + B + b)  # slot1: transmission
                    ok = base > 1e-9
                    att = torch.where(ok, _spow(base, t_seg), 0.0)
                    thr_v[b] = torch.where(m, thr_v[b] * att, thr_v[b])
            else:  # VOL_HOMOGENEOUS
                for b in range(B):
                    spec0 = tget(mo + 10 + b)
                    vol_em[b] = vol_em[b] + torch.where(m, spec0 * t_seg, 0.0)
        for b in range(B):
            rad_delta[b] = rad_delta[b] + torch.where(
                alive, thr[b] * vol_em[b], 0.0)
        thr = thr_v

    # --- surface stage (wavefront._surface_interaction) ----------------------
    cos_in = -ddn * fs  # -d . n with the oriented normal
    front = cos_in >= 0.0
    abs_cos_in = torch.abs(cos_in)
    n_sh = (torch.where(front, n[0], -n[0]), torch.where(front, n[1], -n[1]),
            torch.where(front, n[2], -n[2]))
    t_f, b_f, n_f = _make_frame(*n_sh)
    refl_origin = tuple(torch.where(front, outside_p[c], inside_p[c])
                        for c in range(3))
    trans_origin = tuple(torch.where(front, inside_p[c], outside_p[c])
                         for c in range(3))

    new_o = list(refl_origin)
    new_d = list(d)
    thr_mul = [torch.zeros_like(o[0]) for _ in range(B)]
    emission = [torch.zeros_like(o[0]) for _ in range(B)]
    continues = torch.zeros_like(alive)
    counts_depth = torch.ones_like(alive)

    # branch masks per material TYPE over the static winner->material map;
    # spectral rows resolve per member material id inside the branch
    by_type = {}
    for g, (_tid, _e, mid, _k) in enumerate(spec.leaves):
        by_type.setdefault(spec.mat_types[mid], {}).setdefault(mid, []).append(g)

    def type_mask(members):
        m = torch.zeros_like(alive)
        for mid, gs in members.items():
            for g in gs:
                m = m | (win == g)
        return m

    def mat_scalar(members, offset_fn):
        """Per-lane table scalar resolved across the branch's material ids."""
        v = torch.zeros_like(o[0])
        for mid, gs in members.items():
            mm = torch.zeros_like(alive)
            for g in gs:
                mm = mm | (win == g)
            v = torch.where(mm, tget(offset_fn(mid)), v)
        return v

    # --- MIS shared precompute (world.pyx:134-253) ---------------------------
    use_mis = spec.importance_sampling and spec.has_importance
    needs_mis = use_mis and any(
        spec.mat_types[mid] in (MAT_LAMBERT, MAT_ROUGH_CONDUCTOR)
        for (_t, _e, mid, _k) in spec.leaves)
    if needs_mis:
        I = spec.n_imp
        axes = []
        cms = []
        wgts = []
        cdfs = []
        for i in range(I):
            oi = _off_imp(spec, i)
            cx, cy, cz = tget(oi), tget(oi + 1), tget(oi + 2)
            r = tget(oi + 3)
            tx = cx - point[0]
            ty = cy - point[1]
            tz = cz - point[2]
            dist2 = tx * tx + ty * ty + tz * tz
            dist = torch.sqrt(dist2 + 1e-12)
            ax = (tx / dist, ty / dist, tz / dist)
            inside_s = dist <= r
            sin2 = torch.clamp(_sdiv(r, dist) ** 2, 0.0, 1.0)
            c2 = 1.0 - sin2
            cm = torch.where(c2 > 0.0, _ssqrt(c2), 0.0)
            cm = torch.where(inside_s, -1.0, cm)
            axes.append(ax)
            cms.append(cm)
            wgts.append(tget(oi + 4))
            cdfs.append(tget(oi + 5))
        # cdf pick (searchsorted 'left' == count of cdf entries < u)
        if bits is None:
            lidx = torch.zeros_like(win)
            for i in range(I):
                lidx = lidx + (cdfs[i] < u[3]).to(torch.int32)
            lidx = torch.clamp(lidx, 0, I - 1)
        else:
            lidx = (bits >> LIGHT_SHIFT) & 0x1F
        ax_s = [torch.zeros_like(o[0]) for _ in range(3)]
        cm_s = torch.zeros_like(o[0])
        for i in range(I):
            mi = lidx == i
            for c in range(3):
                ax_s[c] = torch.where(mi, axes[i][c], ax_s[c])
            cm_s = torch.where(mi, cms[i], cm_s)
        local = _cone_uniform(u[4], u[5], cm_s)
        lt, lb, ln = _make_frame(*ax_s)
        dir_light = _from_frame(local, lt, lb, ln)

        def light_pdf(wo):
            pdf = torch.zeros_like(o[0])
            for i in range(I):
                c = _dot3(axes[i], wo)
                solid = 2.0 * _PI * (1.0 - cms[i])
                pdf_i = torch.where(c >= cms[i],
                                  _sdiv(1.0, _maximum(solid, 1e-12)), 0.0)
                pdf = pdf + wgts[i] * pdf_i
            return pdf

        pick_light = dec(u[0] < spec.important_path_weight, B_PICKLIGHT)
    else:
        lidx = torch.zeros_like(win)
        pick_light = torch.zeros_like(alive)
        dir_light = (torch.zeros_like(o[0]),) * 3
        light_pdf = None

    transmit = torch.zeros_like(alive)
    tir_out = torch.zeros_like(alive)
    check_parity = torch.zeros_like(alive)

    present = {spec.mat_types[mid] for (_t, _e, mid, _k) in spec.leaves}

    # --- emitters (terminal) -------------------------------------------------
    if MAT_EMITTER in present:
        mem = by_type[MAT_EMITTER]
        m = type_mask(mem)
        for b in range(B):
            s0 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            emission[b] = torch.where(m, s0, emission[b])
    if MAT_EMITTER_ANISO in present:
        mem = by_type[MAT_EMITTER_ANISO]
        m = type_mask(mem)
        power = mat_scalar(mem, lambda mid: _off_mat(spec, mid))
        base = _maximum(abs_cos_in, 1e-9)
        factor = _spow(base, power)
        for b in range(B):
            s0 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            emission[b] = torch.where(m, s0 * factor, emission[b])
    if MAT_CHECKERBOARD in present:
        mem = by_type[MAT_CHECKERBOARD]
        m = type_mask(mem)
        width = _maximum(
            mat_scalar(mem, lambda mid: _off_mat(spec, mid)), 1e-12)
        # per-entity local frame (checkerboard.pyx:39 pattern frame)
        plx = torch.zeros_like(o[0])
        ply = torch.zeros_like(o[0])
        plz = torch.zeros_like(o[0])
        for mid, gs in mem.items():
            for g in gs:
                e = spec.leaves[g][1]
                oc = _off_check(spec, e)
                mw = [tget(oc + k) for k in range(12)]
                mg = win == g
                plx = torch.where(mg, mw[0] * point[0] + mw[1] * point[1]
                                + mw[2] * point[2] + mw[3], plx)
                ply = torch.where(mg, mw[4] * point[0] + mw[5] * point[1]
                                + mw[6] * point[2] + mw[7], ply)
                plz = torch.where(mg, mw[8] * point[0] + mw[9] * point[1]
                                + mw[10] * point[2] + mw[11], plz)
        cells = (torch.floor(plx / width).to(torch.int32)
                 + torch.floor(ply / width).to(torch.int32)
                 + torch.floor(plz / width).to(torch.int32))
        parity = dec(cells % 2 == 0, B_PARITY)
        check_parity = parity
        for b in range(B):
            s0 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            s1 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + B + b)
            emission[b] = torch.where(m, torch.where(parity, s0, s1), emission[b])
    if MAT_LIGHT in present:
        mem = by_type[MAT_LIGHT]
        m = type_mask(mem)
        lx = mat_scalar(mem, lambda mid: _off_mat(spec, mid))
        ly = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 1)
        lz = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 2)
        fac = _maximum(0.0, -(lx * n_sh[0] + ly * n_sh[1] + lz * n_sh[2]))
        for b in range(B):
            s0 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            emission[b] = torch.where(m, s0 * fac, emission[b])

    if MAT_PERFECT_REFLECT in present:
        m = type_mask(by_type[MAT_PERFECT_REFLECT])
        rdir = _reflect(d, n_sh)
        for b in range(B):
            thr_mul[b] = torch.where(m, 1.0, thr_mul[b])
        for c in range(3):
            new_d[c] = torch.where(m, rdir[c], new_d[c])
            new_o[c] = torch.where(m, refl_origin[c], new_o[c])
        continues = continues | m

    if MAT_NULL in present:
        m = type_mask(by_type[MAT_NULL])
        continues = continues | m
        counts_depth = counts_depth & ~m
        for c in range(3):
            new_o[c] = torch.where(m, trans_origin[c], new_o[c])
        for b in range(B):
            thr_mul[b] = torch.where(m, 1.0, thr_mul[b])

    if MAT_LAMBERT in present:
        mem = by_type[MAT_LAMBERT]
        m = type_mask(mem)
        dir_bsdf = _from_frame(_hemisphere_cosine(u[1], u[2]), t_f, b_f, n_f)
        if use_mis:
            w_imp = spec.important_path_weight
            out_dir = tuple(torch.where(pick_light, dir_light[c], dir_bsdf[c])
                            for c in range(3))
            pdf_light = light_pdf(out_dir)
            cos_out = _dot3(out_dir, n_sh)
            pdf_bsdf = _maximum(cos_out, 0.0) / _PI
            pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
        else:
            out_dir = dir_bsdf
            cos_out = _dot3(out_dir, n_sh)
            pdf_bsdf = _maximum(cos_out, 0.0) / _PI
            pdf = pdf_bsdf
        ok = m & (pdf > 1e-9) & (cos_out > 0.0)
        w_l = torch.where(ok, pdf_bsdf / _maximum(pdf, 1e-12), 0.0)
        for b in range(B):
            s0 = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            thr_mul[b] = torch.where(m, s0 * w_l, thr_mul[b])
        for c in range(3):
            new_d[c] = torch.where(m, out_dir[c], new_d[c])
            new_o[c] = torch.where(m, refl_origin[c], new_o[c])
        continues = continues | ok

    if MAT_CONDUCTOR in present:
        mem = by_type[MAT_CONDUCTOR]
        m = type_mask(mem)
        rdir = _reflect(d, n_sh)
        for b in range(B):
            nb = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            kb = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + B + b)
            f = _conductor_fresnel(abs_cos_in, nb, kb)
            thr_mul[b] = torch.where(m, f, thr_mul[b])
        for c in range(3):
            new_d[c] = torch.where(m, rdir[c], new_d[c])
            new_o[c] = torch.where(m, refl_origin[c], new_o[c])
        continues = continues | m

    if MAT_ROUGH_CONDUCTOR in present:
        mem = by_type[MAT_ROUGH_CONDUCTOR]
        m = type_mask(mem)
        rough = torch.clamp(mat_scalar(mem, lambda mid: _off_mat(spec, mid)),
                         1e-3, 1.0)
        a2 = rough * rough
        phi = 2.0 * _PI * u[2]
        ct2 = torch.clamp(_sdiv(1.0 - u[1],
                             _maximum(1.0 + (a2 - 1.0) * u[1], 1e-12)),
                       0.0, 1.0)
        ct = torch.sqrt(ct2 + 1e-12)
        st = torch.sqrt(torch.clamp(1.0 - ct2, 1e-12, 1.0))
        h_local = (st * torch.cos(phi), st * torch.sin(phi), ct)
        h_bsdf = _from_frame(h_local, t_f, b_f, n_f)
        wi = (-d[0], -d[1], -d[2])
        wo_bsdf = _reflect(d, h_bsdf)
        if use_mis:
            w_imp = spec.important_path_weight
            wo = tuple(torch.where(pick_light, dir_light[c], wo_bsdf[c])
                       for c in range(3))
        else:
            wo = wo_bsdf
        h_raw = (wi[0] + wo[0], wi[1] + wo[1], wi[2] + wo[2])
        h_len = torch.sqrt(_maximum(_dot3(h_raw, h_raw), 1e-24))
        h = (h_raw[0] / h_len, h_raw[1] / h_len, h_raw[2] / h_len)
        ct_i = _maximum(_dot3(wi, n_sh), 1e-6)
        ct_o = _dot3(wo, n_sh)
        ct_h = _dot3(h, n_sh)
        o_dot_h = _dot3(wo, h)
        dd = ct_h * ct_h * (a2 - 1.0) + 1.0
        d_ggx = a2 / _maximum(_PI * dd * dd, 1e-12)
        pdf_bsdf = 0.25 * d_ggx * torch.abs(
            ct_h / torch.where(torch.abs(o_dot_h) > 1e-9, o_dot_h, 1e-9))
        if use_mis:
            pdf_light = light_pdf(wo)
            pdf = (spec.important_path_weight * pdf_light
                   + (1.0 - spec.important_path_weight) * pdf_bsdf)
        else:
            pdf = pdf_bsdf
        ok = m & (ct_o > 1e-6) & (pdf > 1e-9)

        def g1(c):
            return 2.0 * c / _maximum(
                c + torch.sqrt(a2 + (1.0 - a2) * c * c), 1e-12)

        g_s = g1(ct_i) * g1(_maximum(ct_o, 1e-6))
        w_spec = torch.where(
            ok, d_ggx * g_s / (4.0 * ct_i * _maximum(pdf, 1e-12)), 0.0)
        aoh = torch.abs(o_dot_h)
        for b in range(B):
            nb = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + b)
            kb = mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 10 + B + b)
            f = _conductor_fresnel(aoh, nb, kb)
            thr_mul[b] = torch.where(m, f * w_spec, thr_mul[b])
        for c in range(3):
            new_d[c] = torch.where(m, wo[c], new_d[c])
            new_o[c] = torch.where(m, refl_origin[c], new_o[c])
        continues = continues | ok

    if MAT_DIELECTRIC in present:
        mem = by_type[MAT_DIELECTRIC]
        m = type_mask(mem)
        n_int = torch.where(
            m, _maximum(mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 8),
                           1e-3), 1.5)
        n_ext = torch.where(
            m, _maximum(mat_scalar(mem, lambda mid: _off_mat(spec, mid) + 9),
                           1e-3), 1.0)
        trans_only = mat_scalar(mem, lambda mid: _off_mat(spec, mid)) > 0.5
        c1 = cos_in
        entering = c1 >= 0.0
        n1 = torch.where(entering, n_ext, n_int)
        n2 = torch.where(entering, n_int, n_ext)
        gamma = n1 / n2
        c2s = 1.0 - gamma * gamma * (1.0 - c1 * c1)
        tir = c2s <= 0.0
        sq = torch.where(~tir, _ssqrt(c2s), 0.0)
        temp_t = torch.where(entering, gamma * c1 - sq, gamma * c1 + sq)
        td = _norm3(gamma * d[0] + temp_t * n[0],
                    gamma * d[1] + temp_t * n[1],
                    gamma * d[2] + temp_t * n[2])
        rdir = _reflect(d, n)
        c2 = -_dot3(n, td)
        den1 = n1 * c1 + n2 * c2
        den2 = n1 * c2 + n2 * c1
        r1 = (n1 * c1 - n2 * c2) / torch.where(torch.abs(den1) > 1e-12, den1, 1e-12)
        r2 = (n1 * c2 - n2 * c1) / torch.where(torch.abs(den2) > 1e-12, den2, 1e-12)
        reflectivity = 0.5 * (r1 * r1 + r2 * r2)
        tr = dec(trans_only | (u[0] < (1.0 - reflectivity)), B_TRANSMIT)
        tir = dec(tir, B_TIR)
        tr = tr & ~tir
        dead_tir = tir & trans_only
        ok = m & ~dead_tir
        for b in range(B):
            thr_mul[b] = torch.where(m, torch.where(ok, 1.0, 0.0), thr_mul[b])
        for c in range(3):
            od = torch.where(tr, td[c], rdir[c])
            oo = torch.where(tr, trans_origin[c], refl_origin[c])
            new_d[c] = torch.where(m, od, new_d[c])
            new_o[c] = torch.where(m, oo, new_o[c])
        continues = continues | ok
        transmit = tr
        tir_out = tir

    continues = dec(continues, B_CONT)
    counts_depth = dec(counts_depth, B_CNTD)

    # --- state update (trace_step tail) --------------------------------------
    active = alive & hit
    for b in range(B):
        rad_delta[b] = rad_delta[b] + torch.where(
            active, thr[b] * emission[b], 0.0)
        thr[b] = torch.where(active, thr[b] * thr_mul[b], thr[b])
    thr_max = thr[0]
    for b in range(1, B):
        thr_max = _maximum(thr_max, thr[b])
    alive_next = dec(active & continues & (thr_max > 0.0), B_ALIVENEXT)
    out_o = tuple(torch.where(active, new_o[c], o[c]) for c in range(3))
    out_d = tuple(torch.where(active, new_d[c], d[c]) for c in range(3))
    depth_next = depth + torch.where(active & counts_depth, 1.0, 0.0)

    out_bits = (
        _bool_to_bit(alive, B_ALIVE)
        | _bool_to_bit(hit, B_HIT)
        | _bool_to_bit(transmit, B_TRANSMIT)
        | _bool_to_bit(tir_out, B_TIR)
        | _bool_to_bit(pick_light, B_PICKLIGHT)
        | _bool_to_bit(continues, B_CONT)
        | _bool_to_bit(counts_depth, B_CNTD)
        | _bool_to_bit(alive_next, B_ALIVENEXT)
        | _bool_to_bit(ins_sel, B_EXIT)
        | _bool_to_bit(check_parity, B_PARITY)
        | (lidx << LIGHT_SHIFT)
        | (win << WIN_SHIFT)
    )
    return {
        "o": out_o,
        "d": out_d,
        "thr": tuple(thr),
        "rad_delta": tuple(rad_delta),
        "alive_next": alive_next,
        "depth": depth_next,
        "bits": out_bits,
    }

# --- kernel descriptor -------------------------------------------------------
# int32 words, copied to shared memory by every block (csrc/fused_bounce.cuh
# repeats the layout):
#   [0] L  [1] n_volumes  [2] n_imp  [3] flags  [4] mat_base  [5] imp_base
#   [6] mat_stride (10 + 2 bins)  [7] table size
#   then per leaf 5 words: type, material id, MAT_* code, fast kind,
#                          table offset of the entity's w2l rows (-1: none)
#   then per volume 3 words: material id, VOL_* kind, leaf
DESC_HEADER = 8
DESC_LEAF_WORDS = 5
DESC_VOL_WORDS = 3
F_USE_MIS = 1          # importance sampling on and the scene has emitters
F_NEEDS_MIS = 2        # ... and a Lambert or rough conductor to use it
F_HAS_DIELECTRIC = 4
F_HAS_CHECKER = 8
F_MAX_DISTANCE = 16    # max_distance is finite


def spec_descriptor(spec):
    """The int32 descriptor that steers the data-driven kernels."""
    present = {spec.mat_types[m] for (_t, _e, m, _k) in spec.leaves}
    use_mis = spec.importance_sampling and spec.has_importance
    needs_mis = use_mis and bool(
        present & {MAT_LAMBERT, MAT_ROUGH_CONDUCTOR})
    flags = ((F_USE_MIS if use_mis else 0)
             | (F_NEEDS_MIS if needs_mis else 0)
             | (F_HAS_DIELECTRIC if MAT_DIELECTRIC in present else 0)
             | (F_HAS_CHECKER if MAT_CHECKERBOARD in present else 0)
             | (F_MAX_DISTANCE if spec.max_distance != float("inf") else 0))
    words = [len(spec.leaves), len(spec.volumes), spec.n_imp, flags,
             _mat_base(spec), _imp_base(spec), 10 + 2 * spec.bins,
             tab_size(spec)]
    for (tid, e, m, kind) in spec.leaves:
        check = (_off_check(spec, e)
                 if spec.mat_types[m] == MAT_CHECKERBOARD else -1)
        words += [tid, m, spec.mat_types[m], kind, check]
    for (_e, m, kind, leaf) in spec.volumes:
        words += [m, kind, leaf]
    return np.asarray(words, dtype=np.int32)


def bounce_flops(spec):
    """Approximate f32 operations one live ray spends in one bounce of this
    spec (adds, multiplies, compares and selects counted 1; divide, sqrt,
    sin/cos and pow counted as the ~8 issue slots they cost). Used only to
    place a kernel's time beside the card's f32 peak; the per-type constants
    are hand counts of the closed forms in this file."""
    per_type = {TYPE_SPHERE: 60, TYPE_BOX: 70, TYPE_CYLINDER: 110,
                TYPE_CONE: 130, TYPE_PARABOLA: 140, TYPE_TORUS: 520}
    B = spec.bins
    ops = 40 + 2 * B  # roulette, eps, state update
    for (tid, _e, _m, kind) in spec.leaves:
        if kind == 1:
            ops += 45
        elif kind == 2:
            ops += 60
        else:
            ops += 33 + per_type[tid]
    ops += 90  # winner's normal, orientation, offsets, frame
    for (_e, _m, kind, _leaf) in spec.volumes:
        ops += 30 + (12 * B if kind == VOL_BEER else 3 * B)
    present = {spec.mat_types[m] for (_t, _e, m, _k) in spec.leaves}
    if spec.importance_sampling and spec.has_importance:
        ops += spec.n_imp * 70 + 80
    if MAT_DIELECTRIC in present:
        ops += 120
    ops += 80 + 6 * B  # widest material branch + radiance/throughput update
    return ops


# --- building and loading the kernels ------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_libraries = {}  # bins -> loaded ctypes library (one build per bin count)


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the fused kernels are compiled at first use and "
        "need the CUDA toolkit (PATH or CUDA_HOME)")


def build_library(bins, verbose=False):
    """Compile csrc/fused_kernels.cu for ``bins`` spectral bins into
    ``_build/`` (if its sources are newer than the library) and return the
    library path. ``verbose`` adds ptxas' register/spill report to the
    returned log."""
    src = _CSRC / "fused_kernels.cu"
    hdr = _CSRC / "fused_bounce.cuh"
    _BUILD.mkdir(exist_ok=True)
    out = _BUILD / f"libfused_b{bins}.so"
    log = ""
    newest = max(src.stat().st_mtime, hdr.stat().st_mtime)
    if not out.exists() or out.stat().st_mtime < newest:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-DSRC_BINS={bins}", "-o", str(tmp),
               str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, out)
    return out, log


def _library(bins):
    lib = _libraries.get(bins)
    if lib is None:
        path, _log = build_library(bins)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # tab, n_tab, desc, n_desc, [state in x5], [state out x5], u, bits, N,
        # (n_steps,) max_depth, ext_min_depth, ext_prob, survive_scale,
        # w_imp, one_minus_w_imp, max_distance, stream
        state = [p] * 5
        tail = [i, i, f, f, f, f, f, p]
        lib.fused_bounce_fwd.argtypes = (
            [p, i, p, i] + state + state + [p, p, i] + tail)
        lib.fused_bounce_fwd.restype = i
        lib.fused_span_fwd.argtypes = (
            [p, i, p, i] + state + state + [p, p, i, i] + tail)
        lib.fused_span_fwd.restype = i
        _libraries[bins] = lib
    return lib


# --- packed state ---------------------------------------------------------------
# SoA f32 tensors, one ray per column: o[3,N] d[3,N] thr[B,N] rad[B,N]
# aux[2,N] = (alive as 0/1, depth).

_STATE_KEYS = ("o", "d", "thr", "rad", "aux")


def _check_state(spec, st, extra):
    """Raise on anything the kernels do not take: every tensor f32 (bits
    i32), contiguous, on one device, with the shapes of the packed state."""
    N = st["o"].shape[1]
    want = {"o": (3, N), "d": (3, N), "thr": (spec.bins, N),
            "rad": (spec.bins, N), "aux": (2, N)}
    dev = st["o"].device
    for name, t in list(st.items()) + list(extra.items()):
        shape = want.get(name)
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, state on {dev}")
    return N


def _cfg_args(spec):
    """RayConfig statics as kernel arguments. Derived constants are rounded
    from double exactly where the plain version's Python scalars are."""
    w = spec.important_path_weight
    return (int(spec.max_depth), int(spec.extinction_min_depth),
            float(spec.extinction_prob),
            1.0 / (1.0 - spec.extinction_prob), float(w), 1.0 - w,
            float(min(spec.max_distance, _BIG)))


def _state_of(st):
    return {
        "o": tuple(st["o"]), "d": tuple(st["d"]), "thr": tuple(st["thr"]),
        "alive": st["aux"][0] > 0.5, "depth": st["aux"][1],
    }


def bounce_fwd_plain(spec, tab, st, u):
    """Plain PyTorch version of ``fused_bounce_fwd``: one ``bounce_core``
    call on the packed state. A ray that is not alive after the roulette
    (B_ALIVE clear) reports a zero bitfield: ``bounce_core`` leaves its other
    decision bits unspecified, and nothing reads them."""
    tget = tab.unbind(0).__getitem__
    out = bounce_core(spec, tget, _state_of(st), tuple(u), None)
    new = {
        "o": torch.stack(out["o"]),
        "d": torch.stack(out["d"]),
        "thr": torch.stack(out["thr"]),
        "rad": st["rad"] + torch.stack(out["rad_delta"]),
        "aux": torch.stack([torch.where(out["alive_next"], 1.0, 0.0),
                            out["depth"]]),
    }
    bits = out["bits"]
    return new, torch.where((bits & 1) > 0, bits, 0)


def span_fwd_plain(spec, tab, st, u_all):
    """Plain PyTorch version of ``fused_span_fwd``: the Python loop over
    ``u_all[n_steps, 10, N]``; returns (state, bits[n_steps, N])."""
    bits = []
    for u in u_all:
        st, b = bounce_fwd_plain(spec, tab, st, u)
        bits.append(b)
    return st, torch.stack(bits)


def _launch(fn_name, spec, tab, desc, st, u, n_steps):
    """Shared body of the two kernel wrappers for CUDA tensors."""
    N = _check_state(spec, st, {"u": u, "tab": tab})
    if desc.dtype != torch.int32 or desc.device != tab.device:
        raise TypeError("desc must be an int32 tensor on the state's device")
    if tab.numel() != tab_size(spec):
        raise ValueError(f"tab: {tab.numel()} floats, want {tab_size(spec)}")
    lib = _library(spec.bins)
    out = {k: torch.empty_like(st[k]) for k in _STATE_KEYS}
    if n_steps is None:
        bits = torch.empty((N,), dtype=torch.int32, device=tab.device)
        steps = []
    else:
        # rays that die early leave the loop; their later bitfields are 0
        bits = torch.zeros((n_steps, N), dtype=torch.int32, device=tab.device)
        steps = [n_steps]
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    with torch.cuda.device(tab.device):
        err = getattr(lib, fn_name)(
            tab.data_ptr(), tab.numel(), desc.data_ptr(), desc.numel(),
            *[st[k].data_ptr() for k in _STATE_KEYS],
            *[out[k].data_ptr() for k in _STATE_KEYS],
            u.data_ptr(), bits.data_ptr(), N, *steps,
            *_cfg_args(spec), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
    return out, bits


def fused_bounce_fwd(spec, tab, desc, st, u):
    """One bounce for every ray: ``st`` packed state, ``u`` f32[10, N].
    Returns (new packed state, bits i32[N]). CUDA tensors launch the
    hand-written kernel or raise; CPU tensors take the plain version."""
    if tuple(u.shape) != (N_UNIFORMS, st["o"].shape[1]):
        raise ValueError(f"u: shape {tuple(u.shape)}")
    if not tab.is_cuda:
        return bounce_fwd_plain(spec, tab, st, u)
    res = _launch("fused_bounce_fwd", spec, tab, desc, st, u, None)
    fused_bounce_fwd.launches += 1
    return res


def fused_span_fwd(spec, tab, desc, st, u_all):
    """``n_steps`` bounces in one kernel: ``u_all`` f32[n_steps, 10, N].
    Returns (final packed state, bits i32[n_steps, N])."""
    if (u_all.dim() != 3
            or tuple(u_all.shape[1:]) != (N_UNIFORMS, st["o"].shape[1])):
        raise ValueError(f"u_all: shape {tuple(u_all.shape)}")
    if not tab.is_cuda:
        return span_fwd_plain(spec, tab, st, u_all)
    res = _launch("fused_span_fwd", spec, tab, desc, st, u_all,
                  int(u_all.shape[0]))
    fused_span_fwd.launches += 1
    return res


fused_bounce_fwd.launches = 0
fused_span_fwd.launches = 0


# --- what wavefront.trace_rays calls ---------------------------------------------


def pack_state(state):
    """RayState -> packed SoA dict (f32; a bf16 spectral state widens here
    and rounds back only in ``unpack_state``, never inside a span)."""
    aux = torch.stack([torch.where(state.alive, 1.0, 0.0),
                       state.depth.to(torch.float32)])
    return {
        "o": state.origin.to(torch.float32).t().contiguous(),
        "d": state.direction.to(torch.float32).t().contiguous(),
        "thr": state.throughput.to(torch.float32).t().contiguous(),
        "rad": state.radiance.to(torch.float32).t().contiguous(),
        "aux": aux,
    }


def unpack_state(packed, template, seg_add):
    sdt = template.throughput.dtype
    return dataclasses.replace(
        template,
        origin=packed["o"].t().contiguous(),
        direction=packed["d"].t().contiguous(),
        throughput=packed["thr"].t().contiguous().to(sdt),
        radiance=packed["rad"].t().contiguous().to(sdt),
        alive=packed["aux"][0] > 0.5,
        depth=torch.round(packed["aux"][1]).to(torch.int32),
        segments=template.segments + seg_add,
    )


def pack_u(u_all):
    """[n_steps, N, >=10] -> f32[n_steps, 10, N]."""
    return u_all[:, :, :N_UNIFORMS].permute(0, 2, 1).contiguous()


def fused_forward_span(tab, desc, spec, state, u_all, span="multi",
                       early_exit=True):
    """Forward fused trace of one span: ``u_all`` is [n_steps, N, >=10].
    ``span="multi"`` runs the whole span in one ``fused_span_fwd``;
    ``"perbounce"`` runs one ``fused_bounce_fwd`` per bounce, stopping once
    every ray is dead when ``early_exit``. Returns RayState."""
    if span not in ("multi", "perbounce"):
        raise ValueError(f"span must be 'multi' or 'perbounce', got {span!r}")
    st = pack_state(state)
    u_p = pack_u(u_all.to(torch.float32))
    if span == "multi":
        out, bits = fused_span_fwd(spec, tab, desc, st, u_p)
        seg = torch.sum(bits & 1, dtype=torch.int32)
        return unpack_state(out, state, seg)
    seg = torch.zeros((), dtype=torch.int32, device=tab.device)
    for u in u_p:
        if early_exit and not bool((st["aux"][0] > 0.5).any()):
            break
        st, bits = fused_bounce_fwd(spec, tab, desc, st, u)
        seg = seg + torch.sum(bits & 1, dtype=torch.int32)
    return unpack_state(st, state, seg)
