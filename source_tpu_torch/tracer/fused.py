"""Fused bounce tracer for analytic scenes: spec, table, plain version, kernels.

For scenes that qualify (all-analytic simple entities, built-in material
set, Beer/homogeneous volumes) a whole path-tracing bounce — Russian
roulette, intersection of every leaf, winner select, volumes, material
dispatch, state update — is ONE function per ray. Reference analogue: the
whole recursive ``Ray.trace`` loop (raysect/optical/ray.pyx:338-455 +
material dispatch).

One function, its adjoint, and six kernels:

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
    and the choice bitfields written per bounce. With the kernel RNG
    (``seed=``) it reads no uniforms: it draws them in registers with
    Philox4x32-10 (csrc/philox.cuh) keyed by the span's seed and counted by
    (lane, absolute bounce); ``philox_uniforms`` is the same stream in torch
    integer ops.
  * ``fused_bounce_bwd`` launches ``fused_bounce_bwd``
    (csrc/fused_bwd_kernels.cu): the vector-Jacobian product of one replayed
    bounce, cotangents of the ray state in, cotangents of the entry state
    and of the scene table out. Its plain version is ``bounce_bwd_plain``:
    ``torch.autograd.grad`` of ``bounce_core`` in replay mode.
  * ``fused_span_bwd`` launches ``fused_span_bwd``: replays a whole span
    from its entry state, saving each bounce's entry state to scratch, then
    chains the per-bounce adjoints in reverse inside the kernel. Its plain
    version is ``span_bwd_plain``. Under the kernel RNG it draws the
    forward's uniforms again from the same seed.
  * ``fused_bounce_replay`` and ``fused_bounce_io`` launch the profiling
    kernels of that name: ``fused_bounce_fwd`` with its decisions replayed
    from a bitfield (plain version ``bounce_replay_plain``, ``bounce_core``
    with ``bits``), and its loads and stores with no bounce (plain version
    ``bounce_io_plain``, a copy). They are the same bounce loop as
    ``fused_bounce_fwd`` in other modes and take its schedule (``live``,
    ``survivors``, ``in_place``), so their times beside its time on the
    forward route split it into decision path, arithmetic and load/store
    floor.

Every wrapper takes the plain version for CPU tensors and launches the kernel
— or raises — for CUDA tensors; each counts its launches.
``fused_forward_span`` drives a span of bounces for ``wavefront.trace_rays``;
``fused_span`` is its differentiable counterpart for
``wavefront.trace_rays_diff``: an ``autograd.Function`` per route (one
kernel per bounce each way, or one per span each way) whose backward hands
the table cotangent on to ``pack_tabvec``, which is plain differentiable
tensor code, and so to the scene's tensors.

The kernels are data-driven: one compiled library per bin count serves every
scene, steered by an int32 descriptor of the spec (``spec_descriptor``) and
the flat f32 table (``pack_tabvec``), both copied to shared memory per block.
``scene_tables`` caches what depends only on (scene, spec) on the scene.
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

__all__ = ["FusedSpec", "fused_spec", "general_spec", "pack_tabvec",
           "spec_descriptor", "scene_tables", "forward_table", "bounce_core",
           "fused_bounce_fwd", "fused_span_fwd", "fused_bounce_bwd",
           "fused_span_bwd", "bounce_bwd_plain", "span_bwd_plain",
           "adjoint_key_plain", "bin_live_lanes_plain", "bin_live_lanes",
           "fused_bounce_replay", "fused_bounce_io", "bounce_replay_plain",
           "bounce_io_plain", "philox4x32", "philox_uniforms",
           "fused_forward_span", "fused_span", "build_library"]

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


def general_spec(spec):
    """The spec with fast records disabled (all leaves general local-frame).

    The differentiable span uses this: a fast record's world-space
    expression coincides with the general one in value at the compiled
    transform but is a different local extension of it, so its w2l
    cotangents differ (the world-AABB route is blind to rotation
    perturbations). Forward-only tracing keeps the fast records."""
    return dataclasses.replace(
        spec, leaves=tuple((t, e, m, 0) for (t, e, m, _k) in spec.leaves))


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
    """Differentiable flat f32[T] view of the scene tables the bounce reads,
    as tensor ops on the scene's device: autograd carries a table cotangent
    back to ``leaf_w2l``, ``leaf_params``, ``mat_*``, ``imp_*`` and
    ``entity_w2l``. Forward-only callers run it under ``torch.no_grad()``.

    Fast-record leaves bake WORLD-space fields (sphere centre+radius, box
    AABB) computed from inv(w2l), the 8-corner product as explicit mul-add
    (never a reduced-precision matrix product)."""
    L = len(spec.leaves)
    f32 = torch.float32
    w2l = scene.leaf_w2l.to(f32)
    params = scene.leaf_params.to(f32)
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
                row = torch.cat([c, p[0][None], p.new_zeros(16)])
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
                row = torch.cat([wc.amin(dim=0), wc.amax(dim=0),
                                 p.new_zeros(14)])
            rows.append(row)
        leaf_rows = torch.stack(rows)
    parts = [leaf_rows.reshape(-1)]
    mat_spectra = scene.mat_spectra.to(f32)
    parts.append(torch.cat(
        [scene.mat_params.to(f32)[:, :8], scene.mat_scalars.to(f32)[:, :2],
         mat_spectra[:, 0, :], mat_spectra[:, 1, :]], dim=1).reshape(-1))
    parts.append(torch.cat(
        [scene.imp_centre.to(f32), scene.imp_radius.to(f32)[:, None],
         scene.imp_weight.to(f32)[:, None], scene.imp_cdf.to(f32)[:, None]],
        dim=1).reshape(-1))
    entity_w2l = scene.entity_w2l.to(f32)
    for e in spec.check_entities:
        parts.append(entity_w2l[e, :3, :].reshape(12))
    return torch.cat(parts)


# the scene tensors pack_tabvec reads: the float fields a gradient lands on
TABLE_FIELDS = ("leaf_w2l", "leaf_params", "mat_params", "mat_spectra",
                "mat_scalars", "imp_centre", "imp_radius", "imp_weight",
                "imp_cdf", "entity_w2l")


def scene_tables(scene, cfg, general=False):
    """(spec, entry) for an eligible (scene, cfg), else None, cached on the
    scene: the ``FusedSpec`` per ray configuration and, per spec, an entry
    holding the descriptor on the scene's device (``entry["desc"]``) and the
    forward table of ``forward_table``. ``general`` asks for the
    differentiable route's ``general_spec``."""
    cache = scene.fused_cache
    if cfg not in cache:
        cache[cfg] = fused_spec(scene, cfg)
    spec = cache[cfg]
    if spec is None:
        return None
    if general:
        spec = general_spec(spec)
    entry = cache.get(spec)
    if entry is None:
        entry = cache[spec] = {
            "desc": torch.as_tensor(spec_descriptor(spec),
                                    device=scene.device),
            "tab": None, "stamp": ()}
    return spec, entry


def forward_table(scene, spec, entry):
    """The detached table of ``spec`` for forward-only tracing, rebuilt only
    when a source tensor was replaced or edited in place since it was packed
    (an optimiser updates scene tensors between steps)."""
    stamp = tuple((t, t._version)
                  for t in (getattr(scene, f) for f in TABLE_FIELDS))
    old = entry["stamp"]
    if len(old) != len(stamp) or any(
            a is not b or va != vb for (a, va), (b, vb) in zip(old, stamp)):
        with torch.no_grad():
            entry["tab"] = pack_tabvec(scene, spec)
        entry["stamp"] = stamp
    return entry["tab"]


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


def bounce_flops(spec, replay=False):
    """Approximate f32 operations one live ray spends in one bounce of this
    spec (adds, multiplies, compares and selects counted 1; divide, sqrt,
    sin/cos and pow counted as the ~8 issue slots they cost). Used only to
    place a kernel's time beside the card's f32 peak; the per-type constants
    are hand counts of the closed forms in this file. ``replay``: the bounce
    of ``fused_bounce_replay``, which tests the winning leaf alone (counted as
    the mean leaf)."""
    per_type = {TYPE_SPHERE: 60, TYPE_BOX: 70, TYPE_CYLINDER: 110,
                TYPE_CONE: 130, TYPE_PARABOLA: 140, TYPE_TORUS: 520}
    B = spec.bins
    ops = 40 + 2 * B  # roulette, eps, state update
    leaf_ops = [45 if kind == 1 else 60 if kind == 2 else 33 + per_type[tid]
                for (tid, _e, _m, kind) in spec.leaves]
    ops += sum(leaf_ops) // len(leaf_ops) if replay else sum(leaf_ops)
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


def bounce_bwd_flops(spec):
    """Approximate f32 operations one live ray spends in the adjoint of one
    bounce of this spec, counted as in ``bounce_flops``. The adjoint replays
    the winner's side of the bounce only (one hit function, one normal, one
    material, the volumes, the light cones) and then runs the reverse pass,
    which costs about twice the replayed forward, plus the cotangent update
    of the throughput and radiance rows."""
    per_type = {TYPE_SPHERE: 60, TYPE_BOX: 70, TYPE_CYLINDER: 110,
                TYPE_CONE: 130, TYPE_PARABOLA: 140, TYPE_TORUS: 520}
    B = spec.bins
    L = len(spec.leaves)
    fwd = 40 + 2 * B + 33 + 90
    fwd += sum(per_type[t] for (t, _e, _m, _k) in spec.leaves) // max(L, 1)
    for (_e, _m, kind, _leaf) in spec.volumes:
        fwd += 30 + (12 * B if kind == VOL_BEER else 3 * B)
    present = {spec.mat_types[m] for (_t, _e, m, _k) in spec.leaves}
    if spec.importance_sampling and spec.has_importance:
        fwd += spec.n_imp * 70 + 80
    if MAT_DIELECTRIC in present:
        fwd += 120
    fwd += 80 + 6 * B
    return 3 * fwd + 8 * B


# --- the span kernels' in-kernel generator: its plain version --------------------
# Philox4x32-10 (csrc/philox.cuh) in torch integer ops. Torch's CPU build has
# no uint32 arithmetic, so the words live in int64 and are masked to 32 bits;
# the 32x32 -> 64-bit product of a round would overflow int64, so it is taken
# in 16-bit halves of the counter word.

_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # Weyl increments of the key
PHILOX_ROUNDS = 10
PHILOX_DRAWS = 3  # calls per ray and bounce: 12 words, the first 10 used
# integer operations one ray spends on one bounce's uniforms: per call and
# round two 32x32 products as mul-lo and mul-hi (4) and four xors, a key bump
# of two adds between rounds, and one shift per uniform
PHILOX_OPS = PHILOX_DRAWS * (PHILOX_ROUNDS * 8 + (PHILOX_ROUNDS - 1) * 2) \
    + N_UNIFORMS


def _mulhilo(m, b):
    """(high, low) 32-bit words of the product of the constant ``m`` and the
    uint32 words ``b`` (int64 tensors)."""
    p_lo = m * (b & 0xFFFF)           # < 2**48
    p_hi = m * (b >> 16)              # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 of the counter words ``ctr`` (four int64 tensors or
    ints holding uint32) under the key ``key`` (two); returns four int64
    tensors of uint32 words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _MASK32 for k in key)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed, n_lanes, start, n_steps, device=None, first_lane=0):
    """The uniforms the span kernels draw with the kernel RNG, f32[n_steps,
    10, N] (the layout ``pack_u`` gives): for ray ``lane`` at absolute bounce
    ``start + i``, Philox4x32-10 of the counters (lane, start + i, j, 0) for
    j = 0, 1, 2 under the key ``seed`` (an i32[2] tensor, on ``device`` or the
    default), the first 10 of the 12 words each as (w >> 8) * 2**-24, in
    [0, 1 - 2**-24]. A lane's stream depends on its index in the batch and
    the bounce index, never on how the batch is cut into blocks: the lanes
    ``first_lane`` .. ``first_lane + n_lanes - 1`` drawn alone are those
    lanes of a draw of the whole batch."""
    seed = torch.as_tensor(seed, device=device)
    dev = seed.device
    key = seed.to(torch.int64) & _MASK32
    lane = first_lane + torch.arange(n_lanes, dtype=torch.int64, device=dev)
    bounce = start + torch.arange(n_steps, dtype=torch.int64, device=dev)
    draw = torch.arange(PHILOX_DRAWS, dtype=torch.int64, device=dev)
    shape = (n_steps, PHILOX_DRAWS, n_lanes)
    ctr = (lane[None, None, :].expand(shape), bounce[:, None, None].expand(shape),
           draw[None, :, None].expand(shape),
           torch.zeros((), dtype=torch.int64, device=dev))
    words = torch.stack(philox4x32(ctr, (key[0], key[1])), dim=2)
    words = words.reshape(n_steps, 4 * PHILOX_DRAWS, n_lanes)[:, :N_UNIFORMS]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --- building and loading the kernels ------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# library -> (translation unit, the headers it includes). The adjoint kernels
# are a translation unit of their own: both build in parallel, and a change to
# the adjoint never moves the forward kernels' code.
_SOURCES = {
    "fwd": ("fused_kernels.cu", ("fused_bounce.cuh", "lane_schedule.cuh",
                                 "philox.cuh")),
    "bwd": ("fused_bwd_kernels.cu", ("fused_bounce.cuh", "fused_adjoint.cuh",
                                     "lane_schedule.cuh", "philox.cuh")),
}
_libraries = {}  # (which, bins) -> loaded ctypes library


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the fused kernels are compiled at first use and "
        "need the CUDA toolkit (PATH or CUDA_HOME)")


def build_library(bins, which="fwd", verbose=False):
    """Compile the forward (``which="fwd"``, csrc/fused_kernels.cu) or the
    adjoint (``"bwd"``, csrc/fused_bwd_kernels.cu) kernels for ``bins``
    spectral bins into ``_build/`` (if the sources are newer than the
    library) and return (library path, compiler log). ``verbose`` adds
    ptxas' register/spill report to the log."""
    unit, headers = _SOURCES[which]
    return nvcc_build(unit, headers, f"libfused_{which}_b{bins}.so",
                      (f"-DSRC_BINS={bins}",), verbose)


def nvcc_build(unit, headers, name, defines=(), verbose=False):
    """Compile ``csrc/<unit>`` (which includes ``headers``) with NVCC_FLAGS
    into ``_build/<name>`` unless the library is newer than every source;
    returns (library path, compiler log)."""
    src = _CSRC / unit
    _BUILD.mkdir(exist_ok=True)
    out = _BUILD / name
    log = ""
    newest = max(f.stat().st_mtime for f in [src] + [_CSRC / h for h in headers])
    if not out.exists() or out.stat().st_mtime < newest:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, out)
    return out, log


def _library(bins, which="fwd"):
    lib = _libraries.get((which, bins))
    if lib is None:
        path, _log = build_library(bins, which)
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # max_depth, ext_min_depth, ext_prob, survive_scale, w_imp,
        # one_minus_w_imp, max_distance, stream
        tail = [i, i, f, f, f, f, f, p]
        if which == "fwd":
            # tab, n_tab, desc, n_desc, [state in x5], [state out x5], u,
            # (seed, start,) bits (the replay's in, the others' out), (live
            # lanes in: list, count; out: list, count | rows, int
            # workspace, trace,) N, (n_steps,) tail; the I/O kernel takes
            # no configuration
            head = [p, i, p, i] + [p] * 10
            per_bounce = head + [p] * 6 + [i]
            lib.fused_bounce_fwd.argtypes = per_bounce + tail
            lib.fused_span_fwd.argtypes = (head + [p, p, i, p, p, p, p, i, i]
                                           + tail)
            lib.fused_bounce_replay.argtypes = per_bounce + tail
            lib.fused_bounce_io.argtypes = per_bounce + [p]
            lib.fused_span_fwd_words.argtypes = [i, i]
            lib.fused_span_fwd_floats.argtypes = [i]
            lib.fused_span_fwd_words.restype = ctypes.c_longlong
            lib.fused_span_fwd_floats.restype = ctypes.c_longlong
            fns = (lib.fused_bounce_fwd, lib.fused_span_fwd,
                   lib.fused_bounce_replay, lib.fused_bounce_io)
        else:
            # tab, n_tab, desc, n_desc, entry o d thr aux, u, (seed, start,)
            # bits, cotangents in go gd gthr g_rad, out go gd gthr, table
            # cotangent, (perm, count | scratch, replay_out, int workspace,)
            # N, (n_steps,) tail
            lib.fused_bounce_bwd.argtypes = [p, i, p, i] + [p] * 16 + [i] + tail
            lib.fused_span_bwd.argtypes = (
                [p, i, p, i] + [p] * 5 + [p, i] + [p] * 12 + [i, i] + tail)
            # bits, N, n_leaves, perm, count, workspace, stream
            lib.adjoint_bin.argtypes = [p, i, i, p, p, p, p]
            lib.adjoint_bin_words.argtypes = [i, i]
            lib.fused_span_bwd_words.argtypes = [i, i, i]
            lib.fused_span_bwd_floats.argtypes = [i, i]
            fns = (lib.fused_bounce_bwd, lib.fused_span_bwd, lib.adjoint_bin)
            for fn in (lib.adjoint_bin_words, lib.fused_span_bwd_words,
                       lib.fused_span_bwd_floats):
                fn.restype = ctypes.c_longlong
        for fn in fns:
            fn.restype = i
        _libraries[(which, bins)] = lib
    return lib


# --- packed state ---------------------------------------------------------------
# SoA f32 tensors, one ray per column: o[3,N] d[3,N] thr[B,N] rad[B,N]
# aux[2,N] = (alive as 0/1, depth).

_STATE_KEYS = ("o", "d", "thr", "rad", "aux")


def _check_state(spec, st, extra):
    """Raise on anything the kernels do not take: every tensor f32,
    contiguous, on one device, with the shapes of the packed state (the
    cotangents ``go gd gthr g_rad`` have the shapes of ``o d thr rad``)."""
    N = st["o"].shape[1]
    want = {"o": (3, N), "d": (3, N), "thr": (spec.bins, N),
            "rad": (spec.bins, N), "aux": (2, N), "go": (3, N), "gd": (3, N),
            "gthr": (spec.bins, N), "g_rad": (spec.bins, N)}
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


def _check_tables(spec, tab, desc):
    if desc.dtype != torch.int32 or desc.device != tab.device:
        raise TypeError("desc must be an int32 tensor on the state's device")
    if tab.numel() != tab_size(spec):
        raise ValueError(f"tab: {tab.numel()} floats, want {tab_size(spec)}")


def _check_bits(bits, shape, dev):
    if (bits.dtype != torch.int32 or tuple(bits.shape) != shape
            or bits.device != dev or not bits.is_contiguous()):
        raise ValueError(f"bits must be a contiguous int32{list(shape)} on {dev}")


def _check_seed(seed, dev):
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32
            or tuple(seed.shape) != (2,) or seed.device != dev
            or not seed.is_contiguous()):
        raise ValueError(f"seed must be a contiguous int32[2] tensor on {dev}")


def _uniform_source(u_all, seed, n_steps, N):
    """The span's number of bounces, from exactly one of ``u_all``
    f32[n_steps, 10, N] (host RNG) or ``seed`` with ``n_steps`` (kernel
    RNG)."""
    if (u_all is None) == (seed is None):
        raise ValueError("pass exactly one of u_all (host RNG) or seed "
                         "(kernel RNG)")
    if u_all is not None:
        if u_all.dim() != 3 or tuple(u_all.shape[1:]) != (N_UNIFORMS, N):
            raise ValueError(f"u_all: shape {tuple(u_all.shape)}")
        if n_steps is not None and n_steps != u_all.shape[0]:
            raise ValueError(f"n_steps {n_steps}, u_all holds {u_all.shape[0]}")
        return int(u_all.shape[0])
    if n_steps is None:
        raise ValueError("the kernel RNG needs n_steps")
    return int(n_steps)


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


def _packed_bounce(spec, tab, st, u, bits):
    """``bounce_core`` on the packed state: (new packed state, bitfield)."""
    out = bounce_core(spec, tab.unbind(0).__getitem__, _state_of(st),
                      tuple(u), bits)
    new = {
        "o": torch.stack(out["o"]),
        "d": torch.stack(out["d"]),
        "thr": torch.stack(out["thr"]),
        "rad": st["rad"] + torch.stack(out["rad_delta"]),
        "aux": torch.stack([torch.where(out["alive_next"], 1.0, 0.0),
                            out["depth"]]),
    }
    return new, out["bits"]


def bounce_fwd_plain(spec, tab, st, u):
    """Plain PyTorch version of ``fused_bounce_fwd``: one ``bounce_core``
    call on the packed state. A ray that is not alive after the roulette
    (B_ALIVE clear) reports a zero bitfield: ``bounce_core`` leaves its other
    decision bits unspecified, and nothing reads them."""
    new, bits = _packed_bounce(spec, tab, st, u, None)
    return new, torch.where((bits & 1) > 0, bits, 0)


def bounce_replay_plain(spec, tab, st, u, bits):
    """Plain PyTorch version of ``fused_bounce_replay``: ``bounce_core`` in
    replay mode on the packed state, the decisions taken from ``bits``. A ray
    that enters dead, or that the roulette stops (its bitfield from
    ``fused_bounce_fwd`` is 0), keeps its state as in ``bounce_fwd_plain``.
    Returns the new packed state."""
    return _packed_bounce(spec, tab, st, u, bits)[0]


def bounce_io_plain(spec, tab, st, u):
    """Plain PyTorch version of ``fused_bounce_io``: the state copied, a zero
    bitfield."""
    return ({k: st[k].clone() for k in _STATE_KEYS},
            torch.zeros(st["o"].shape[1], dtype=torch.int32,
                        device=st["o"].device))


def span_fwd_plain(spec, tab, st, u_all):
    """Plain PyTorch version of ``fused_span_fwd``: the Python loop over
    ``u_all[n_steps, 10, N]``; returns (state, bits[n_steps, N])."""
    bits = []
    for u in u_all:
        st, b = bounce_fwd_plain(spec, tab, st, u)
        bits.append(b)
    return st, torch.stack(bits)


def live_lanes_plain(aux):
    """The lanes alive in the packed state's ``aux`` (aux[0] > 0.5), sorted:
    i32[n]. ``fused_bounce_fwd`` lists the same lanes, in the order of its
    atomics, for the next bounce."""
    return (aux[0] > 0.5).nonzero().squeeze(1).to(torch.int32)


def _live_list_plain(aux):
    """``live_lanes_plain`` in the layout of the kernel's list: (lanes i32[N]
    whose first ``count[0]`` entries are the live lanes, -1 after them,
    count i32[1])."""
    live = live_lanes_plain(aux)
    lanes = torch.full((aux.shape[1],), -1, dtype=torch.int32,
                       device=aux.device)
    lanes[:live.numel()] = live
    return lanes, torch.tensor([live.numel()], dtype=torch.int32,
                               device=aux.device)


# --- the span kernel's schedule ----------------------------------------------------
# fused_span_fwd walks each warp's 32 lanes in registers while at least
# SPILL_AT of them are alive (the head); below that the survivors move to
# lane-major rows and are run step by step, each step's lanes dense over the
# grid (the tail). The kernel compiles in its own SPILL_AT
# (csrc/fused_kernels.cu); this one is the plain model's default, and a test
# holds the two equal.
SPILL_AT = 24
WARP = 32


def _rows_of(st):
    """Packed state -> lane-major rows f32[N, 8 + 2B] (o d thr rad aux)."""
    return torch.cat([st[k] for k in _STATE_KEYS]).t().contiguous()


def _state_of_rows(rows, bins):
    parts = rows.t().split((3, 3, bins, bins, 2))
    return {k: v.contiguous() for k, v in zip(_STATE_KEYS, parts)}


def _bounce_lanes(spec, tab, st, u, lanes):
    """``bounce_fwd_plain`` on the lanes ``lanes`` of ``st`` gathered:
    (their new state, their bitfields)."""
    sub = {k: v[:, lanes] for k, v in st.items()}
    return bounce_fwd_plain(spec, tab, sub, u[:, lanes])


def span_fwd_scheduled_plain(spec, tab, st, u_all, spill_at=SPILL_AT):
    """Plain model of ``fused_span_fwd``'s schedule at ``spill_at``: the head
    walks each chunk of 32 lanes (a warp's) step by step while at least
    ``spill_at`` of its lanes are alive; then its survivors are handed off:
    their state written to lane-major rows and their lanes queued for that
    step; the tail then runs step by step, each step's queued lanes gathered
    from their rows, bounced, written back, and the survivors queued for the
    next step; at the end the rows of the handed-off lanes are the output.
    Uniforms and bitfields stay indexed by the lane. Returns (state,
    bits[n_steps, N]): ``span_fwd_plain``'s, lane for lane (on the CPU to the
    rounding of a lane evaluated at another position of a tensor)."""
    N, n_steps = st["o"].shape[1], u_all.shape[0]
    dev = st["o"].device
    out = {k: v.clone() for k, v in st.items()}
    bits = torch.zeros((n_steps, N), dtype=torch.int32, device=dev)
    chunk = torch.arange(N, device=dev) // WARP
    n_chunks = (N + WARP - 1) // WARP
    walking = torch.ones(n_chunks, dtype=torch.bool, device=dev)
    rows = torch.zeros((N, 8 + 2 * spec.bins), dtype=torch.float32, device=dev)
    moved = torch.zeros(N, dtype=torch.bool, device=dev)
    queue = [[] for _ in range(n_steps)]
    # the head: a chunk ends when none of its lanes is alive, or hands its
    # survivors off when fewer than spill_at are
    for s in range(n_steps):
        alive = (out["aux"][0] > 0.5) & walking[chunk]
        n_alive = torch.bincount(chunk[alive], minlength=n_chunks)
        leave = walking & (n_alive > 0) & (n_alive < spill_at)
        hand = alive & leave[chunk]
        if bool(hand.any()):
            lanes = hand.nonzero().squeeze(1)
            rows[lanes] = _rows_of({k: v[:, lanes] for k, v in out.items()})
            moved |= hand
            queue[s].append(lanes)
        walking &= n_alive >= max(spill_at, 1)
        lanes = (alive & walking[chunk]).nonzero().squeeze(1)
        if lanes.numel():
            new, bits[s, lanes] = _bounce_lanes(spec, tab, out, u_all[s], lanes)
            for k in _STATE_KEYS:
                out[k][:, lanes] = new[k]
    # the tail: each step's queue, gathered from the rows and written back
    for s in range(n_steps):
        if not queue[s]:
            continue
        lanes = torch.cat(queue[s])
        new, bits[s, lanes] = bounce_fwd_plain(
            spec, tab, _state_of_rows(rows[lanes], spec.bins),
            u_all[s][:, lanes])
        rows[lanes] = _rows_of(new)
        more = lanes[new["aux"][0] > 0.5]
        if s + 1 < n_steps and more.numel():
            queue[s + 1].append(more)
    final = _state_of_rows(rows[moved], spec.bins)
    for k in _STATE_KEYS:
        out[k][:, moved] = final[k]
    return out, bits


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn_name, spec, tab, desc, st, args, cfg=True, in_place=False):
    """Shared body of the forward kernel wrappers for CUDA tensors: the
    tables, the state in and a fresh state out (``in_place``: the state in
    again), then ``args`` (pointers as ints, None for a null one), the
    configuration and the stream. Returns the new packed state."""
    _check_tables(spec, tab, desc)
    lib = _library(spec.bins)
    out = (dict(st) if in_place
           else {k: torch.empty_like(st[k]) for k in _STATE_KEYS})
    stream = torch.cuda.current_stream(tab.device).cuda_stream
    with torch.cuda.device(tab.device):
        err = getattr(lib, fn_name)(
            tab.data_ptr(), tab.numel(), desc.data_ptr(), desc.numel(),
            *[st[k].data_ptr() for k in _STATE_KEYS],
            *[out[k].data_ptr() for k in _STATE_KEYS],
            *args, *(_cfg_args(spec) if cfg else ()), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
    return out


def _check_u(u, N):
    if tuple(u.shape) != (N_UNIFORMS, N):
        raise ValueError(f"u: shape {tuple(u.shape)}")


def _check_live(live, N, dev):
    lanes, count = live
    for t, shape in ((lanes, (N,)), (count, (1,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError("live must be the (lanes i32[N], count i32[1]) "
                             "a previous fused_bounce_fwd returned")


def _schedule(live, survivors, N, dev):
    """The per-bounce kernels' schedule arguments for CUDA tensors: the list
    ``live`` (checked) and, with ``survivors``, a fresh list for the lanes
    pushed. Returns (the fresh list or None, the four pointers)."""
    if live is not None:
        _check_live(live, N, dev)
    nxt = ((torch.empty((N,), dtype=torch.int32, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))
           if survivors else None)
    return nxt, [_ptr(t) for t in (*(live or (None, None)),
                                   *(nxt or (None, None)))]


def fused_bounce_fwd(spec, tab, desc, st, u, live=None, survivors=False,
                     in_place=False):
    """One bounce for every ray: ``st`` packed state, ``u`` f32[10, N].
    Returns (new packed state, bits i32[N]). CUDA tensors launch the
    hand-written kernel or raise; CPU tensors take the plain version.

    The schedule, which no result depends on: ``live`` is the (lanes
    i32[N], count i32[1]) of the lanes alive in ``st``, as the previous
    bounce's call returned them with ``survivors=True`` (the count stays on
    the device); where they are fewer than half of the lanes the kernel runs
    them only, gathered into full warps. Without it, every lane in lane
    order. ``survivors=True`` appends
    the lanes alive after the bounce, in that layout, to the result.
    ``in_place=True`` lets the kernel write the new state over ``st``, which
    the caller then gives up: a lane dead on entry costs nothing. The plain
    version computes every lane and ignores all three but for listing the
    survivors (``live_lanes_plain``)."""
    N = st["o"].shape[1]
    _check_u(u, N)
    if not tab.is_cuda:
        new, bits = bounce_fwd_plain(spec, tab, st, u)
        return (new, bits, _live_list_plain(new["aux"])) if survivors \
            else (new, bits)
    _check_state(spec, st, {"u": u, "tab": tab})
    bits = torch.empty((N,), dtype=torch.int32, device=tab.device)
    nxt, sched = _schedule(live, survivors, N, tab.device)
    out = _launch("fused_bounce_fwd", spec, tab, desc, st,
                  [u.data_ptr(), bits.data_ptr(), *sched, N],
                  in_place=in_place)
    fused_bounce_fwd.launches += 1
    return (out, bits, nxt) if survivors else (out, bits)


def fused_span_fwd(spec, tab, desc, st, u_all=None, seed=None, start=0,
                   n_steps=None, timeline=None):
    """``n_steps`` bounces in one kernel. Host RNG: ``u_all`` f32[n_steps,
    10, N]. Kernel RNG: ``seed`` (an i32[2] tensor on the state's device) and
    ``n_steps``; the kernel draws the uniforms of bounces ``start`` ..
    ``start + n_steps - 1`` itself (Philox, csrc/philox.cuh), and no uniform
    tensor is made; the plain version draws them with ``philox_uniforms``.
    Exactly one of ``u_all`` or ``seed``. Returns (final packed state, bits
    i32[n_steps, N]). ``timeline`` (CUDA only, for profiling; may be None):
    an i64[2 + 2 n_steps] tensor that receives block 0's %globaltimer (ns) at
    the kernel's start, at the end of its head and after each step of its
    tail, then the lanes the tail ran at each step."""
    N = st["o"].shape[1]
    n_steps = _uniform_source(u_all, seed, n_steps, N)
    if not tab.is_cuda:
        if seed is not None:
            u_all = philox_uniforms(seed, N, start, n_steps, tab.device)
        return span_fwd_plain(spec, tab, st, u_all)
    _check_state(spec, st, {"tab": tab} if seed is not None
                 else {"u": u_all, "tab": tab})
    dev = tab.device
    if seed is not None:
        _check_seed(seed, dev)
    if timeline is not None and (
            timeline.dtype != torch.int64 or timeline.device != dev
            or tuple(timeline.shape) != (2 + 2 * n_steps,)):
        raise ValueError(f"timeline must be an int64[{2 + 2 * n_steps}] "
                         f"tensor on {dev}")
    lib = _library(spec.bins)
    # rays that die early leave the loop; their later bitfields are 0
    bits = torch.zeros((n_steps, N), dtype=torch.int32, device=dev)
    # the rows of the lanes that leave the head, and the int workspace: the
    # head's chunk counter, each step's queue and its length, and which
    # lanes of each chunk left the head
    rows = torch.empty((lib.fused_span_fwd_floats(N),), dtype=torch.float32,
                       device=dev)
    iw = torch.empty((lib.fused_span_fwd_words(N, n_steps),),
                     dtype=torch.int32, device=dev)
    out = _launch("fused_span_fwd", spec, tab, desc, st,
                  [_ptr(u_all), _ptr(seed), int(start), bits.data_ptr(),
                   rows.data_ptr(), iw.data_ptr(), _ptr(timeline), N,
                   n_steps])
    fused_span_fwd.launches += 1
    return out, bits


def fused_bounce_replay(spec, tab, desc, st, u, bits, live=None,
                        survivors=False, in_place=False):
    """``fused_bounce_fwd`` with its decisions replayed: the bitfield ``bits``
    i32[N] that ``fused_bounce_fwd`` returned for ``st`` and ``u`` fixes
    every choice it stores, and the kernel runs the bounce's arithmetic
    without the code that makes them (the other leaves' hit tests among it).
    A profiling kernel: its time beside ``fused_bounce_fwd``'s is the cost of
    the decision path. Returns the new packed state, equal to
    ``fused_bounce_fwd``'s. ``live``, ``survivors`` and ``in_place`` are
    ``fused_bounce_fwd``'s schedule, with its meaning: given its bits, the
    survivors listed are its survivors."""
    N = st["o"].shape[1]
    _check_u(u, N)
    if not tab.is_cuda:
        new = bounce_replay_plain(spec, tab, st, u, bits)
        return (new, _live_list_plain(new["aux"])) if survivors else new
    _check_state(spec, st, {"u": u, "tab": tab})
    _check_bits(bits, (N,), tab.device)
    nxt, sched = _schedule(live, survivors, N, tab.device)
    out = _launch("fused_bounce_replay", spec, tab, desc, st,
                  [u.data_ptr(), bits.data_ptr(), *sched, N],
                  in_place=in_place)
    fused_bounce_replay.launches += 1
    return (out, nxt) if survivors else out


def fused_bounce_io(spec, tab, desc, st, u, live=None, survivors=False,
                    in_place=False):
    """The loads and stores of ``fused_bounce_fwd`` and no bounce: the same
    launch and schedule, tables in shared memory, state and uniforms read,
    state and a bitfield written. A profiling kernel: its time is the floor
    under ``fused_bounce_fwd``'s. Returns (the state, equal to ``st``, bits
    of zeros). ``live``, ``survivors`` and ``in_place`` as in
    ``fused_bounce_fwd``; the survivors listed are the lanes alive on entry,
    which the kernel leaves alive."""
    N = st["o"].shape[1]
    _check_u(u, N)
    if not tab.is_cuda:
        new, bits = bounce_io_plain(spec, tab, st, u)
        return (new, bits, _live_list_plain(new["aux"])) if survivors \
            else (new, bits)
    _check_state(spec, st, {"u": u, "tab": tab})
    bits = torch.empty((N,), dtype=torch.int32, device=tab.device)
    nxt, sched = _schedule(live, survivors, N, tab.device)
    out = _launch("fused_bounce_io", spec, tab, desc, st,
                  [u.data_ptr(), bits.data_ptr(), *sched, N], cfg=False,
                  in_place=in_place)
    fused_bounce_io.launches += 1
    return (out, bits, nxt) if survivors else (out, bits)


fused_bounce_fwd.launches = 0
fused_span_fwd.launches = 0
fused_bounce_replay.launches = 0
fused_bounce_io.launches = 0


# --- the adjoint: plain versions and kernel wrappers -------------------------------
# A bounce maps (o, d, thr, table) to (o, d, thr, rad_delta) once its discrete
# choices are fixed by the saved bitfield. The adjoint takes the cotangents
# (go, gd, gthr, g_rad) of those outputs and returns the cotangents of the
# entry o, d, thr and of the table. A lane whose saved bitfield is 0 (dead on
# entry, or stopped by the roulette or the depth bound before its segment)
# took no part in the bounce: its cotangents pass through unchanged and it
# adds nothing to the table cotangent. That is enforced by leaving such lanes
# out, never by differentiating the bounce on a state with bits == 0, which
# no forward evaluation ever visits.


def _live_lanes(bits):
    return (bits != 0).nonzero().squeeze(1)


# --- the adjoint kernels' schedule: live lanes binned by code path ----------------
# The reverse pass of a bounce branches on the winner leaf (which fixes its
# solid's type and its material's type) and on the choices the bitfield
# stores; the adjoint kernels run lanes with one key side by side, so a warp
# takes one code path and adds to one set of table entries.
# csrc/fused_bwd_kernels.cu adjoint_key repeats the key.
ADJ_KEY_BITS = 5  # transmit, TIR, light pick, exiting, checker parity


def n_adjoint_keys(spec):
    """Keys a live lane of ``spec`` can have: 0 for a miss, and
    1 + (winner leaf << ADJ_KEY_BITS | branch bits) for a hit."""
    return 1 + (len(spec.leaves) << ADJ_KEY_BITS)


def adjoint_key_plain(bits):
    """Plain version of the adjoint kernels' code-path key of every lane of
    a bounce's bitfield ``bits`` i32[N]: i32[N], -1 where ``bits`` is 0 (a
    lane that took no part has no key)."""
    hit = ((bits >> B_HIT) & 1) != 0
    win = (bits >> WIN_SHIFT) & 0x1FF
    branch = (((bits >> B_TRANSMIT) & 7) | (((bits >> B_EXIT) & 1) << 3)
              | (((bits >> B_PARITY) & 1) << 4))
    key = torch.where(hit, 1 + (win << ADJ_KEY_BITS) + branch, 0)
    return torch.where(bits != 0, key, -1).to(torch.int32)


def bin_live_lanes_plain(bits):
    """Plain version of ``bin_live_lanes``: the live lanes of ``bits``
    stably sorted by ``adjoint_key_plain``; ``perm[count:]`` is -1."""
    key = adjoint_key_plain(bits)
    live = (key >= 0).nonzero().squeeze(1)
    order = torch.sort(key[live], stable=True).indices
    perm = torch.full_like(bits, -1, dtype=torch.int32)
    perm[:live.numel()] = live[order].to(torch.int32)
    return perm, torch.tensor([live.numel()], dtype=torch.int32,
                              device=bits.device)


def bin_live_lanes(spec, bits):
    """The live lanes of one bounce (``bits`` i32[N] != 0) stably sorted by
    their code-path key: (perm i32[N], whose first ``count[0]`` entries are
    those lanes, count i32[1]); ``perm[count:]`` is unspecified. CUDA tensors
    launch the hand-written counting sort ``adjoint_bin`` (the count stays on
    the device: no synchronisation) or raise; CPU tensors take the plain
    version."""
    N = bits.shape[0] if bits.dim() == 1 else -1
    if not bits.is_cuda:
        return bin_live_lanes_plain(bits)
    dev = bits.device
    _check_bits(bits, (N,), dev)
    lib = _library(spec.bins, "bwd")
    n_leaves = len(spec.leaves)
    perm = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return perm, torch.zeros((1,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    work = torch.empty((lib.adjoint_bin_words(N, n_leaves),),
                       dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.adjoint_bin(bits.data_ptr(), N, n_leaves, perm.data_ptr(),
                              count.data_ptr(), work.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adjoint_bin: CUDA launch failed with error {err}")
    bin_live_lanes.launches += 1
    return perm, count


def bounce_bwd_plain(spec, tab, o, d, thr, aux, u, bits, go, gd, gthr, g_rad):
    """Plain PyTorch version of ``fused_bounce_bwd``: ``torch.autograd.grad``
    of ``bounce_core`` in replay mode (``bits`` given) with respect to
    ``(o, d, thr, tab)`` under the cotangents ``(go, gd, gthr, g_rad)`` of
    ``(o, d, thr, rad_delta)``. Returns (go, gd, gthr, table cotangent
    f32[tab_size])."""
    idx = _live_lanes(bits)
    gtab = torch.zeros_like(tab)
    if idx.numel() == 0:
        return go, gd, gthr, gtab
    with torch.enable_grad():
        o_, d_, thr_ = (x[:, idx].detach().requires_grad_(True)
                        for x in (o, d, thr))
        tab_ = tab.detach().requires_grad_(True)
        state = {"o": tuple(o_), "d": tuple(d_), "thr": tuple(thr_),
                 "alive": aux[0, idx] > 0.5, "depth": aux[1, idx]}
        out = bounce_core(spec, tab_.unbind(0).__getitem__, state,
                          tuple(u[:, idx]), bits[idx])
        pairs = [(torch.stack(out[k]), g[:, idx]) for k, g in (
            ("o", go), ("d", gd), ("thr", gthr), ("rad_delta", g_rad))]
        pairs = [(y, g) for y, g in pairs if y.requires_grad]
        grads = torch.autograd.grad(
            [y for y, _ in pairs], [o_, d_, thr_, tab_],
            [g for _, g in pairs], allow_unused=True)
    res = []
    for full, part in zip((go, gd, gthr), grads[:3]):
        new = full.clone()
        new[:, idx] = 0.0 if part is None else part
        res.append(new)
    if grads[3] is not None:
        gtab = grads[3]
    return res[0], res[1], res[2], gtab


def _replay_plain(spec, tab, st, u, bits):
    """The entry state of the next bounce from this one's (o, d, thr, aux)
    and its saved bitfield: ``bounce_core`` in replay mode on the lanes that
    took part; the others keep their state and are dead from here on (one
    the depth bound stopped after it survived the roulette keeps the
    roulette's scale on its throughput, as in the forward bounce)."""
    idx = _live_lanes(bits)
    new = {k: st[k].clone() for k in ("o", "d", "thr")}
    alive, depth = st["aux"][0] > 0.5, st["aux"][1]
    stopped = (alive & (bits == 0) & (depth >= spec.extinction_min_depth)
               & ~(u[6] < spec.extinction_prob))
    new["thr"] = new["thr"] * torch.where(
        stopped, 1.0 / (1.0 - spec.extinction_prob), 1.0)
    aux = torch.stack([torch.zeros_like(depth), depth])
    if idx.numel():
        sub = {k: st[k][:, idx] for k in ("o", "d", "thr", "aux")}
        out = bounce_core(spec, tab.unbind(0).__getitem__, _state_of(sub),
                          tuple(u[:, idx]), bits[idx])
        for k in ("o", "d", "thr"):
            new[k][:, idx] = torch.stack(out[k])
        aux[0, idx] = torch.where(out["alive_next"], 1.0, 0.0)
        aux[1, idx] = out["depth"]
    new["aux"] = aux
    return new


def _replay_span(spec, tab, st0, u_all, bits):
    """Entry state of every bounce of a span under its saved bits, and the
    state the span ends in."""
    entries, st = [], st0
    with torch.no_grad():
        for u, b in zip(u_all, bits):
            entries.append(st)
            st = _replay_plain(spec, tab, st, u, b)
    return entries, st


def span_bwd_plain(spec, tab, st0, u_all, bits, go, gd, gthr, g_rad,
                   return_replay=False):
    """Plain PyTorch version of ``fused_span_bwd``: replay the span from its
    entry state ``st0`` (o, d, thr, aux) under the saved ``bits[n_steps, N]``
    keeping every bounce's entry state, then chain ``bounce_bwd_plain`` in
    reverse, summing the table cotangent."""
    entries, last = _replay_span(spec, tab, st0, u_all, bits)
    gtab = torch.zeros_like(tab)
    for k in range(len(entries) - 1, -1, -1):
        e = entries[k]
        go, gd, gthr, gt = bounce_bwd_plain(
            spec, tab, e["o"], e["d"], e["thr"], e["aux"], u_all[k], bits[k],
            go, gd, gthr, g_rad)
        gtab = gtab + gt
    if return_replay:
        return go, gd, gthr, gtab, torch.cat(
            [last["o"], last["d"], last["thr"], last["aux"]])
    return go, gd, gthr, gtab


def _launch_bwd(fn_name, spec, tab, desc, st, u, bits, cots, n_steps,
                want_replay, seed=None, start=0):
    """Shared body of the two adjoint kernel wrappers for CUDA tensors."""
    N = _check_state(spec, st, dict(cots, tab=tab) if u is None
                     else dict(cots, u=u, tab=tab))
    _check_tables(spec, tab, desc)
    if any(k for (_t, _e, _m, k) in spec.leaves):
        raise ValueError(
            "the adjoint kernels take general leaf records only: pass "
            "general_spec(spec) and the table packed for it")
    dev = tab.device
    _check_bits(bits, (N,) if n_steps is None else (n_steps, N), dev)
    if seed is not None:
        _check_seed(seed, dev)
    lib = _library(spec.bins, "bwd")
    outs = [torch.empty_like(cots[k]) for k in ("go", "gd", "gthr")]
    # every block adds its non-zero entries of the table cotangent
    gtab = torch.zeros_like(tab)
    replay, uniforms = None, [_ptr(u)]
    if n_steps is None:
        perm, count = bin_live_lanes(spec, bits)
        extra = [perm.data_ptr(), count.data_ptr(), N]
    else:
        uniforms += [_ptr(seed), int(start)]
        # the entry state of every bounce a ray enters, the staged
        # cotangents and g_rad, each lane's in one row
        scratch = torch.empty((lib.fused_span_bwd_floats(N, n_steps),),
                              dtype=torch.float32, device=dev)
        if want_replay:
            replay = torch.empty((8 + spec.bins, N), dtype=torch.float32,
                                 device=dev)
        # keys per step, their scan, live counts, bounces entered, and each
        # step's live lanes sorted by key
        iw = torch.empty(
            (lib.fused_span_bwd_words(N, n_steps, len(spec.leaves)),),
            dtype=torch.int32, device=dev)
        extra = [scratch.data_ptr(), _ptr(replay), iw.data_ptr(), N, n_steps]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            tab.data_ptr(), tab.numel(), desc.data_ptr(), desc.numel(),
            *[st[k].data_ptr() for k in ("o", "d", "thr", "aux")],
            *uniforms, bits.data_ptr(),
            *[cots[k].data_ptr() for k in ("go", "gd", "gthr", "g_rad")],
            *[t.data_ptr() for t in outs], gtab.data_ptr(), *extra,
            *_cfg_args(spec), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
    res = (outs[0], outs[1], outs[2], gtab)
    return res + (replay,) if want_replay else res


def fused_bounce_bwd(spec, tab, desc, o, d, thr, aux, u, bits, go, gd, gthr,
                     g_rad):
    """Adjoint of one replayed bounce for every ray: the entry state
    ``o d thr aux``, its uniforms ``u`` f32[10, N] and saved ``bits`` i32[N],
    and the cotangents ``go gd gthr g_rad`` of the bounce's ``o d thr
    rad_delta``. Returns (go, gd, gthr, table cotangent f32[tab_size]). CUDA
    tensors launch the hand-written kernel over the live lanes binned by
    ``bin_live_lanes`` or raise; CPU tensors take the plain version, which
    needs no binning."""
    if tuple(u.shape) != (N_UNIFORMS, o.shape[1]):
        raise ValueError(f"u: shape {tuple(u.shape)}")
    if not tab.is_cuda:
        return bounce_bwd_plain(spec, tab, o, d, thr, aux, u, bits, go, gd,
                                gthr, g_rad)
    res = _launch_bwd(
        "fused_bounce_bwd", spec, tab, desc,
        {"o": o, "d": d, "thr": thr, "aux": aux}, u, bits,
        {"go": go, "gd": gd, "gthr": gthr, "g_rad": g_rad}, None, False)
    fused_bounce_bwd.launches += 1
    return res


def fused_span_bwd(spec, tab, desc, st0, u_all, bits, go, gd, gthr, g_rad,
                   return_replay=False, seed=None, start=0):
    """Adjoint of a whole span in one kernel: ``st0`` is the span's entry
    state (o, d, thr, aux), ``bits`` i32[n_steps, N] what ``fused_span_fwd``
    wrote, and its uniforms what it read: ``u_all`` f32[n_steps, 10, N]
    (host RNG), or ``u_all=None`` with the ``seed`` and ``start`` it drew
    them from (kernel RNG: the kernel draws them again, the plain version
    with ``philox_uniforms``). Returns (go, gd, gthr, table cotangent); with
    ``return_replay`` also the state the kernel's forward replay ended in,
    f32[8 + B, N] (o, d, thr, alive, depth), for holding it against the
    forward kernel's."""
    N = st0["o"].shape[1]
    n_steps = _uniform_source(u_all, seed, int(bits.shape[0]), N)
    st0 = {k: st0[k] for k in ("o", "d", "thr", "aux")}
    if not tab.is_cuda:
        if seed is not None:
            u_all = philox_uniforms(seed, N, start, n_steps, tab.device)
        return span_bwd_plain(spec, tab, st0, u_all, bits, go, gd, gthr, g_rad,
                              return_replay)
    res = _launch_bwd(
        "fused_span_bwd", spec, tab, desc, st0, u_all, bits,
        {"go": go, "gd": gd, "gthr": gthr, "g_rad": g_rad},
        n_steps, return_replay, seed, start)
    fused_span_bwd.launches += 1
    return res


fused_bounce_bwd.launches = 0
fused_span_bwd.launches = 0
bin_live_lanes.launches = 0


# --- what wavefront.trace_rays and trace_rays_diff call ----------------------------


def _columns(x):
    """x[N, C] -> a new contiguous f32[C, N], never a view of x."""
    return x.t().to(torch.float32, memory_format=torch.contiguous_format,
                    copy=True)


def pack_state(state):
    """RayState -> packed SoA dict (f32; a bf16 spectral state widens here
    and rounds back only in ``unpack_state``, never inside a span). Every
    tensor is new, so a kernel may update it in place."""
    aux = torch.stack([torch.where(state.alive, 1.0, 0.0),
                       state.depth.to(torch.float32)])
    return {"o": _columns(state.origin), "d": _columns(state.direction),
            "thr": _columns(state.throughput), "rad": _columns(state.radiance),
            "aux": aux}


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


def _check_span(span):
    if span not in ("multi", "perbounce"):
        raise ValueError(f"span must be 'multi' or 'perbounce', got {span!r}")


def _check_seeded(span, u_all):
    """The kernel RNG: whole-span kernels only, and no uniforms beside it."""
    if u_all is not None:
        raise ValueError("pass exactly one of u_all (host RNG) or seed "
                         "(kernel RNG)")
    if span != "multi":
        raise ValueError(
            "the kernel RNG is drawn inside the whole-span kernels only: "
            f"span must be 'multi', got {span!r}")


def fused_forward_span(tab, desc, spec, state, u_all=None, span="multi",
                       early_exit=True, seed=None, start=0, n_steps=None):
    """Forward fused trace of one span. Host RNG: ``u_all`` is
    [n_steps, N, >=10]; ``span="multi"`` runs the whole span in one
    ``fused_span_fwd``, ``"perbounce"`` one ``fused_bounce_fwd`` per bounce,
    stopping once every ray is dead when ``early_exit``. Kernel RNG: ``seed``
    (i32[2] on the state's device), the span's first absolute bounce
    ``start`` and ``n_steps``, on the whole-span kernel only (another
    ``span`` raises ``ValueError``). Returns RayState."""
    _check_span(span)
    st = pack_state(state)
    if seed is not None:
        _check_seeded(span, u_all)
        out, bits = fused_span_fwd(spec, tab, desc, st, seed=seed, start=start,
                                   n_steps=n_steps)
        return unpack_state(out, state, torch.sum(bits & 1, dtype=torch.int32))
    u_p = pack_u(u_all.to(torch.float32))
    if span == "multi":
        out, bits = fused_span_fwd(spec, tab, desc, st, u_p)
        seg = torch.sum(bits & 1, dtype=torch.int32)
        return unpack_state(out, state, seg)
    # each bounce runs the lanes the previous one left alive, over the
    # state that pack_state made for this span, in place
    seg = torch.zeros((), dtype=torch.int32, device=tab.device)
    live = None
    for u in u_p:
        if early_exit and not bool((st["aux"][0] > 0.5).any()):
            break
        st, bits, live = fused_bounce_fwd(spec, tab, desc, st, u, live=live,
                                          survivors=True, in_place=True)
        seg = seg + torch.sum(bits & 1, dtype=torch.int32)
    return unpack_state(st, state, seg)


class _SpanPerBounce(torch.autograd.Function):
    """A span as one kernel per bounce each way: the forward runs
    ``fused_bounce_fwd`` over all ``n_steps`` keeping every bounce's entry
    state and bitfield, the backward ``fused_bounce_bwd`` in reverse, summing
    the table cotangent."""

    @staticmethod
    def forward(ctx, tab, o, d, thr, rad, aux, u_p, spec, desc):
        st = {"o": o, "d": d, "thr": thr, "rad": rad, "aux": aux}
        entries = []
        seg = torch.zeros((), dtype=torch.int32, device=tab.device)
        # out of place (the backward reads every entry state) and in lane
        # order: a gathered bounce out of place timed slower than lane order
        for u in u_p:
            new, bits = fused_bounce_fwd(spec, tab, desc, st, u)
            entries.append((st["o"], st["d"], st["thr"], st["aux"], bits))
            seg = seg + torch.sum(bits & 1, dtype=torch.int32)
            st = new
        ctx.spec, ctx.desc, ctx.entries = spec, desc, entries
        ctx.save_for_backward(tab, u_p)
        ctx.mark_non_differentiable(st["aux"], seg)
        return st["o"], st["d"], st["thr"], st["rad"], st["aux"], seg

    @staticmethod
    def backward(ctx, go, gd, gthr, g_rad, _g_aux, _g_seg):
        tab, u_p = ctx.saved_tensors
        go, gd, gthr, g_rad = (g.contiguous() for g in (go, gd, gthr, g_rad))
        gtab = torch.zeros_like(tab)
        for k in range(len(ctx.entries) - 1, -1, -1):
            o, d, thr, aux, bits = ctx.entries[k]
            go, gd, gthr, gt = fused_bounce_bwd(
                ctx.spec, tab, ctx.desc, o, d, thr, aux, u_p[k], bits,
                go, gd, gthr, g_rad)
            gtab = gtab + gt
        return gtab, go, gd, gthr, g_rad, None, None, None, None


class _SpanMulti(torch.autograd.Function):
    """A span as one kernel each way: ``fused_span_fwd`` keeps the entry
    state, the bitfields and what the uniforms came from -- the uniforms
    ``u_p`` (host RNG) or the i32[2] ``seed`` with the span's ``start``
    (kernel RNG: no uniform tensor is made or kept); ``fused_span_bwd``
    replays and reverses the span."""

    @staticmethod
    def forward(ctx, tab, o, d, thr, rad, aux, u_p, seed, start, n_steps,
                spec, desc):
        st = {"o": o, "d": d, "thr": thr, "rad": rad, "aux": aux}
        out, bits = fused_span_fwd(spec, tab, desc, st, u_p, seed=seed,
                                   start=start, n_steps=n_steps)
        seg = torch.sum(bits & 1, dtype=torch.int32)
        ctx.spec, ctx.desc, ctx.start = spec, desc, start
        ctx.save_for_backward(tab, o, d, thr, aux, u_p, seed, bits)
        ctx.mark_non_differentiable(out["aux"], seg)
        return out["o"], out["d"], out["thr"], out["rad"], out["aux"], seg

    @staticmethod
    def backward(ctx, go, gd, gthr, g_rad, _g_aux, _g_seg):
        tab, o, d, thr, aux, u_p, seed, bits = ctx.saved_tensors
        g_rad = g_rad.contiguous()
        go, gd, gthr, gtab = fused_span_bwd(
            ctx.spec, tab, ctx.desc, {"o": o, "d": d, "thr": thr, "aux": aux},
            u_p, bits, go.contiguous(), gd.contiguous(), gthr.contiguous(),
            g_rad, seed=seed, start=ctx.start)
        return (gtab, go, gd, gthr, g_rad) + (None,) * 7


def fused_span(tab, desc, spec, state, u_all=None, span="multi", seed=None,
               start=0, n_steps=None):
    """Differentiable fused trace of one span: ``tab`` the table of
    ``pack_tabvec`` with its autograd history, ``spec`` a ``general_spec``.
    Every bounce of the span runs (no early exit). Host RNG: ``u_all`` is
    [n_steps, N, >=10], and ``span`` picks the route: ``"multi"`` (one kernel
    per span each way) or ``"perbounce"`` (one per bounce each way). Kernel
    RNG: ``seed`` (i32[2] on the state's device), ``start`` and ``n_steps``,
    on the whole-span route only (another ``span`` raises ``ValueError``).
    The entry radiance's cotangent is the exit radiance's; ``aux`` and the
    uniforms get none; ``segments`` is not differentiable. Returns RayState."""
    _check_span(span)
    st = pack_state(state)
    if seed is not None:
        _check_seeded(span, u_all)
        o, d, thr, rad, aux, seg = _SpanMulti.apply(
            tab, st["o"], st["d"], st["thr"], st["rad"], st["aux"], None,
            seed, int(start), int(n_steps), spec, desc)
    else:
        u_p = pack_u(u_all.to(torch.float32))
        if span == "multi":
            o, d, thr, rad, aux, seg = _SpanMulti.apply(
                tab, st["o"], st["d"], st["thr"], st["rad"], st["aux"], u_p,
                None, 0, None, spec, desc)
        else:
            o, d, thr, rad, aux, seg = _SpanPerBounce.apply(
                tab, st["o"], st["d"], st["thr"], st["rad"], st["aux"], u_p,
                spec, desc)
    return unpack_state({"o": o, "d": d, "thr": thr, "rad": rad, "aux": aux},
                        state, seg)
