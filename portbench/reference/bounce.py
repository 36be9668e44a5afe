"""The plain reference's bounce: one path-tracing bounce of Raysect's
algorithm as plain PyTorch operations on per-ray tensors.

A frozen copy of the port's plain version of its fused bounce
(``bounce_core``, which the repository's CPU tests hold to the JAX package),
cut to the solids the configurations hold (spheres and boxes), with the
table layout it reads (``pack_tabvec``). It imports nothing of the program:
it runs on the tables of ``tables.compile_config`` and the uniforms the
benchmark hands both sides. Raysect's sources are named beside each step.
"""

from __future__ import annotations

import torch

from .tables import (  # noqa: F401
    MAT_DIELECTRIC, MAT_EMITTER, MAT_LAMBERT, MAT_ROUGH_CONDUCTOR,
    TABLE_FIELDS, TYPE_BOX, TYPE_SPHERE, VOL_BEER,
)

# material and volume codes the bounce dispatches on; the configurations use
# the four of ``tables`` and the rest never occur
MAT_ABSORBER, MAT_NULL, MAT_CONDUCTOR = 0, 3, 4
MAT_EMITTER_ANISO, MAT_CHECKERBOARD, MAT_LIGHT, MAT_PERFECT_REFLECT = 7, 8, 9, 10
VOL_HOMOGENEOUS = 2

_BIG = 3e38
_PI = 3.14159265358979323846
_T_EPS = 1e-4  # relative minimum advance of a continued ray
N_UNIFORMS = 10  # uniform draws one bounce consumes per ray

# choice bitfield layout (i32 per ray per bounce)
B_ALIVE = 0
B_HIT = 1
B_TRANSMIT = 2
B_TIR = 3
B_PICKLIGHT = 4
B_CONT = 5
B_CNTD = 6
B_ALIVENEXT = 7
B_EXIT = 8
B_PARITY = 14
LIGHT_SHIFT = 9
WIN_SHIFT = 16


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
    """Differentiable flat f32[T] view of the tables the bounce reads
    (``scene`` a dict of ``tables.TABLE_FIELDS``), as tensor ops on their
    device: autograd carries a table cotangent back to each field.

    Fast-record leaves bake WORLD-space fields (sphere centre+radius, box
    AABB) computed from inv(w2l), the 8-corner product as explicit mul-add
    (never a reduced-precision matrix product)."""
    L = len(spec.leaves)
    f32 = torch.float32
    w2l = scene['leaf_w2l'].to(f32)
    params = scene['leaf_params'].to(f32)
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
    mat_spectra = scene['mat_spectra'].to(f32)
    parts.append(torch.cat(
        [scene['mat_params'].to(f32)[:, :8], scene['mat_scalars'].to(f32)[:, :2],
         mat_spectra[:, 0, :], mat_spectra[:, 1, :]], dim=1).reshape(-1))
    parts.append(torch.cat(
        [scene['imp_centre'].to(f32), scene['imp_radius'].to(f32)[:, None],
         scene['imp_weight'].to(f32)[:, None], scene['imp_cdf'].to(f32)[:, None]],
        dim=1).reshape(-1))
    entity_w2l = scene['entity_w2l'].to(f32)
    for e in spec.check_entities:
        parts.append(entity_w2l[e, :3, :].reshape(12))
    return torch.cat(parts)



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


def _contains(tid, p, pp):
    if tid == TYPE_SPHERE:
        return _dot3(p, p) <= pp[0] * pp[0]
    if tid == TYPE_BOX:
        return ((p[0] >= pp[0]) & (p[0] <= pp[3]) & (p[1] >= pp[1])
                & (p[1] <= pp[4]) & (p[2] >= pp[2]) & (p[2] <= pp[5]))
    raise ValueError(f"unsupported type {tid}")


_HIT = {TYPE_SPHERE: _hit_sphere, TYPE_BOX: _hit_box}
_NORMAL = {TYPE_SPHERE: _n_sphere, TYPE_BOX: _n_box}


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


def bounce_core(spec, tget, state, u, bits):
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


def _state_of(st):
    return {
        "o": tuple(st["o"]), "d": tuple(st["d"]), "thr": tuple(st["thr"]),
        "alive": st["aux"][0] > 0.5, "depth": st["aux"][1],
    }


def bounce(spec, tab, st, u, bits=None):
    """``bounce_core`` on a packed state (o, d [3, N]; thr, rad [B, N];
    aux [2, N]: alive, depth) with the uniforms u [10, N]: (new packed
    state, bitfield [N]; 0 where the roulette stopped the ray)."""
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
    b = out["bits"]
    return new, torch.where((b & 1) > 0, b, 0)
