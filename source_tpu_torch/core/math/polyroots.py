"""Polynomial root solvers in component form (quadratic/cubic/quartic).

Counterpart of raysect/core/math/cython/utility.pyx
``solve_quadratic/solve_cubic/solve_quartic`` (utility.pxd:96-109):
branchless functions on per-ray tensors that return (root, valid) pairs;
the component form is what the fused tracer's torus leaf needs.

Every masked lane is sanitized with the double-where pattern *before* any
sqrt/div/pow, so a masked lane never produces a NaN or an infinity that a
later select could let through.
"""

from __future__ import annotations

import math

import torch

__all__ = ["solve_quadratic", "solve_cubic", "solve_quartic",
           "solve_quartic_components"]

_PI_F32 = 3.14159265358979
_INF = float("inf")


def _safe_sqrt(x, ok=None):
    ok = (x > 0.0) if ok is None else ok
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _safe_div(a, b, eps=1e-30):
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _cbrt(x, eps=1e-24):
    ax = torch.abs(x)
    ok = ax > eps
    r = torch.where(ok, torch.where(ok, ax, 1.0) ** (1.0 / 3.0), 0.0)
    return torch.sign(x) * r


def _quad_components(a, b, c, eps=1e-30):
    """Real roots of a x^2 + b x + c as ((lo, v_lo), (hi, v_hi)), by the
    numerically-stable citardauq formulation."""
    d = b * b - 4.0 * a * c
    has_roots = d >= 0.0
    sq = _safe_sqrt(torch.where(has_roots, d, 0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    q = torch.where(b == 0.0, -0.5 * sq, q)
    lin = torch.abs(a) < eps
    r0 = torch.where(lin, _safe_div(-c, b, eps), _safe_div(q, a, eps))
    r1 = _safe_div(c, q, eps)
    v1 = has_roots & ~lin & (torch.abs(q) >= eps)
    v0 = (lin & (torch.abs(b) >= eps)) | (~lin & has_roots)
    r1_eff = torch.where(v1, r1, r0)
    lo = torch.minimum(r0, r1_eff)
    hi = torch.maximum(r0, r1_eff)
    return (lo, v0), (hi, v1)


def solve_quadratic(a, b, c, eps=1e-30):
    """Real roots of a x^2 + b x + c = 0 as (roots[..., 2], valid[..., 2]),
    ascending where valid, +inf where not (citardauq formulation)."""
    (lo, v0), (hi, v1) = _quad_components(a, b, c, eps)
    roots = torch.stack([torch.where(v0, lo, _INF), torch.where(v1, hi, _INF)],
                        dim=-1)
    return roots, torch.stack([v0, v1], dim=-1)


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 (a != 0 assumed) as
    (roots[..., 3], valid[..., 3]), sorted, +inf where not valid: the
    trigonometric (Viete) method for three real roots, Cardano for one,
    both branchless."""
    inv_a = 1.0 / a
    p = b * inv_a
    q = c * inv_a
    r = d * inv_a
    # depressed cubic t^3 + A t + B, x = t - p/3
    A = q - p * p / 3.0
    B = (2.0 * p * p * p - 9.0 * p * q + 27.0 * r) / 27.0
    disc = (B * B) / 4.0 + (A * A * A) / 27.0
    shift = -p / 3.0
    one = disc > 0.0

    # one real root (disc > 0): Cardano
    sq = _safe_sqrt(torch.where(one, disc, 0.0))
    single = _cbrt(-B / 2.0 + sq) + _cbrt(-B / 2.0 - sq) + shift

    # three real roots (disc <= 0): trigonometric; requires A < 0
    Am = torch.clamp(A, max=-1e-24)
    m = 2.0 * _safe_sqrt(-Am / 3.0)
    arg = torch.clamp(_safe_div(3.0 * B, Am * m), -0.999999, 0.999999)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3.0, dtype=theta.dtype, device=theta.device)
    trip = (m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)
            + shift[..., None])

    inf = torch.full_like(single, _INF)
    roots = torch.where(one[..., None], torch.stack([single, inf, inf], dim=-1),
                        trip)
    valid = torch.ones(roots.shape, dtype=torch.bool, device=roots.device)
    valid[..., 1:] = ~one[..., None]
    roots = torch.sort(torch.where(valid, roots, _INF), dim=-1).values
    return roots, torch.isfinite(roots)


def _acos_poly(x):
    """Polynomial arccos (Abramowitz & Stegun 4.4.45, |err| < 6.7e-5).

    The resolvent-cubic root only needs ~1e-4 accuracy — the quartic's
    Newton polish restores full f32 precision downstream. The polynomial
    (not a library arccos) is the function: the hand-written kernels and
    the reference evaluate the same expression, so their roots agree."""
    ax = torch.abs(x)
    p = 1.5707288 + ax * (-0.2121144 + ax * (0.0742610 - 0.0187293 * ax))
    a = _safe_sqrt(1.0 - ax, ok=(1.0 - ax) > 0.0) * p
    return torch.where(x >= 0.0, a, _PI_F32 - a)


def _cubic_largest(b, c, d):
    """Largest real root of the monic cubic x^3 + b x^2 + c x + d (the
    Cardano single root for disc > 0; the k=0 Viete root — the largest of
    the three — otherwise). The Viete branch uses the polynomial arccos
    above; callers polish downstream."""
    A = c - b * b / 3.0
    B = (2.0 * b * b * b - 9.0 * b * c + 27.0 * d) / 27.0
    disc = (B * B) / 4.0 + (A * A * A) / 27.0
    shift = -b / 3.0
    one = disc > 0.0
    sq = _safe_sqrt(torch.where(one, disc, 0.0))
    single = _cbrt(-B / 2.0 + sq) + _cbrt(-B / 2.0 - sq) + shift
    Am = torch.clamp(A, max=-1e-24)
    m = 2.0 * _safe_sqrt(-Am / 3.0)
    arg = torch.clamp(_safe_div(3.0 * B, Am * m), -0.999999, 0.999999)
    theta = _acos_poly(arg) / 3.0
    return torch.where(one, single, m * torch.cos(theta) + shift)


def solve_quartic_components(a, b, c, d, e, newton_iters=2):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 by Ferrari's
    resolvent cubic: four Newton-polished (root, valid) pairs, unsorted
    (primitive/torus.pyx quartic semantics)."""
    # degenerate-lane guard: dead/masked rays reach here with a == 0
    # (|d|^4 for the torus quartic); sanitize a and mark every root invalid
    a_ok = torch.abs(a) > 1e-30
    a = torch.where(a_ok, a, 1.0)
    inv_a = 1.0 / a
    b_, c_, d_, e_ = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    # depressed quartic y^4 + p y^2 + q y + r, x = y - b/4
    p = c_ - 3.0 * b_ * b_ / 8.0
    q = d_ - b_ * c_ / 2.0 + b_ * b_ * b_ / 8.0
    r = (
        e_
        - b_ * d_ / 4.0
        + b_ * b_ * c_ / 16.0
        - 3.0 * b_ * b_ * b_ * b_ / 256.0
    )
    shift = -b_ / 4.0

    # resolvent cubic: z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0; largest real z
    z = _cubic_largest(-p, -4.0 * r, 4.0 * p * r - q * q)

    # factor into two quadratics y^2 -/+ s y + (z/2 -/+ q/(2s))
    s = _safe_sqrt(z - p)
    deg = s <= 1e-12
    t0 = z / 2.0 - _safe_div(q, 2.0 * s)
    t1 = z / 2.0 + _safe_div(q, 2.0 * s)
    # s == 0 degenerate: y^2 = (-p +/- sqrt(p^2-4r))/2
    dd = _safe_sqrt(p * p - 4.0 * r)
    t0 = torch.where(deg, (z + dd) / 2.0, t0)
    t1 = torch.where(deg, (z - dd) / 2.0, t1)

    ones = torch.ones_like(s)
    (lo0, v00), (hi0, v01) = _quad_components(ones, -s, t0)
    (lo1, v10), (hi1, v11) = _quad_components(ones, s, t1)

    def poly(x):
        return (((a * x + b) * x + c) * x + d) * x + e

    def dpoly(x):
        return ((4.0 * a * x + 3.0 * b) * x + 2.0 * c) * x + d

    def finish(x, v):
        v = v & a_ok
        # sanitize before polishing: masked lanes polish a dummy zero root
        x = torch.where(v, x + shift, 0.0)
        for _ in range(newton_iters):
            x = torch.where(v, x - _safe_div(poly(x), dpoly(x)), x)
        return x, v

    return (finish(lo0, v00), finish(hi0, v01),
            finish(lo1, v10), finish(hi1, v11))


def solve_quartic(a, b, c, d, e, newton_iters=2):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 as
    (roots[..., 4], valid[..., 4]), ascending with invalid lanes +inf: the
    stacked view of ``solve_quartic_components`` (one float route)."""
    pairs = solve_quartic_components(a, b, c, d, e, newton_iters)
    roots = torch.stack([torch.where(v, x, _INF) for x, v in pairs], dim=-1)
    roots = torch.sort(roots, dim=-1).values
    return roots, torch.isfinite(roots)
