"""Woop watertight ray/triangle intersection (component form).

Counterpart of source_tpu/tracer/watertight.py (Woop, Benthin & Wald 2013,
"Watertight Ray/Triangle Intersection"; the reference's
raysect/primitive/mesh/mesh.pyx:566-713): the ray's dominant axis permutes
the frame, a shear and scale map the ray onto +Z, and the triangle test
becomes three 2-D edge functions whose signs agree across a shared edge.
An edge function within its forward error bound of zero is accepted, so a
ray aimed at a vertex or an edge hits at least one adjacent triangle and
never leaks; the nearest t resolves the double hit.

Everything is elementwise on per-lane component tensors. The CUDA kernel
(csrc/mesh_bvh.cu) repeats each operation in the same order and
association, built without contracted multiply-adds, so the plain version
and the kernel take the same hit decisions bit for bit. Every division is
tensor by tensor (``torch.reciprocal``): PyTorch divides a CUDA tensor by a
Python scalar as a multiply by its reciprocal, which would move lanes
across an edge.
"""

from __future__ import annotations

import torch

__all__ = ["woop_setup", "woop_tri_test"]

# forward error bound factor of the edge functions (4 ulp of f32)
_E = 4.0 * 1.1920929e-07


def woop_setup(ox, oy, oz, dx, dy, dz):
    """Per-ray constants: dominant-axis masks, winding swap, shear scales.
    Computed once per ray and reused for every triangle."""
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    mz = (adz >= adx) & (adz >= ady)
    mx = (~mz) & (adx >= ady)
    # component along kz / kx=(kz+1)%3 / ky=(kz+2)%3
    dk = torch.where(mz, dz, torch.where(mx, dx, dy))
    di = torch.where(mz, dx, torch.where(mx, dy, dz))
    dj = torch.where(mz, dy, torch.where(mx, dz, dx))
    swap = dk < 0.0  # swap kx<->ky to preserve winding
    di, dj = torch.where(swap, dj, di), torch.where(swap, di, dj)
    ok = torch.abs(dk) > 1e-30
    inv = torch.where(ok, torch.reciprocal(torch.where(ok, dk, 1.0)), 0.0)
    return {
        "ox": ox, "oy": oy, "oz": oz,
        "mz": mz, "mx": mx, "swap": swap,
        "sx": di * inv, "sy": dj * inv, "sz": inv, "dk_ok": ok,
    }


def _comps(setup, vx, vy, vz):
    """Permuted (kx, ky, kz) components of a translated vertex."""
    mz, mx, swap = setup["mz"], setup["mx"], setup["swap"]
    vk = torch.where(mz, vz, torch.where(mx, vx, vy))
    vi = torch.where(mz, vx, torch.where(mx, vy, vz))
    vj = torch.where(mz, vy, torch.where(mx, vz, vx))
    vi, vj = torch.where(swap, vj, vi), torch.where(swap, vi, vj)
    return vi, vj, vk


def woop_tri_test(setup, ax, ay, az, bx, by, bz, cx, cy, cz, t_min):
    """(t, u, v, front, valid) for one triangle per lane against the
    setup's rays. u/v are the Moller-Trumbore barycentrics
    (point = A + u(B-A) + v(C-A)); front is det > 0."""
    ox, oy, oz = setup["ox"], setup["oy"], setup["oz"]
    sx, sy, sz = setup["sx"], setup["sy"], setup["sz"]
    Ai, Aj, Ak = _comps(setup, ax - ox, ay - oy, az - oz)
    Bi, Bj, Bk = _comps(setup, bx - ox, by - oy, bz - oz)
    Ci, Cj, Ck = _comps(setup, cx - ox, cy - oy, cz - oz)
    Ax = Ai - sx * Ak
    Ay = Aj - sy * Ak
    Bx = Bi - sx * Bk
    By = Bj - sy * Bk
    Cx = Ci - sx * Ck
    Cy = Cj - sy * Ck
    U = Cx * By - Cy * Bx
    V = Ax * Cy - Ay * Cx
    W = Bx * Ay - By * Ax
    # the edge functions' forward error bounds: the product rounding and the
    # cancellation in the sheared coordinates (vi - s*vk from translated
    # magnitudes); a vertex-aimed ray's two near-zero edge functions carry
    # independent rounding and may straddle zero on every adjacent triangle
    errAx = torch.abs(Ai) + torch.abs(sx * Ak)
    errAy = torch.abs(Aj) + torch.abs(sy * Ak)
    errBx = torch.abs(Bi) + torch.abs(sx * Bk)
    errBy = torch.abs(Bj) + torch.abs(sy * Bk)
    errCx = torch.abs(Ci) + torch.abs(sx * Ck)
    errCy = torch.abs(Cj) + torch.abs(sy * Ck)
    eU = _E * (errCx * torch.abs(By) + torch.abs(Cx) * errBy
               + errCy * torch.abs(Bx) + torch.abs(Cy) * errBx)
    eV = _E * (errAx * torch.abs(Cy) + torch.abs(Ax) * errCy
               + errAy * torch.abs(Cx) + torch.abs(Ay) * errCx)
    eW = _E * (errBx * torch.abs(Ay) + torch.abs(Bx) * errAy
               + errBy * torch.abs(Ax) + torch.abs(By) * errAx)
    same = (((U >= -eU) & (V >= -eV) & (W >= -eW))
            | ((U <= eU) & (V <= eV) & (W <= eW)))
    det = U + V + W
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, torch.reciprocal(torch.where(det_ok, det, 1.0)),
                          0.0)
    t = sz * (U * Ak + V * Bk + W * Ck) * inv_det
    u = V * inv_det
    v = W * inv_det
    valid = same & det_ok & setup["dk_ok"] & (t > t_min)
    return t, u, v, det > 0.0, valid
