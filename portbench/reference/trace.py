"""The plain reference's traces: a ray batch to termination, the training
loss with its gradients, a pinhole camera's rays and the RGB frame.

Everything is plain PyTorch on the tables of ``tables.compile_config`` and
the uniforms the benchmark hands both sides; nothing of the program is
imported. The span structure follows the traced path: spans of bounces
with the batch compacted between them, alive lanes first in a random
rotation, the survivors reweighted by alive/kept (unbiased under
overflow).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bounce as rb
from .tables import TABLE_FIELDS, general


def pack(o, d, thr, rad):
    """Packed state of fresh rays: o, d [3, N]; thr, rad [B, N]; aux."""
    n = o.shape[0]
    aux = torch.stack([torch.ones(n, device=o.device),
                       torch.zeros(n, device=o.device)])
    return {"o": o.t().contiguous(), "d": d.t().contiguous(),
            "thr": thr.t().contiguous(), "rad": rad.t().contiguous(),
            "aux": aux}


def span(spec, tab, st, u, n_steps):
    """``n_steps`` bounces of the packed state with uniforms u [n_steps, N,
    10]; returns (state, segments): segments are the lanes alive after each
    bounce's roulette, summed."""
    seg = torch.zeros((), dtype=torch.int64, device=tab.device)
    for k in range(n_steps):
        st, bits = rb.bounce(spec, tab, st, u[k].t())
        seg = seg + torch.sum(bits & 1)
    return st, seg


def _compact(st, divisor, lane_ids, rad_full, shift):
    """Keep N/divisor lanes: alive ranks rotated by ``shift``, first."""
    alive = st["aux"][0] > 0.5
    n = alive.shape[0]
    m = max(1, n // divisor)
    cnt = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32)
    a = cnt[-1]
    modulus = torch.clamp(a, min=1)
    rank = (cnt - 1 + shift) % modulus
    sel = alive & (rank < m)
    n_sel = torch.sum(sel, dtype=torch.int32)
    dest = torch.where(sel, rank, n_sel + torch.cumsum(
        (~sel).to(torch.int32), 0, dtype=torch.int32) - 1)
    perm = torch.zeros((n,), dtype=torch.int64, device=alive.device)
    perm[dest.to(torch.int64)] = torch.arange(n, device=alive.device)
    keep = perm[:m]
    scale = torch.clamp(a.to(torch.float32) / m, min=1.0)
    rad_full = rad_full.index_put((lane_ids,), st["rad"].t())
    kept = {k: v[:, keep] for k, v in st.items()}
    alive_kept = kept["aux"][0] > 0.5
    kept["thr"] = kept["thr"] * torch.where(
        alive_kept, scale, torch.ones((), device=scale.device))[None, :]
    return kept, lane_ids[keep], rad_full


def trace(spec, tab, o, d, weight, u_of, max_iters, schedule=(),
          shift_of=None):
    """Final radiance [N, B] and traced segments of rays from o, d [N, 3]
    with throughput ``weight`` [N] (or None for 1). ``u_of(start, n_steps,
    n_lanes)`` gives a span's uniforms; ``shift_of(done, alive_count)`` the
    rotation of the compaction after ``done`` bounces."""
    n = o.shape[0]
    ones = torch.ones((n, spec.bins), device=o.device)
    thr = ones if weight is None else ones * weight[:, None]
    st = pack(o, d, thr, torch.zeros_like(ones))
    if not schedule:
        st, seg = span(spec, tab, st, u_of(0, max_iters, n), max_iters)
        return st["rad"].t(), seg
    done = 0
    seg = torch.zeros((), dtype=torch.int64, device=o.device)
    lane_ids = torch.arange(n, device=o.device)
    rad_full = torch.zeros((n, spec.bins), device=o.device)
    for steps, divisor in schedule:
        steps = min(steps, max_iters - done)
        if steps <= 0:
            break
        m = st["o"].shape[1]
        st, s = span(spec, tab, st, u_of(done, steps, m), steps)
        seg = seg + s
        done += steps
        alive = int((st["aux"][0] > 0.5).sum())
        st, lane_ids, rad_full = _compact(st, divisor, lane_ids, rad_full,
                                          shift_of(done, alive))
    if done < max_iters:
        m = st["o"].shape[1]
        st, s = span(spec, tab, st, u_of(done, max_iters - done, m),
                     max_iters - done)
        seg = seg + s
    rad_full = rad_full.index_put((lane_ids,), st["rad"].t())
    return rad_full, seg


def loss_and_grads(tables, spec, o, d, target, u, block=65536):
    """The training step's reference: ``mean((radiance - target)**2)`` over
    the rays, traced on the local-frame records for every bounce of u
    [n_steps, N, 10], and its gradient with respect to every table of
    ``TABLE_FIELDS``, summed over blocks of ``block`` rays so that the
    autograd graph fits."""
    gspec = general(spec)
    leaves = {f: tables[f].detach().clone().requires_grad_(True)
              for f in TABLE_FIELDS}
    grads = {f: torch.zeros_like(tables[f]) for f in TABLE_FIELDS}
    n = o.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=o.device)
    for a in range(0, n, block):
        b = min(n, a + block)
        tab = rb.pack_tabvec(leaves, gspec)
        ones = torch.ones((b - a, spec.bins), device=o.device)
        st = pack(o[a:b], d[a:b], ones, torch.zeros_like(ones))
        for k in range(u.shape[0]):
            st, _ = rb.bounce(gspec, tab, st, u[k, a:b].t())
        part = torch.sum((st["rad"].t() - target[a:b]) ** 2) / (
            n * spec.bins)
        found = torch.autograd.grad(part, list(leaves.values()),
                                    allow_unused=True)
        for f, g in zip(TABLE_FIELDS, found):
            if g is not None:
                grads[f] += g
        total += part.detach().double()
        del st, part, found, tab
    return float(total), grads


# --- the camera and the RGB frame ---------------------------------------------

def pinhole_rays(px, py, u, nx, ny, fov, cam_to_world):
    """World-space rays, unit directions and weights of a pinhole camera's
    jittered samples: pixels px, py [T], uniforms u [T, S, 2], the camera's
    local-to-world matrix f32 [4, 4] (Raysect pinhole.pyx:148-200)."""
    width = 2.0 * math.tan(math.pi / 180.0 * 0.5 * fov)
    delta = width / max(nx, ny)
    sx, sy = 0.5 * nx * delta, 0.5 * ny * delta
    x = sx - delta * (px[:, None].to(torch.float32) + 0.5) + (
        u[..., 0] - 0.5) * delta
    y = sy - delta * (py[:, None].to(torch.float32) + 0.5) + (
        u[..., 1] - 0.5) * delta
    dl = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    dl = _normalise(dl)
    w = dl[..., 2].reshape(-1)
    ol = torch.zeros_like(dl).reshape(-1, 3)
    dl = dl.reshape(-1, 3)
    m3 = cam_to_world[:3, :3]
    o = _apply(m3, ol) + cam_to_world[:3, 3]
    d = _normalise(_apply(m3, dl))
    return o, d, w


def _apply(m3, v):
    return (m3[:, 0] * v[..., 0:1] + m3[:, 1] * v[..., 1:2]
            + m3[:, 2] * v[..., 2:3])


def _normalise(v):
    n2 = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
          + v[..., 2] * v[..., 2])[..., None]
    ok = n2 > 1e-24
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    return v * inv


CIE_NORM = 106.8566


def _gauss(w, mu, s1, s2):
    s = torch.where(w < mu, s1, s2)
    t = (w - mu) / s
    return torch.exp(-0.5 * t * t)


def ciexyz_bins(lo, hi, bins):
    """CIE 1931 colour matching functions at the bin centres, f32 [B, 3]:
    the analytic multi-lobe fit of Wyman, Sloan and Shirley (2013), over
    the y-bar integral in nm."""
    delta = (hi - lo) / bins
    w = torch.from_numpy(lo + (np.arange(bins, dtype=np.float32) + 0.5)
                         * delta)
    x = (1.056 * _gauss(w, 599.8, 37.9, 31.0)
         + 0.362 * _gauss(w, 442.0, 16.0, 26.7)
         - 0.065 * _gauss(w, 501.1, 20.4, 26.2))
    y = 0.821 * _gauss(w, 568.8, 46.9, 40.5) + 0.286 * _gauss(
        w, 530.9, 16.3, 31.1)
    z = 1.217 * _gauss(w, 437.0, 11.8, 36.0) + 0.681 * _gauss(
        w, 459.0, 26.0, 13.8)
    return torch.stack([x, y, z], dim=-1) / CIE_NORM


def xyz_sums(spectra, cie, delta, sensitivity):
    """Per-pixel sums and sums of squares over the samples of the XYZ
    projection of spectra [T, S, B]: two f32 [T, 3]."""
    xyz = (spectra[..., :, None] * cie).sum(-2) * delta
    xyz = xyz * sensitivity[:, None, None]
    return xyz.sum(dim=1), (xyz * xyz).sum(dim=1)


def fold(mean_a, m2_a, n_a, v_sum, v_sq, spp):
    """Welford merge of a pass's per-pixel sums (float64 numpy [P, 3]) into
    a frame's (mean, m2, n): Raysect's statsarray combine_samples."""
    v_sum = np.asarray(v_sum, np.float64)
    v_sq = np.asarray(v_sq, np.float64)
    mean_b = v_sum / spp
    m2_b = np.maximum(v_sq - spp * mean_b * mean_b, 0.0)
    n_b = float(spp)
    tot = n_a + n_b
    safe = np.maximum(tot, 1.0)
    delta = mean_b - mean_a
    return (mean_a + delta * (n_b / safe),
            m2_a + m2_b + delta * delta * (n_a * n_b / safe), tot)
