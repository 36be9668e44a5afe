#!/usr/bin/env python3
"""Smoke run of source_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from source_tpu_torch/csrc/ (into
source_tpu_torch/_build/): the fused bounce kernels, forward and adjoint, the
analytic-BVH nearest-hit kernel and the mesh nearest-hit kernel. Holds each
against its plain PyTorch version on the card, runs the furnace checks
(analytic and watertight mesh), and drives the main paths: on
the glass Cornell box at 512x512 rays, 15 spectral bins, max_depth 16, 24
iterations, forward through ``compile_scene`` -> ``render_batch`` and the
training step through ``render_loss_and_grads``, each once through the
whole-span kernels and once through the per-bounce kernels (the adjoint
there over the live lanes binned by the counting-sort kernel, held to its
plain version and timed with the adjoint at every bounce), and both again
with the span kernels drawing their own uniforms (``rng="kernel"``, Philox in
the kernel: phase ``krng``); the per-bounce kernel beside its two profiling
variants, decisions replayed and loads and stores alone, over the flagship's
24 bounces (phase ``fusedprof``); and the CSG demo
(demos/csg.py) at 512x512 rays, 15 bins, max_depth 24, 32 iterations, with
compaction, through ``render_batch`` on the wavefront route; the mesh demo
(demos/mesh_render.py) at 512x384 rays, 12 bins, max_depth 12, 16
iterations, with compaction, on the wavefront route, and a world holding a
1.31M-triangle icosphere. Every phase prints one JSON line; any failure exits
non-zero. Without a CUDA device the script exits 2 and prints no result.
``--phases krng,fusedprof`` runs a subset while developing (the last line is
then not a pass).
"""

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM data sheet, f32 outside the tensor cores
# 32-bit integer operations per second outside the tensor cores: 64 INT32
# lanes per SM (Hopper architecture white paper) x 132 SMs x 1.98 GHz, the
# clock at which the data sheet's f32 rate is 128 lanes x 2 (FMA)
INT32_OPS = 64 * 132 * 1.98e9
RTOL, ATOL = 1e-3, 1e-4     # kernel vs plain on lanes whose choices agree
MAX_FLIP = 0.005            # lanes per bounce that may choose differently
# lanes that hit a torus (see torus_lanes): (worst lane, as a multiple of
# 1+|ref|; fraction of such lanes that may exceed RTOL/ATOL)
TORUS_BOUNCE = (1e-2, 0.01)  # after one bounce
TORUS_SPAN = (5e-2, 0.02)    # after a span, which carries the offset on
F64_FACTOR = 2.0            # kernel's distance from float64 over the plain version's
# adjoint kernels: per-lane cotangents within RTOL/ATOL (scaled by the largest
# incoming cotangent) on all but MAX_FLIP of the lanes (a lane within rounding
# of a threshold the bitfield does not store -- which root, which face, flip --
# may reverse another branch than the plain version); the table cotangent
# within TAB_TOL of its largest entry per table section: shared-memory float
# atomics add in an order that changes from run to run
TAB_TOL = 2e-4
ROUTE_TOL = 2e-4            # gradient fields between the two span routes
EULER_TOL = 1e-2            # sum(value * gradient) over emission rows vs 2 loss
N_ZOO = 65536
FLAGSHIP = dict(width=512, height=512, bins=15, max_depth=16, max_iters=24)
# the CSG demo as benchmarks/suite.py::bench_csg renders it (camera defaults:
# extinction 0.01 from depth 3, MIS on at weight 0.25, f32 spectral state)
CSG = dict(width=512, height=512, fov=75.0, position=(0.0, 0.0, -4.0), bins=15,
           max_depth=24, max_iters=32, extinction_prob=0.01,
           compact_schedule=((4, 4), (4, 4)))
N_FIELD = 262144
# f32 operations one BVH node visit and one item test cost, counted from the
# closed forms (slab test; record transform, closed form, normal), for the
# operations side of the kernel's bound
NODE_OPS = 26
ITEM_OPS = {0: 110, 1: 110, 2: 120, 3: 130, 4: 130, 5: 330, 6: 40, 7: 50}
CSG_CHILD_OPS = 150  # per child: transform, interval, endpoint masks, program
ITEM_BOX_OPS = 26    # an item's box test before its closed form (a slab test)
# the mesh demo as benchmarks/suite.py::bench_mesh traces it (camera defaults
# as for the CSG demo) at the demo's own camera, 512x384
MESH = dict(bins=12, max_depth=12, max_iters=16, extinction_prob=0.01,
            compact_schedule=((2, 8), (3, 4)))
N_ICO5 = 262144     # rays of the icosphere(5) case
N_BIG = 131072      # rays of benchmarks/bigmesh.py
# f32 operations of the mesh kernel, counted from tracer/watertight.py and
# the slab test (add, sub, mul, reciprocal, abs, min/max, compare): per ray
# (three safe reciprocals and the Woop setup), per visited node (slab test),
# per tested triangle (Woop test and the update)
MESH_RAY_OPS = 24
MESH_NODE_OPS = 26
MESH_TRI_OPS = 110
MESH_RTOL, MESH_ATOL = 1e-6, 1e-7  # t, u, v on lanes with the same triangle


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def canon(bits):
    """Bitfields with the unspecified ones (ray not alive) zeroed."""
    return torch.where((bits & 1) > 0, bits, torch.zeros_like(bits))


def torus_lanes(spec, bits):
    """Lanes whose winner leaf is a torus in any bounce of ``bits``
    ([N] or [n_steps, N]). The f32 quartic (Ferrari + 3 Newton steps on
    coefficients that grow like |o|^4) is ill-conditioned near grazing hits:
    two float routes that differ by an ulp (PyTorch divides by a scalar as a
    multiply by its reciprocal on the card, the kernel divides) can land 1e-2
    apart, each as far from a float64 evaluation as from the other, and the
    later bounces of the span carry the offset on. These lanes are held to
    TORUS_BOUNCE or TORUS_SPAN instead of the strict tolerance, and after one
    bounce also to the float64 evaluation (torus_against_f64)."""
    torus = [g for g, leaf in enumerate(spec.leaves) if leaf[0] == 5]
    if not torus:
        return torch.zeros(bits.shape[-1], dtype=torch.bool, device=bits.device)
    win = (bits >> 16) & 0x1FF
    hit = (bits & 3) == 3
    on = hit & torch.isin(win, torch.tensor(torus, device=bits.device))
    return on if on.dim() == 1 else on.any(0)


def torus_against_f64(fused, spec, tab, st, u, k_st, p_st, k_bits, p_bits):
    """How far the kernel and the plain version each stand from a float64
    evaluation of the same bounce on the lanes that hit a torus (and on which
    all three made the same choices), over o, d, thr and rad. If both are as
    far from it as from each other, their gap is the conditioning of the f32
    quartic, not a fault; ``ok`` is false when the kernel's worst lane, or its
    share of lanes beyond the strict tolerance, is more than F64_FACTOR times
    the plain version's."""
    st64 = {k: v.double() for k, v in st.items()}
    t_st, t_bits = fused.bounce_fwd_plain(spec, tab.double(), st64, u.double())
    lanes = (torus_lanes(spec, p_bits) & (canon(k_bits) == p_bits)
             & (t_bits == p_bits))
    n = int(lanes.sum())
    if n == 0:
        return dict(lanes=0, ok=True)
    false = torch.zeros(n, dtype=torch.bool, device=lanes.device)
    worst = dict(kernel_vs_plain=0.0, kernel_vs_f64=0.0, plain_vs_f64=0.0)
    beyond = dict(beyond_strict=false, kernel_beyond_f64=false,
                  plain_beyond_f64=false)
    for key in ("o", "d", "thr", "rad"):
        ref = t_st[key][:, lanes]
        k, p = k_st[key][:, lanes].double(), p_st[key][:, lanes].double()
        lim = ATOL + RTOL * ref.abs()
        for dev, far, out in (
                ((k - p).abs(), "kernel_vs_plain", "beyond_strict"),
                ((k - ref).abs(), "kernel_vs_f64", "kernel_beyond_f64"),
                ((p - ref).abs(), "plain_vs_f64", "plain_beyond_f64")):
            worst[far] = max(worst[far], float(dev.max()))
            beyond[out] = beyond[out] | (dev > lim).any(0)
    res = dict(lanes=n, **worst,
               **{k: float(v.double().mean()) for k, v in beyond.items()})
    res["ok"] = (
        res["kernel_vs_f64"] <= F64_FACTOR * res["plain_vs_f64"] + ATOL
        and res["kernel_beyond_f64"]
        <= F64_FACTOR * res["plain_beyond_f64"] + 1.0 / n)
    return res


def compare_state(a, b, agree, loose, loose_limits):
    """Deviation of o, d, thr, rad between two packed states on the lanes of
    ``agree``: max abs and max rel on the strict lanes, max abs on the
    ``loose`` lanes and the fraction of them beyond the strict tolerance, and
    whether all of it is within tolerance (``loose_limits`` is TORUS_BOUNCE
    or TORUS_SPAN)."""
    loose_tol, loose_beyond = loose_limits
    res = dict(max_abs=0.0, max_rel=0.0, torus_abs=0.0, torus_beyond=0.0, ok=True)
    strict, lax = agree & ~loose, agree & loose
    for k in ("o", "d", "thr", "rad"):
        if not bool(torch.isfinite(a[k]).all()):
            return dict(res, max_abs=float("nan"), ok=False)
        diff = (a[k] - b[k]).abs()
        ref = b[k].abs()
        if bool(strict.any()):
            ds, rs = diff[:, strict], ref[:, strict]
            res["max_abs"] = max(res["max_abs"], float(ds.max()))
            res["max_rel"] = max(res["max_rel"],
                                 float((ds / rs.clamp_min(1e-6)).max()))
            res["ok"] &= bool((ds <= ATOL + RTOL * rs).all())
        if bool(lax.any()):
            dl, rl = diff[:, lax], ref[:, lax]
            beyond = float((dl > ATOL + RTOL * rl).any(0).float().mean())
            res["torus_abs"] = max(res["torus_abs"], float(dl.max()))
            res["torus_beyond"] = max(res["torus_beyond"], beyond)
            res["ok"] &= (bool((dl <= loose_tol * (1.0 + rl)).all())
                          and beyond <= loose_beyond)
    return res


def mean_within(a, b, n_sigma=3.0):
    """Batch-mean radiance of two runs (per-lane mean over bins) and whether
    they agree within ``n_sigma`` standard errors."""
    x, y = a.float().mean(0), b.float().mean(0)
    se = float(torch.sqrt(x.var() / x.numel() + y.var() / y.numel()))
    diff = float((x.mean() - y.mean()).abs())
    return diff, se, diff <= n_sigma * se + 1e-7


def kernel_case(name, world, bins, cfg, o, d, span_steps, seed, T, fused,
                general=False):
    """Hold fused_bounce_fwd and fused_span_fwd against their plain versions
    on one scene (``general``: with every leaf as a general local-frame
    record, as the differentiable route traces it); returns a dict of
    measurements per kernel."""
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, bins))
    tables = fused.scene_tables(scene, cfg, general=general)
    if tables is None:
        fail(f"{name}: scene is outside the fused class")
    spec, entry = tables
    desc = entry["desc"]
    with torch.no_grad():
        tab = fused.pack_tabvec(scene, spec)
    N = o.shape[0]
    state = T.init_rays(torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda(),
                        bins)
    st0 = fused.pack_state(state)
    rng = np.random.RandomState(seed)
    n_max = max(span_steps)
    u_all = torch.as_tensor(
        rng.random_sample((n_max, fused.N_UNIFORMS, N)).astype(np.float32)).cuda()
    flops = fused.bounce_flops(spec)
    state_bytes = 4 * N * (8 + 2 * bins)
    table_bytes = 4 * (tab.numel() + desc.numel())
    res = {}

    # --- fused_bounce_fwd: at the first bounce and on a mixed mid-path state
    mid, _ = fused.span_fwd_plain(spec, tab, st0, u_all[:3])
    worst = dict(flip=0.0, max_abs=0.0, max_rel=0.0, torus_abs=0.0,
                 torus_beyond=0.0, mean_diff=0.0, mean_se=0.0)
    torus = []
    for st, u in ((st0, u_all[0]), (mid, u_all[3])):
        k_st, k_bits = fused.fused_bounce_fwd(spec, tab, desc, st, u)
        torch.cuda.synchronize()
        p_st, p_bits = fused.bounce_fwd_plain(spec, tab, st, u)
        if any(leaf[0] == 5 for leaf in spec.leaves):
            torus.append(torus_against_f64(fused, spec, tab, st, u, k_st, p_st,
                                           k_bits, p_bits))
            if not torus[-1].pop("ok"):
                fail(f"{name} fused_bounce_fwd: on torus lanes the kernel is "
                     f"further from float64 than the plain version: {torus[-1]}")
        agree = canon(k_bits) == p_bits
        flip = 1.0 - float(agree.float().mean())
        dev = compare_state(k_st, p_st, agree, torus_lanes(spec, p_bits),
                            TORUS_BOUNCE)
        diff, se, mean_ok = mean_within(k_st["rad"], p_st["rad"])
        if not dev.pop("ok"):
            fail(f"{name} fused_bounce_fwd: deviation {dev}")
        if flip > MAX_FLIP:
            fail(f"{name} fused_bounce_fwd: {flip:.5f} of lanes chose differently")
        if not mean_ok:
            fail(f"{name} fused_bounce_fwd: mean radiance differs {diff} (se {se})")
        now = dict(dev, flip=flip, mean_diff=diff, mean_se=se)
        worst = {k: max(worst[k], now[k]) for k in worst}
    # timed at the first bounce, where every ray is alive
    segs = int((fused.fused_bounce_fwd(spec, tab, desc, st0, u_all[0])[1] & 1).sum())
    # device time (the kernel is shorter than its wrapper's enqueue), and
    # back to back at the host's pace, as the other rows are timed
    ms = device_ms(lambda: fused.fused_bounce_fwd(spec, tab, desc, st0, u_all[0]))
    host_paced_ms = time_ms(
        lambda: fused.fused_bounce_fwd(spec, tab, desc, st0, u_all[0]), 20)
    plain_ms = time_ms(lambda: fused.bounce_fwd_plain(spec, tab, st0, u_all[0]), 2)
    nbytes = table_bytes + 2 * state_bytes + 4 * N + 4 * fused.N_UNIFORMS * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, segs * flops / F32_FLOPS * 1e3
    res["fused_bounce_fwd"] = dict(
        scene=name, n=N, bins=bins, segments=segs, **worst, ms=ms,
        host_paced_ms=host_paced_ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops)
    if torus:
        res["fused_bounce_fwd"]["torus_lanes"] = torus

    # --- fused_span_fwd over each span length
    spans = []
    for n_steps in span_steps:
        u = u_all[:n_steps].contiguous()
        k_st, k_bits = fused.fused_span_fwd(spec, tab, desc, st0, u)
        torch.cuda.synchronize()
        p_st, p_bits = fused.span_fwd_plain(spec, tab, st0, u)
        same = canon(k_bits) == p_bits                  # [n_steps, N]
        agree_upto = torch.cumprod(same.int(), 0).bool()  # history agrees
        before = torch.cat([torch.ones_like(same[:1]), agree_upto[:-1]])
        new_flips = (before & ~same).float().mean(1)    # first divergence
        flip = float(new_flips.max())
        agree = agree_upto[-1]
        dev = compare_state(k_st, p_st, agree, torus_lanes(spec, p_bits),
                            TORUS_SPAN)
        diff, se, mean_ok = mean_within(k_st["rad"], p_st["rad"])
        if not dev.pop("ok"):
            fail(f"{name} fused_span_fwd[{n_steps}]: deviation {dev}")
        if flip > MAX_FLIP:
            fail(f"{name} fused_span_fwd[{n_steps}]: {flip:.5f} of lanes chose "
                 "differently in one bounce")
        if not mean_ok:
            fail(f"{name} fused_span_fwd[{n_steps}]: mean radiance differs "
                 f"{diff} (se {se})")
        segs = int((k_bits & 1).sum())
        entered = N + int(((k_bits[:-1] >> fused.B_ALIVENEXT) & 1).sum())
        ms = time_ms(lambda: fused.fused_span_fwd(spec, tab, desc, st0, u), 5)
        plain_ms = time_ms(lambda: fused.span_fwd_plain(spec, tab, st0, u), 1)
        nbytes = (table_bytes + 2 * state_bytes + 4 * n_steps * N
                  + 4 * fused.N_UNIFORMS * entered)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = segs * flops / F32_FLOPS * 1e3
        spans.append(dict(
            scene=name, n=N, bins=bins, n_steps=n_steps, segments=segs,
            flip=flip, diverged=1.0 - float(agree.float().mean()), **dev,
            mean_diff=diff, mean_se=se, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes_ms=t_bytes, operations_ms=t_ops))
    res["fused_span_fwd"] = spans
    return res


def phase_env(fused, bvh):
    t0 = time.time()
    from source_tpu_torch.tracer import mesh_bvh
    jobs = [(b, which) for which in ("fwd", "bwd") for b in (FLAGSHIP["bins"], 5)]
    jobs += [(None, "bvh"), (None, "mesh")]

    def build(job):
        if job[1] == "bvh":
            return bvh.build_library(verbose=True)[1]
        if job[1] == "mesh":
            return mesh_bvh.build_library(verbose=True)[1]
        return fused.build_library(job[0], job[1], verbose=True)[1]

    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(build, jobs))
    build_s = time.time() - t0

    def ptxas(log):
        """ptxas -v lines per kernel: registers, stack frame, spills."""
        out, name = {}, None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
            elif name and ("registers" in ln or "spill" in ln):
                out.setdefault(name, []).append(
                    ln.split(":", 1)[-1].strip())
        return out

    emit("env", gpu=gpu_line(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=round(build_s, 2),
         nvcc_flags=" ".join(fused.NVCC_FLAGS), ptxas_fwd_b15=ptxas(logs[0]),
         ptxas_bwd_b15=ptxas(logs[2]), ptxas_bwd_b5=ptxas(logs[3]),
         ptxas_bvh=ptxas(logs[4]),
         ptxas_mesh=ptxas(logs[5]), libraries=len(jobs))


def phase_kernels(T, fused, scenes):
    cfg = T.RayConfig(max_depth=FLAGSHIP["max_depth"], max_iters=24)
    o, d = scenes.pinhole_rays(FLAGSHIP["width"], FLAGSHIP["height"])
    cornell = kernel_case("cornell", scenes.cornell_box(glass=True),
                          FLAGSHIP["bins"], cfg, o, d, (8, 24), 11, T, fused)
    # the same box as the differentiable route traces it: general records
    general = kernel_case("cornell_general", scenes.cornell_box(glass=True),
                          FLAGSHIP["bins"], cfg, o, d, (24,), 13, T, fused,
                          general=True)
    o, d = scenes.scatter_rays(N_ZOO, seed=1)
    zoo = kernel_case("zoo", scenes.zoo(), 5, T.RayConfig(max_depth=6), o, d,
                      (8, 24), 12, T, fused)
    emit("kernels", tolerance=dict(rtol=RTOL, atol=ATOL, max_flip=MAX_FLIP,
                                   torus_bounce=TORUS_BOUNCE,
                                   torus_span=TORUS_SPAN,
                                   f64_factor=F64_FACTOR),
         fused_bounce_fwd=[cornell["fused_bounce_fwd"],
                           general["fused_bounce_fwd"], zoo["fused_bounce_fwd"]],
         fused_span_fwd=(cornell["fused_span_fwd"] + general["fused_span_fwd"]
                         + zoo["fused_span_fwd"]))
    return cornell


def table_sections(spec, fused):
    """(name, start, stop) of the table vector's sections."""
    cuts = [0, fused._mat_base(spec), fused._imp_base(spec),
            fused._check_base(spec), fused.tab_size(spec)]
    names = ("leaves", "materials", "importance", "checker")
    return [(n, a, b) for n, a, b in zip(names, cuts, cuts[1:]) if b > a]


def compare_table(spec, fused, got, ref):
    """Largest deviation of a table cotangent per section, as a fraction of
    the section's largest reference entry."""
    res, ok = {}, bool(torch.isfinite(got).all())
    for name, a, b in table_sections(spec, fused):
        scale = max(float(ref[a:b].abs().max()), 1e-6)
        res[name] = float((got[a:b] - ref[a:b]).abs().max()) / scale
        ok &= res[name] <= TAB_TOL
    return res, ok


def compare_cots(got, ref, live, cot_scale, loose=None):
    """Per-lane deviation of the state cotangents (go, gd, gthr) on the
    ``live`` lanes: the fraction of lanes beyond RTOL/ATOL (ATOL scaled by
    the incoming cotangents' magnitude), the largest deviation among the
    lanes within, and the largest on the ``loose`` (torus) lanes."""
    bad = torch.zeros_like(live)
    worst = torch.zeros(live.shape, device=live.device)
    for g, r in zip(got, ref):
        if not bool(torch.isfinite(g).all()):
            return dict(beyond=1.0, max_abs=float("nan"), torus_abs=0.0)
        dev = (g - r).abs()
        bad |= (dev > ATOL * cot_scale + RTOL * r.abs()).any(0)
        worst = torch.maximum(worst, dev.max(0).values)
    strict = live if loose is None else live & ~loose
    inside = strict & ~bad
    res = dict(
        beyond=float((bad & strict).sum()) / max(int(strict.sum()), 1),
        max_abs=float(worst[inside].max()) if bool(inside.any()) else 0.0,
        torus_abs=0.0)
    if loose is not None and bool((live & loose).any()):
        res["torus_abs"] = float(worst[live & loose].max())
        res["torus_beyond"] = float((bad & live & loose).sum()) / int(
            (live & loose).sum())
    return res


@contextlib.contextmanager
def converged_quartic(newton_iters=14):
    """Within the block the port's quartic solver polishes its roots with
    ``newton_iters`` Newton steps whatever its caller asks for (the torus hit
    asks for 3): in float64 that is the root itself, and autograd of it the
    root's true derivative."""
    from source_tpu_torch.core.math import polyroots
    solve = polyroots.solve_quartic_components
    polyroots.solve_quartic_components = (
        lambda a, b, c, d, e, newton_iters_=2, **kw:
        solve(a, b, c, d, e, newton_iters=newton_iters))
    try:
        yield
    finally:
        polyroots.solve_quartic_components = solve


def torus_cots_against_f64(got, ref, r64, on, cot_scale):
    """How far the adjoint kernel and its plain version each stand from a
    converged float64 evaluation (``converged_quartic``) on the lanes ``on``
    (those that hit a torus), per lane over go, gd, gthr: the share of lanes
    beyond the strict tolerance, the 99th percentile and the worst lane.

    Ferrari's f32 seeds are poor (median error 0.2 in the hit distance on
    unit-scale tori) and three Newton steps do not always converge. The plain
    version's autograd differentiates the seed too; the kernel reverses the
    Newton steps and takes the seed as a constant. The two differ by the
    seed's derivative times the steps' contraction (median 5e-4, a tenth of
    the lanes above 0.04), and neither is the root's derivative: so they are
    held to the converged evaluation, not to each other. The cotangent of a
    root also grows like 1 / P'(root) towards a grazing hit, so single lanes
    are unbounded in all three evaluations. ``ok`` holds the kernel's share
    beyond strict to F64_FACTOR times the plain version's plus MAX_FLIP (lanes
    on which a choice the bitfield does not store, here which root, falls the
    other way), and its 99th percentile to F64_FACTOR times the plain
    version's."""
    n = int(on.sum())
    if n == 0:
        return dict(lanes=0, ok=True)
    res = dict(lanes=n)
    for key, a, b in (("kernel_vs_plain", got, ref), ("kernel_vs_f64", got, r64),
                      ("plain_vs_f64", ref, r64)):
        dev = torch.zeros(n, dtype=torch.float64, device=on.device)
        bad = torch.zeros(n, dtype=torch.bool, device=on.device)
        for x, y in zip(a, b):
            d = (x[:, on].double() - y[:, on].double()).abs()
            bad |= (d > ATOL * cot_scale + RTOL * y[:, on].double().abs()).any(0)
            dev = torch.maximum(dev, d.max(0).values)
        res[key] = dict(worst=float(dev.max()),
                        q99=float(torch.quantile(dev, 0.99)),
                        beyond=float(bad.double().mean()))
    k, p = res["kernel_vs_f64"], res["plain_vs_f64"]
    res["ok"] = (k["beyond"] <= F64_FACTOR * p["beyond"] + MAX_FLIP
                 and k["q99"] <= F64_FACTOR * p["q99"] + ATOL * cot_scale)
    return res


def check_binning(spec, fused, bits, where):
    """The binning pass on one bounce's bitfield against its plain version:
    the same live count and the same permutation of the live lanes. Returns
    (live lanes, permutation entries that differ plus the count's
    difference)."""
    perm, count = fused.bin_live_lanes(spec, bits)
    ref_perm, ref_count = fused.bin_live_lanes_plain(bits)
    n = int(ref_count[0])
    wrong = abs(int(count[0]) - n) + int((perm[:n] != ref_perm[:n]).sum())
    if wrong:
        fail(f"{where} bin_live_lanes: the permutation or the live count "
             f"differs from its plain version ({wrong} entries)")
    return n, wrong


def grad_case(name, world, bins, cfg, o, d, seed, T, fused):
    """Hold fused_bounce_bwd and fused_span_bwd against their plain versions
    (and against each other) on one scene at the general spec; returns a dict
    of measurements per kernel."""
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, bins))
    spec, entry = fused.scene_tables(scene, cfg, general=True)
    desc = entry["desc"]
    with torch.no_grad():
        tab = fused.pack_tabvec(scene, spec)
    N = o.shape[0]
    n_steps = cfg.max_iters
    st0 = fused.pack_state(T.init_rays(
        torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda(), bins))
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).cuda()

    u_all = torch.as_tensor(
        rng.random_sample((n_steps, fused.N_UNIFORMS, N)).astype(np.float32)).cuda()
    cots = dict(go=randn(3, N), gd=randn(3, N), gthr=randn(bins, N),
                g_rad=randn(bins, N))
    cot_scale = float(max(c.abs().max() for c in cots.values()))
    has_torus = any(leaf[0] == 5 for leaf in spec.leaves)

    # entry state and bitfield of every bounce, by the per-bounce kernel
    entries, st = [], st0
    for k in range(n_steps):
        new, bits = fused.fused_bounce_fwd(spec, tab, desc, st, u_all[k])
        entries.append((st, bits))
        st = new
    k3_st, k3_bits = fused.fused_span_fwd(spec, tab, desc, st0, u_all)
    if not torch.equal(k3_bits, torch.stack([b for _, b in entries])):
        fail(f"{name}: span and per-bounce forward kernels disagree on bits")
    res = {}

    # --- fused_bounce_bwd: the first bounce and a mid-path bounce
    worst = dict(beyond=0.0, max_abs=0.0, torus_abs=0.0, torus_beyond=0.0)
    tab_dev, f64 = {}, []
    for k in (0, 3):
        e, bits = entries[k]
        args = (e["o"], e["d"], e["thr"], e["aux"], u_all[k], bits,
                cots["go"], cots["gd"], cots["gthr"], cots["g_rad"])
        got = fused.fused_bounce_bwd(spec, tab, desc, *args)
        torch.cuda.synchronize()
        ref = fused.bounce_bwd_plain(spec, tab, *args)
        live = bits != 0
        for g, c in zip(got[:3], (cots["go"], cots["gd"], cots["gthr"])):
            if not torch.equal(g[:, ~live], c[:, ~live]):
                fail(f"{name} fused_bounce_bwd[{k}]: a lane with a zero "
                     "bitfield is not a pass-through")
        loose = torus_lanes(spec, bits) if has_torus else None
        dev = compare_cots(got[:3], ref[:3], live, cot_scale, loose)
        if dev["beyond"] > MAX_FLIP or not np.isfinite(dev["max_abs"]):
            fail(f"{name} fused_bounce_bwd[{k}]: state cotangents {dev}")
        if has_torus:
            # torus lanes beside a float64 evaluation of the plain version
            # with the quartic polished to convergence
            with converged_quartic():
                r64 = fused.bounce_bwd_plain(
                    spec, tab.double(),
                    *[a.double() if a.is_floating_point() else a for a in args])
            on = live & loose
            rec = torus_cots_against_f64(got[:3], ref[:3], r64[:3], on, cot_scale)
            f64.append(rec)
            if not rec.pop("ok"):
                fail(f"{name} fused_bounce_bwd[{k}]: on torus lanes the kernel "
                     f"is further from float64 than the plain version: {rec}")
            # the table is held on the other lanes: cotangents are linear
            # in the table term, so zeroed lanes add nothing
            keep = (~on).float()
            masked = [a * keep if i >= 6 else a for i, a in enumerate(args)]
            got = fused.fused_bounce_bwd(spec, tab, desc, *masked)
            ref = fused.bounce_bwd_plain(spec, tab, *masked)
        tdev, tok = compare_table(spec, fused, got[3], ref[3])
        if not tok:
            fail(f"{name} fused_bounce_bwd[{k}]: table cotangent {tdev}")
        worst = {m: max(worst[m], dev.get(m, 0.0)) for m in worst}
        tab_dev = {m: max(tab_dev.get(m, 0.0), v) for m, v in tdev.items()}
    # the binning pass that schedules fused_bounce_bwd, against its plain
    # version: the same stable permutation, exactly, at every bounce
    bin_rows, bin_wrong = [], 0
    for k in range(n_steps):
        live_k, wrong = check_binning(spec, fused, entries[k][1],
                                      f"{name}[{k}]")
        bin_rows.append(live_k)
        bin_wrong += wrong
    e, bits = entries[0]
    args = (e["o"], e["d"], e["thr"], e["aux"], u_all[0], bits,
            cots["go"], cots["gd"], cots["gthr"], cots["g_rad"])
    live_n = int((bits != 0).sum())
    # the wrapper (binning pass + kernel) and the binning pass by the device
    # timer; the kernel alone is their difference
    ms = device_ms(lambda: fused.fused_bounce_bwd(spec, tab, desc, *args))
    bin_ms = device_ms(lambda: fused.bin_live_lanes(spec, bits))
    kernel_ms = ms - bin_ms
    plain_ms = time_ms(lambda: fused.bounce_bwd_plain(spec, tab, *args), 1)
    flops = fused.bounce_bwd_flops(spec)
    table_bytes = 4 * (2 * tab.numel() + desc.numel())
    # entry state, uniforms, bitfield, 6 + 2B cotangent rows in, 6 + B out
    nbytes = table_bytes + 4 * N * (
        (8 + bins) + fused.N_UNIFORMS + 1 + (6 + 2 * bins) + (6 + bins))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, live_n * flops / F32_FLOPS * 1e3
    # dynamic shared memory of a block: the table, the descriptor, the table
    # cotangent and 32 ints of scan scratch (the binning pass: a count per
    # key for each of its 4 warps, and the keys' first slots)
    smem = 4 * (2 * tab.numel() + desc.numel() + 32)
    res["fused_bounce_bwd"] = dict(
        scene=name, n=N, bins=bins, live=live_n, **worst, table=tab_dev, ms=ms,
        kernel_ms=kernel_ms, bin_ms=bin_ms, smem_bytes=smem,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops)
    if f64:
        res["fused_bounce_bwd"]["torus_lanes"] = f64
    # the binning pass at the first bounce: bitfield in, permutation and
    # count out; beside it one stable torch.sort of the keys (a yardstick the
    # port never calls)
    key = fused.adjoint_key_plain(bits)
    key = torch.where(key < 0, fused.n_adjoint_keys(spec), key)
    b_bytes = 4 * (N + live_n + 1)
    res["bin_live_lanes"] = dict(
        scene=name, n=N, live=live_n, max_abs=float(bin_wrong),
        smem_bytes=4 * 5 * fused.n_adjoint_keys(spec),
        by_bounce=bin_rows, ms=bin_ms,
        plain_ms=time_ms(lambda: fused.bin_live_lanes_plain(bits), 3),
        library_ms=device_ms(lambda: torch.sort(key, stable=True)),
        **bound(b_bytes, 0))

    # --- fused_span_bwd: against the plain version, against the chain of
    # per-bounce adjoint kernels, and its replay against the forward kernel
    span_args = (st0, u_all, k3_bits, cots["go"], cots["gd"], cots["gthr"],
                 cots["g_rad"])
    got = fused.fused_span_bwd(spec, tab, desc, *span_args, return_replay=True)
    torch.cuda.synchronize()
    want = torch.cat([k3_st["o"], k3_st["d"], k3_st["thr"], k3_st["aux"]])
    if not torch.equal(got[4], want):
        fail(f"{name} fused_span_bwd: its forward replay does not end in the "
             "forward kernel's state bit for bit")
    chain = (cots["go"], cots["gd"], cots["gthr"])
    chain_tab = torch.zeros_like(tab)
    for k in range(n_steps - 1, -1, -1):
        e, bits = entries[k]
        *chain, gt = fused.fused_bounce_bwd(
            spec, tab, desc, e["o"], e["d"], e["thr"], e["aux"], u_all[k],
            bits, *chain, cots["g_rad"])
        chain_tab += gt
    ref = fused.span_bwd_plain(spec, tab, {k: st0[k] for k in
                                           ("o", "d", "thr", "aux")},
                               *span_args[1:])
    every = torch.ones(N, dtype=torch.bool, device="cuda")
    loose = torus_lanes(spec, k3_bits) if has_torus else None
    vs_chain = compare_cots(got[:3], chain, every, cot_scale)
    vs_plain = compare_cots(got[:3], ref[:3], every, cot_scale, loose)
    tab_chain, ok_chain = compare_table(spec, fused, got[3], chain_tab)
    tab_plain, ok_plain = compare_table(spec, fused, got[3], ref[3])
    # kernel against kernel: the same arithmetic, so every lane agrees and
    # the table differs by the atomics' summation order only
    if vs_chain["beyond"] > 0.0 or not ok_chain:
        fail(f"{name} fused_span_bwd against {n_steps} fused_bounce_bwd: "
             f"{vs_chain} table {tab_chain}")
    if vs_plain["beyond"] > MAX_FLIP or not np.isfinite(vs_plain["max_abs"]):
        fail(f"{name} fused_span_bwd against its plain version: {vs_plain}")
    if not ok_plain and not has_torus:
        fail(f"{name} fused_span_bwd: table cotangent against the plain "
             f"version {tab_plain}")
    dead = ~(k3_bits != 0).any(0)
    for g, c in zip(got[:3], (cots["go"], cots["gd"], cots["gthr"])):
        if not torch.equal(g[:, dead], c[:, dead]):
            fail(f"{name} fused_span_bwd: a lane that entered no bounce is "
                 "not a pass-through")
    entered = N + int(((k3_bits[:-1] >> fused.B_ALIVENEXT) & 1).sum())
    live_n = int((k3_bits != 0).sum())
    ms = time_ms(lambda: fused.fused_span_bwd(spec, tab, desc, *span_args), 3)
    plain_ms = time_ms(lambda: fused.span_bwd_plain(
        spec, tab, {k: st0[k] for k in ("o", "d", "thr", "aux")},
        *span_args[1:]), 1)
    # st0, cotangents in and out once per ray; uniforms, bitfield and the
    # saved entry state (written, then read) once per entered bounce
    nbytes = table_bytes + 4 * N * ((8 + bins) + (6 + 2 * bins) + (6 + bins)) \
        + 4 * entered * (fused.N_UNIFORMS + 1 + 2 * (8 + bins))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, live_n * (
        flops + fused.bounce_flops(spec)) / F32_FLOPS * 1e3
    res["fused_span_bwd"] = dict(
        scene=name, n=N, bins=bins, n_steps=n_steps, live=live_n,
        entered=entered, vs_plain=vs_plain, vs_chain=vs_chain,
        table_vs_plain=tab_plain, table_vs_chain=tab_chain,
        max_abs=vs_plain["max_abs"], replay_equal=True, ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops, smem_bytes=smem,
        scratch_bytes=4 * fused._library(bins, "bwd").fused_span_bwd_floats(
            N, n_steps))
    return res


def phase_grad_kernels(T, fused, scenes):
    cfg = T.RayConfig(max_depth=FLAGSHIP["max_depth"], max_iters=24)
    o, d = scenes.pinhole_rays(FLAGSHIP["width"], FLAGSHIP["height"])
    cornell = grad_case("cornell", scenes.cornell_box(glass=True),
                        FLAGSHIP["bins"], cfg, o, d, 21, T, fused)
    o, d = scenes.scatter_rays(N_ZOO, seed=1)
    zoo = grad_case("zoo", scenes.zoo(), 5,
                    T.RayConfig(max_depth=6, max_iters=24), o, d, 22, T, fused)
    emit("grad_kernels",
         tolerance=dict(rtol=RTOL, atol=ATOL, max_flip=MAX_FLIP, table=TAB_TOL,
                        f64_factor=F64_FACTOR),
         fused_bounce_bwd=[cornell["fused_bounce_bwd"], zoo["fused_bounce_bwd"]],
         fused_span_bwd=[cornell["fused_span_bwd"], zoo["fused_span_bwd"]],
         bin_live_lanes=[cornell["bin_live_lanes"], zoo["bin_live_lanes"]])
    return cornell


def phase_furnace(T, scenes):
    scene = T.compile_scene(scenes.furnace(), T.SpectralConfig(375.0, 740.0, 15))
    n = 65536
    d = np.random.RandomState(2).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    st = T.render_batch(scene, T.RayConfig(max_iters=4),
                        np.zeros((n, 3), np.float32), d, gen)
    exact = bool((st.radiance == 1.0).all())
    emit("furnace", rays=n, exact=exact, segments=int(st.segments),
         min=float(st.radiance.min()), max=float(st.radiance.max()))
    if not exact or int(st.segments) != n:
        fail("furnace: radiance is not exactly 1.0 in every bin")


KERNELS = ("fused_bounce_fwd", "fused_span_fwd", "fused_bounce_bwd",
           "bin_live_lanes", "fused_span_bwd", "fused_bounce_replay",
           "fused_bounce_io", "analytic_bvh_winner", "mesh_bvh_winner")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def wrappers(fused):
    """Each kernel's wrapper, which counts its launches."""
    from source_tpu_torch.tracer import analytic_bvh, mesh_bvh
    home = dict(analytic_bvh_winner=analytic_bvh, mesh_bvh_winner=mesh_bvh)
    return {k: getattr(home.get(k, fused), k) for k in KERNELS}


def reset_counts(fused):
    for w in wrappers(fused).values():
        w.launches = 0


def read_counts(fused):
    return {k: w.launches for k, w in wrappers(fused).items()}


def flagship(T, fused, scenes):
    """The flagship scene, configuration, rays and one fixed set of uniforms."""
    bins = FLAGSHIP["bins"]
    scene = T.compile_scene(scenes.cornell_box(glass=True),
                            T.SpectralConfig(375.0, 740.0, bins))
    cfg = T.RayConfig(
        max_depth=FLAGSHIP["max_depth"], extinction_prob=0.1,
        extinction_min_depth=3, importance_sampling=True,
        important_path_weight=0.25, max_iters=FLAGSHIP["max_iters"],
        compact_schedule=(), spectral_dtype="bfloat16")
    o, d = scenes.pinhole_rays(FLAGSHIP["width"], FLAGSHIP["height"])
    o, d = torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()
    u_fixed = torch.rand((cfg.max_iters, o.shape[0], fused.N_UNIFORMS),
                         device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))

    def same_u(start, n_steps, n_lanes):
        return u_fixed[start:start + n_steps, :n_lanes]

    return scene, cfg, o, d, u_fixed, same_u


def stage_ms(fn, reps=5):
    """Mean host milliseconds of ``fn()``, synchronised, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_main(T, fused, scenes):
    bins = FLAGSHIP["bins"]
    scene, cfg, o, d, u_fixed, same_u = flagship(T, fused, scenes)
    n = o.shape[0]

    # the main path, once per kernel route; each route's launch counts are
    # set to 0 just before it and read just after, and must be its own
    # kernel's alone
    def counted(span):
        reset_counts(fused)
        st = T.render_batch(scene, cfg, o, d, u_all=same_u, span=span)
        torch.cuda.synchronize()
        return st, read_counts(fused)

    multi, n_span = counted("multi")
    per, n_per = counted("perbounce")
    launches = {"span": n_span, "perbounce": n_per}
    if n_span != dict(NO_LAUNCHES, fused_span_fwd=1):
        fail(f"main: the span route must launch fused_span_fwd once and "
             f"nothing else: {launches}")
    if (n_per != dict(NO_LAUNCHES, fused_bounce_fwd=n_per["fused_bounce_fwd"])
            or not 1 <= n_per["fused_bounce_fwd"] <= cfg.max_iters):
        fail(f"main: the per-bounce route must launch fused_bounce_fwd once "
             f"per bounce and nothing else: {launches}")

    rad = multi.radiance.float()
    if tuple(rad.shape) != (n, bins) or not bool(torch.isfinite(rad).all()):
        fail("main: radiance has the wrong shape or is not finite")
    routes_equal = (bool(torch.equal(multi.radiance, per.radiance))
                    and int(multi.segments) == int(per.segments))
    if not routes_equal:
        fail("main: span and per-bounce routes disagree on the same uniforms")
    still_alive = int(multi.alive.sum())
    if int((multi.alive & (multi.depth < cfg.max_depth)).sum()) != still_alive:
        fail("main: an alive lane is beyond max_depth")

    def timed(span):
        gen = torch.Generator(device="cuda").manual_seed(7)
        walls, segs = [], 0
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = T.render_batch(scene, cfg, o, d, gen, span=span)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            segs = int(st.segments)
        return float(np.median(walls[1:])), segs

    wall_multi, seg_multi = timed("multi")
    wall_per, seg_per = timed("perbounce")

    # where one span-route render_batch spends its wall time, stage by stage
    def tables():
        spec, entry = fused.scene_tables(scene, cfg)
        return spec, entry["desc"], fused.forward_table(scene, spec, entry)

    spec, desc, tab = tables()
    state = T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype)
    st, u_p = fused.pack_state(state), fused.pack_u(u_fixed)
    out, _ = fused.fused_span_fwd(spec, tab, desc, st, u_p)
    stages = dict(
        # spec, descriptor and table are kept on the scene after the first call
        tables_ms=stage_ms(tables),
        uniforms_ms=stage_ms(lambda: torch.rand(
            (cfg.max_iters, n, fused.N_UNIFORMS), device="cuda")),
        pack_ms=stage_ms(lambda: (
            T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype),
            fused.pack_state(state), fused.pack_u(u_fixed))),
        kernel_ms=stage_ms(
            lambda: fused.fused_span_fwd(spec, tab, desc, st, u_p)),
        unpack_ms=stage_ms(lambda: fused.unpack_state(out, state, 0)))

    # MIS on against off: the estimator's mean must not move
    o_s, d_s = o[::4].contiguous(), d[::4].contiguous()
    runs = {}
    for mis in (True, False):
        c = T.RayConfig(max_depth=16, max_iters=24, importance_sampling=mis)
        gen = torch.Generator(device="cuda").manual_seed(9)
        runs[mis] = T.render_batch(scene, c, o_s, d_s, gen).radiance.t()
    diff, se, mis_ok = mean_within(runs[True], runs[False], n_sigma=4.0)
    if not mis_ok:
        fail(f"main: MIS on/off means differ by {diff} (standard error {se})")

    emit("main", rays=n, bins=bins, max_depth=cfg.max_depth,
         max_iters=cfg.max_iters, spectral_dtype=cfg.spectral_dtype,
         segments=int(multi.segments), still_alive_at_bound=still_alive,
         mean_radiance_per_bin=[round(float(x), 5) for x in rad.mean(0)],
         routes_equal=routes_equal, launches=launches,
         wall_ms_span=wall_multi * 1e3, wall_ms_perbounce=wall_per * 1e3,
         span_stages=stages,
         segments_per_s_span=seg_multi / wall_multi,
         segments_per_s_perbounce=seg_per / wall_per,
         mis_mean_diff=diff, mis_standard_error=se,
         mis_runs_identical=bool(torch.equal(runs[True], runs[False])))
    return launches


def phase_step(T, fused, scenes):
    """The training step of the flagship: ``render_loss_and_grads`` against a
    zero target, once per span route."""
    from source_tpu_torch.optical.material.base import MAT_EMITTER
    bins = FLAGSHIP["bins"]
    scene, cfg, o, d, u_fixed, same_u = flagship(T, fused, scenes)
    n = o.shape[0]
    target = torch.zeros((n, bins), device="cuda")
    # the per-bounce route bins the live lanes before each adjoint; the
    # whole-span kernel regroups them inside itself
    want = {"perbounce": dict(NO_LAUNCHES, fused_bounce_fwd=cfg.max_iters,
                              fused_bounce_bwd=cfg.max_iters,
                              bin_live_lanes=cfg.max_iters),
            "multi": dict(NO_LAUNCHES, fused_span_fwd=1, fused_span_bwd=1)}
    emit_rows = [m for m, t in enumerate(scene.mat_types) if t == MAT_EMITTER]
    runs, launches, euler, peak = {}, {}, {}, {}
    for span in ("perbounce", "multi"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        loss, grads = T.render_loss_and_grads(scene, cfg, o, d, target,
                                              u_all=same_u, span=span)
        torch.cuda.synchronize()
        launches[span] = read_counts(fused)
        peak[span] = torch.cuda.max_memory_allocated() - base
        if launches[span] != want[span]:
            fail(f"step[{span}]: launches {launches[span]}, want {want[span]}")
        for f, g in grads.items():
            if g.shape != getattr(scene, f).shape or not bool(
                    torch.isfinite(g).all()):
                fail(f"step[{span}]: gradient of {f} has the wrong shape or "
                     "is not finite")
        for f in ("leaf_w2l", "leaf_params", "mat_spectra"):
            if not bool((grads[f] != 0).any()):
                fail(f"step[{span}]: gradient of {f} is all zero")
        # radiance is homogeneous of degree 1 in the emitters' emission rows,
        # so against a zero target sum(value * gradient) over them is 2 loss
        # (to the rounding of the bf16 radiance the loss is taken on)
        lhs = float(sum((scene.mat_spectra[m, 0] * grads["mat_spectra"][m, 0])
                        .sum() for m in emit_rows))
        euler[span] = lhs / (2.0 * float(loss))
        if abs(euler[span] - 1.0) > EULER_TOL:
            fail(f"step[{span}]: Euler identity on the emission rows: "
                 f"sum(value * gradient) / (2 loss) = {euler[span]}")
        if any(t.requires_grad for t in (scene.leaf_w2l, scene.mat_spectra)):
            fail("step: the caller's scene was left requiring gradients")
        runs[span] = (loss, grads)
    if float(runs["multi"][0]) != float(runs["perbounce"][0]):
        fail(f"step: the routes' losses differ on the same uniforms: "
             f"{float(runs['multi'][0])} {float(runs['perbounce'][0])}")
    route_dev = {}
    for f in runs["multi"][1]:
        a, b = runs["multi"][1][f], runs["perbounce"][1][f]
        scale = max(float(a.abs().max()), 1e-6)
        route_dev[f] = float((a - b).abs().max()) / scale
        if route_dev[f] > ROUTE_TOL:
            fail(f"step: gradient of {f} differs between the routes by "
                 f"{route_dev[f]} of its largest entry")

    def timed(span):
        walls = []
        for _ in range(6):
            gen = torch.Generator(device="cuda").manual_seed(7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.render_loss_and_grads(scene, cfg, o, d, target, gen, span=span)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls[1:]))

    walls = {span: timed(span) for span in ("perbounce", "multi")}
    gen = torch.Generator(device="cuda").manual_seed(7)
    segments = int(T.render_batch(scene, cfg, o, d, gen).segments)

    # where one step spends its time, stage by stage
    spec, entry = fused.scene_tables(scene, cfg, general=True)
    desc = entry["desc"]
    leaves = [getattr(scene, f).detach().requires_grad_(True)
              for f in fused.TABLE_FIELDS]
    diff_scene = dataclasses.replace(scene, **dict(zip(fused.TABLE_FIELDS, leaves)))
    tab_g = fused.pack_tabvec(diff_scene, spec)
    tab = tab_g.detach()
    state = T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype)
    st, u_p = fused.pack_state(state), fused.pack_u(u_fixed)
    out, bits = fused.fused_span_fwd(spec, tab, desc, st, u_p)
    # random non-zero cotangents: with zeros most table adds are skipped
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = [torch.randn(st[k].shape, device="cuda", generator=gen)
           for k in ("o", "d", "thr")]
    g_rad = torch.rand(st["rad"].shape, device="cuda", generator=gen)
    g_tab = torch.rand(tab.shape, device="cuda", generator=gen)

    def per_fwd():
        cur, saved = st, []
        for u in u_p:
            new, b = fused.fused_bounce_fwd(spec, tab, desc, cur, u)
            saved.append((cur, b))
            cur = new
        return saved

    saved = per_fwd()

    def per_bwd():
        c = cot
        for k in range(len(saved) - 1, -1, -1):
            e, b = saved[k]
            *c, _ = fused.fused_bounce_bwd(spec, tab, desc, e["o"], e["d"],
                                           e["thr"], e["aux"], u_p[k], b, *c,
                                           g_rad)

    # the per-bounce adjoint at every bounce of the path, by the device
    # timer, beside the rays that take part: the wrapper (binning pass and
    # kernel), the binning pass, the kernel alone (their difference), and the
    # forward kernel; the binning held to its plain version at each
    by_bounce = []
    for k in range(len(saved)):
        e, b = saved[k]
        a = (spec, tab, desc, e["o"], e["d"], e["thr"], e["aux"], u_p[k], b,
             *cot, g_rad)
        live_k, _ = check_binning(spec, fused, b, f"step[{k}]")
        ms = device_ms(lambda: fused.fused_bounce_bwd(*a))
        bin_ms = device_ms(lambda: fused.bin_live_lanes(spec, b))
        by_bounce.append(dict(
            bounce=k, live=live_k, ms=ms, kernel_ms=ms - bin_ms, bin_ms=bin_ms,
            fwd_ms=device_ms(lambda: fused.fused_bounce_fwd(
                spec, tab, desc, e, u_p[k]))))
    # no lane alive: the pass-through alone
    e, b = saved[0]
    dead = torch.zeros_like(b)
    pass_through_ms = device_ms(lambda: fused.fused_bounce_bwd(
        spec, tab, desc, e["o"], e["d"], e["thr"], e["aux"], u_p[0], dead,
        *cot, g_rad))

    stages = dict(
        tables_ms=stage_ms(lambda: (
            fused.scene_tables(scene, cfg, general=True),
            fused.pack_tabvec(diff_scene, spec))),
        uniforms_ms=stage_ms(lambda: torch.rand(
            (cfg.max_iters, n, fused.N_UNIFORMS), device="cuda")),
        pack_ms=stage_ms(lambda: (
            T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype),
            fused.pack_state(state), fused.pack_u(u_fixed))),
        forward_multi_ms=stage_ms(
            lambda: fused.fused_span_fwd(spec, tab, desc, st, u_p)),
        backward_multi_ms=stage_ms(lambda: fused.fused_span_bwd(
            spec, tab, desc, st, u_p, bits, *cot, g_rad)),
        forward_perbounce_ms=stage_ms(per_fwd),
        backward_perbounce_ms=stage_ms(per_bwd),
        pack_tabvec_backward_ms=stage_ms(lambda: torch.autograd.grad(
            tab_g, leaves, g_tab, retain_graph=True, allow_unused=True)))

    # the forward render_batch again, now that the tables are kept
    def fwd_wall():
        gen = torch.Generator(device="cuda").manual_seed(7)
        T.render_batch(scene, cfg, o, d, gen)
    forward_wall_ms = stage_ms(fwd_wall)

    faster = min(walls, key=walls.get)
    if T.tracer.wavefront.DIFF_SPAN != faster:
        print(f"chip_smoke: note: the default differentiable span mode is "
              f"{T.tracer.wavefront.DIFF_SPAN!r}, {faster!r} was faster in "
              f"this run", file=sys.stderr, flush=True)
    emit("step", rays=n, bins=bins, max_depth=cfg.max_depth,
         max_iters=cfg.max_iters, spectral_dtype=cfg.spectral_dtype,
         loss=float(runs["multi"][0]), launches=launches, euler=euler,
         route_deviation=route_dev,
         grad_max={f: float(g.abs().max()) for f, g in runs["multi"][1].items()},
         segments=segments,
         wall_ms={k: v * 1e3 for k, v in walls.items()},
         segments_per_step_s={k: segments / v for k, v in walls.items()},
         faster=faster, default=T.tracer.wavefront.DIFF_SPAN,
         peak_bytes=peak, stages=stages, bounce_bwd_by_bounce=by_bounce,
         bounce_bwd_sum_ms=sum(r["ms"] for r in by_bounce),
         bounce_bwd_pass_through_ms=pass_through_ms,
         forward_render_batch_wall_ms=forward_wall_ms)
    return launches


def bound(nbytes, f32_ops, int_ops=0):
    """The least time of a kernel: bytes over the memory rate against its
    f32 operations over the f32 rate and its integer operations over the
    integer rate (separate pipes; the busier one bounds)."""
    t = dict(bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
             f32_ms=f32_ops / F32_FLOPS * 1e3,
             int32_ms=int_ops / INT32_OPS * 1e3)
    ops = max(t["f32_ms"], t["int32_ms"])
    return dict(t, bound_ms=max(t["bytes_ms"], ops),
                bound_by="bytes" if t["bytes_ms"] >= ops else "operations",
                operations_type="f32" if t["f32_ms"] >= t["int32_ms"] else "int32")


def bitwise_equal(a, b):
    """Packed states or tensors equal bit for bit (-0 and NaN included)."""
    if isinstance(a, dict):
        return all(bitwise_equal(a[k], b[k]) for k in a)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def run_ms(fn):
    """(result, milliseconds) of one call of ``fn()`` by CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def krng_case(name, world, bins, cfg, o, d, seed, T, fused, against_plain):
    """The kernel-RNG branch of fused_span_fwd (K3) and fused_span_bwd (K4)
    on one scene: each with ``seed=`` against the same kernel fed the plain
    generator's uniforms of the same seed (bit for bit: this holds the
    device's Philox to ``philox_uniforms``), K4's replay against K3, the
    counter offset of a span that starts later, and (``against_plain``) each
    against its plain version, with times and bounds beside the host-RNG
    branch's."""
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, bins))
    n, n_steps = o.shape[0], cfg.max_iters
    key = torch.tensor(seed, dtype=torch.int32, device="cuda")
    st0 = fused.pack_state(T.init_rays(o, d, bins))
    res = {}

    # --- K3 on the forward tables
    spec, entry = fused.scene_tables(scene, cfg)
    desc, tab = entry["desc"], fused.forward_table(scene, spec, entry)
    k_st, k_bits = fused.fused_span_fwd(spec, tab, desc, st0, seed=key,
                                        n_steps=n_steps)
    u_ref = fused.philox_uniforms(key, n, 0, n_steps)
    h_st, h_bits = fused.fused_span_fwd(spec, tab, desc, st0, u_ref)
    torch.cuda.synchronize()
    if not (bitwise_equal(k_st, h_st) and torch.equal(k_bits, h_bits)):
        fail(f"krng {name}: K3 with seed= differs from K3 fed "
             "philox_uniforms of the same seed")
    # a span that starts at bounce 5: the counter carries the absolute bounce
    s5, b5 = fused.fused_span_fwd(spec, tab, desc, st0, seed=key, start=5,
                                  n_steps=4)
    r5, c5 = fused.fused_span_fwd(
        spec, tab, desc, st0, fused.philox_uniforms(key, n, 5, 4))
    if not (bitwise_equal(s5, r5) and torch.equal(b5, c5)):
        fail(f"krng {name}: K3 with seed= and start=5 differs from the plain "
             "stream")
    segs = int((k_bits & 1).sum())
    entered = n + int(((k_bits[:-1] >> fused.B_ALIVENEXT) & 1).sum())
    row = dict(scene=name, n=n, bins=bins, n_steps=n_steps, segments=segs,
               entered=entered, equal_to_fed_kernel=True,
               equal_at_start_5=True)
    if against_plain:
        # the plain version on the card: the plain generator, then the plain
        # span (what the wrapper runs for CPU tensors)
        (p_st, p_bits), plain_ms = run_ms(lambda: fused.span_fwd_plain(
            spec, tab, st0, fused.philox_uniforms(key, n, 0, n_steps)))
        same = canon(k_bits) == p_bits
        agree = torch.cumprod(same.int(), 0).bool()[-1]
        dev = compare_state(k_st, p_st, agree, torus_lanes(spec, p_bits),
                            TORUS_SPAN)
        if not dev.pop("ok") or 1.0 - float(agree.float().mean()) > MAX_FLIP:
            fail(f"krng {name}: K3 (kernel RNG) against its plain version {dev}")
        ms = time_ms(lambda: fused.fused_span_fwd(
            spec, tab, desc, st0, seed=key, n_steps=n_steps), 5)
        host_ms = time_ms(lambda: fused.fused_span_fwd(
            spec, tab, desc, st0, u_ref), 5)
        state_bytes = 4 * n * (8 + 2 * bins)
        table_bytes = 4 * (tab.numel() + desc.numel())
        row.update(dev, diverged=1.0 - float(agree.float().mean()), ms=ms,
                   host_rng_ms=host_ms, plain_ms=plain_ms,
                   **bound(table_bytes + 2 * state_bytes + 4 * n_steps * n,
                           segs * fused.bounce_flops(spec),
                           entered * fused.PHILOX_OPS))
    res["fused_span_fwd"] = row

    # --- K4 on the general tables, as the step traces
    spec, entry = fused.scene_tables(scene, cfg, general=True)
    desc = entry["desc"]
    with torch.no_grad():
        tab = fused.pack_tabvec(scene, spec)
    g_st, g_bits = fused.fused_span_fwd(spec, tab, desc, st0, seed=key,
                                        n_steps=n_steps)
    rng = np.random.RandomState(seed[0] % 1000)
    cots = [torch.as_tensor(rng.standard_normal((r, n)).astype(np.float32)).cuda()
            for r in (3, 3, bins, bins)]
    cot_scale = float(max(c.abs().max() for c in cots))
    st4 = {k: st0[k] for k in ("o", "d", "thr", "aux")}
    got = fused.fused_span_bwd(spec, tab, desc, st4, None, g_bits, *cots,
                               return_replay=True, seed=key)
    fed = fused.fused_span_bwd(spec, tab, desc, st4, u_ref, g_bits, *cots,
                               return_replay=True)
    torch.cuda.synchronize()
    want = torch.cat([g_st["o"], g_st["d"], g_st["thr"], g_st["aux"]])
    if not bitwise_equal(got[4], want):
        fail(f"krng {name}: K4's replay (kernel RNG) does not end in K3's "
             "state bit for bit")
    if not all(bitwise_equal(a, b) for a, b in zip(got[:3], fed[:3])):
        fail(f"krng {name}: K4 with seed= differs from K4 fed the same "
             "uniforms on the state cotangents")
    tab_fed, ok_fed = compare_table(spec, fused, got[3], fed[3])
    if not ok_fed:
        fail(f"krng {name}: K4 with seed= against K4 fed the same uniforms: "
             f"table cotangent {tab_fed}")
    live = int((g_bits != 0).sum())
    entered = n + int(((g_bits[:-1] >> fused.B_ALIVENEXT) & 1).sum())
    row = dict(scene=name, n=n, bins=bins, n_steps=n_steps, live=live,
               entered=entered, replay_equal=True, equal_to_fed_kernel=True,
               table_vs_fed_kernel=tab_fed)
    if against_plain:
        ref, plain_ms = run_ms(lambda: fused.span_bwd_plain(
            spec, tab, st4, fused.philox_uniforms(key, n, 0, n_steps), g_bits,
            *cots))
        every = torch.ones(n, dtype=torch.bool, device="cuda")
        vs_plain = compare_cots(got[:3], ref[:3], every, cot_scale)
        tab_plain, ok_plain = compare_table(spec, fused, got[3], ref[3])
        if vs_plain["beyond"] > MAX_FLIP or not ok_plain:
            fail(f"krng {name}: K4 (kernel RNG) against its plain version "
                 f"{vs_plain} table {tab_plain}")
        row.update(vs_plain=vs_plain, table_vs_plain=tab_plain,
                   max_abs=vs_plain["max_abs"], plain_ms=plain_ms)
    # K4 under both uniform sources, on every scene
    args = (spec, tab, desc, st4)
    ms = time_ms(lambda: fused.fused_span_bwd(
        *args, None, g_bits, *cots, seed=key), 3)
    host_ms = time_ms(lambda: fused.fused_span_bwd(
        *args, u_ref, g_bits, *cots), 3)
    table_bytes = 4 * (2 * tab.numel() + desc.numel())
    nbytes = table_bytes + 4 * n * ((8 + bins) + (6 + 2 * bins) + (6 + bins)) \
        + 4 * entered * (1 + 2 * (8 + bins))
    row.update(ms=ms, host_rng_ms=host_ms,
               **bound(nbytes, live * (fused.bounce_bwd_flops(spec)
                                       + fused.bounce_flops(spec)),
                       (entered + live) * fused.PHILOX_OPS))
    res["fused_span_bwd"] = row
    return res


def phase_krng(T, fused, scenes):
    """The kernel RNG on the flagship: K3 and K4 with ``seed=`` against the
    plain generator and their plain versions, the zoo scene as a correctness
    input, the furnace, the estimator's mean, and ``render_batch`` and the
    training step with ``rng="kernel"`` beside ``rng="host"``."""
    from source_tpu_torch.optical.material.base import MAT_EMITTER
    bins = FLAGSHIP["bins"]
    scene, cfg, o, d, _u_fixed, _same_u = flagship(T, fused, scenes)
    n = o.shape[0]
    flag = krng_case("cornell", scenes.cornell_box(glass=True), bins, cfg,
                     o, d, (0x5EED, -77), T, fused, True)
    zo, zd = scenes.scatter_rays(N_ZOO, seed=1)
    zoo = krng_case("zoo", scenes.zoo(), 5,
                    T.RayConfig(max_depth=6, max_iters=24),
                    torch.as_tensor(zo).cuda(), torch.as_tensor(zd).cuda(),
                    (31, 4), T, fused, False)

    # the furnace: exactly 1.0 with the kernel's own stream
    fscene = T.compile_scene(scenes.furnace(), T.SpectralConfig(375.0, 740.0, 15))
    fd = np.random.RandomState(2).normal(size=(65536, 3)).astype(np.float32)
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    fst = T.render_batch(fscene, T.RayConfig(max_iters=4),
                         np.zeros((65536, 3), np.float32), fd,
                         torch.Generator(device="cuda").manual_seed(3),
                         rng="kernel")
    if not bool((fst.radiance == 1.0).all()) or int(fst.segments) != 65536:
        fail("krng: furnace radiance is not exactly 1.0 with rng='kernel'")

    # the estimator's mean: kernel against host stream, MIS on against off
    o_s, d_s = o[::4].contiguous(), d[::4].contiguous()
    runs = {}
    for rng, mis in (("kernel", True), ("host", True), ("kernel", False)):
        c = T.RayConfig(max_depth=16, max_iters=24, importance_sampling=mis)
        gen = torch.Generator(device="cuda").manual_seed(9)
        runs[rng, mis] = T.render_batch(scene, c, o_s, d_s, gen,
                                        rng=rng).radiance.t()
    means = {}
    for what, a, b in (("kernel_vs_host", ("kernel", True), ("host", True)),
                       ("mis_on_vs_off", ("kernel", True), ("kernel", False))):
        diff, se, ok = mean_within(runs[a], runs[b], n_sigma=4.0)
        means[what] = dict(diff=diff, standard_error=se)
        if not ok:
            fail(f"krng: {what} means differ by {diff} (standard error {se})")

    # forward render_batch of the flagship: launches, wall, peak memory
    fwd = {}
    for rng in ("kernel", "host"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        st = T.render_batch(scene, cfg, o, d,
                            torch.Generator(device="cuda").manual_seed(7),
                            rng=rng)
        torch.cuda.synchronize()
        counts = read_counts(fused)
        if counts != dict(NO_LAUNCHES, fused_span_fwd=1):
            fail(f"krng: render_batch(rng={rng!r}) must launch fused_span_fwd "
                 f"once and nothing else: {counts}")
        rad = st.radiance.float()
        if tuple(rad.shape) != (n, bins) or not bool(torch.isfinite(rad).all()):
            fail(f"krng: render_batch(rng={rng!r}) radiance has the wrong "
                 "shape or is not finite")
        peak = torch.cuda.max_memory_allocated() - base
        walls, segs = [], 0
        gen = torch.Generator(device="cuda").manual_seed(7)
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = T.render_batch(scene, cfg, o, d, gen, rng=rng)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            segs = int(st.segments)
        wall = float(np.median(walls[1:]))
        fwd[rng] = dict(launches=counts, wall_ms=wall * 1e3, segments=segs,
                        segments_per_s=segs / wall, peak_bytes=peak)

    # the training step: kernel RNG on the whole-span route against the
    # host RNG on the whole-span route and the default per-bounce route
    target = torch.zeros((n, bins), device="cuda")
    emit_rows = [m for m, t in enumerate(scene.mat_types) if t == MAT_EMITTER]
    want = {"kernel": dict(NO_LAUNCHES, fused_span_fwd=1, fused_span_bwd=1),
            "host_multi": dict(NO_LAUNCHES, fused_span_fwd=1, fused_span_bwd=1),
            "host_perbounce": dict(NO_LAUNCHES, fused_bounce_fwd=cfg.max_iters,
                                   fused_bounce_bwd=cfg.max_iters,
                                   bin_live_lanes=cfg.max_iters)}
    kw = {"kernel": dict(rng="kernel"), "host_multi": dict(span="multi"),
          "host_perbounce": dict(span="perbounce")}
    step = {}
    for route, args in kw.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        loss, grads = T.render_loss_and_grads(
            scene, cfg, o, d, target,
            torch.Generator(device="cuda").manual_seed(7), **args)
        torch.cuda.synchronize()
        counts = read_counts(fused)
        peak = torch.cuda.max_memory_allocated() - base
        if counts != want[route]:
            fail(f"krng: step[{route}] launches {counts}, want {want[route]}")
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            fail(f"krng: step[{route}] gradient is not finite")
        lhs = float(sum((scene.mat_spectra[m, 0] * grads["mat_spectra"][m, 0])
                        .sum() for m in emit_rows))
        euler = lhs / (2.0 * float(loss))
        if abs(euler - 1.0) > EULER_TOL:
            fail(f"krng: step[{route}] Euler identity on the emission rows: "
                 f"{euler}")
        walls = []
        for _ in range(6):
            gen = torch.Generator(device="cuda").manual_seed(7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.render_loss_and_grads(scene, cfg, o, d, target, gen, **args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step[route] = dict(launches=counts, euler=euler, loss=float(loss),
                           wall_ms=float(np.median(walls[1:])) * 1e3,
                           peak_bytes=peak)

    emit("krng", rays=n, bins=bins, max_iters=cfg.max_iters,
         philox_ops_per_ray_bounce=fused.PHILOX_OPS,
         int32_ops_per_s=INT32_OPS,
         fused_span_fwd=[flag["fused_span_fwd"], zoo["fused_span_fwd"]],
         fused_span_bwd=[flag["fused_span_bwd"], zoo["fused_span_bwd"]],
         furnace_exact=True, means=means, render_batch=fwd, step=step,
         host_uniform_bytes=4 * cfg.max_iters * n * fused.N_UNIFORMS)
    return dict(flag, forward_launches=fwd["kernel"]["launches"],
                step_launches=step["kernel"]["launches"])


def sass_counts(lib_path, kernel):
    """Global loads and stores in the SASS of ``kernel`` in a built library,
    by cuobjdump; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    counts, inside = dict(ldg=0, stg=0), False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            counts["ldg"] += " LDG" in ln
            counts["stg"] += " STG" in ln
    return counts


def phase_fusedprof(T, fused, scenes):
    """The flagship's per-bounce route over its 24 bounces, three ways: the
    chain of fused_bounce_fwd (K1), of fused_bounce_replay (K9) replaying
    K1's bitfields, and of fused_bounce_io (K10). K9 must equal K1 bit for
    bit at every bounce and its plain version within the kernels'
    tolerances, K10 its input. Per bounce the median time of each: K1 - K9
    is the decision path, K9 - K10 the arithmetic, K10 the load/store and
    launch floor."""
    bins = FLAGSHIP["bins"]
    scene, cfg, o, d, u_fixed, _same_u = flagship(T, fused, scenes)
    n = o.shape[0]
    spec, entry = fused.scene_tables(scene, cfg)
    desc, tab = entry["desc"], fused.forward_table(scene, spec, entry)
    st0 = fused.pack_state(T.init_rays(o, d, bins,
                                       spectral_dtype=cfg.spectral_dtype))
    u_p = fused.pack_u(u_fixed)

    # the three chains, each kernel's counts set to 0 just before and read
    # just after
    reset_counts(fused)
    states, bits = [st0], []
    for u in u_p:
        new, b = fused.fused_bounce_fwd(spec, tab, desc, states[-1], u)
        states.append(new)
        bits.append(b)
    replayed = [st0]
    for k, u in enumerate(u_p):
        replayed.append(fused.fused_bounce_replay(spec, tab, desc, replayed[-1],
                                                  u, bits[k]))
    io = [st0]
    io_bits = []
    for u in u_p:
        new, b = fused.fused_bounce_io(spec, tab, desc, io[-1], u)
        io.append(new)
        io_bits.append(b)
    torch.cuda.synchronize()
    counts = read_counts(fused)
    want = dict(NO_LAUNCHES, fused_bounce_fwd=cfg.max_iters,
                fused_bounce_replay=cfg.max_iters,
                fused_bounce_io=cfg.max_iters)
    if counts != want:
        fail(f"fusedprof: launches {counts}, want {want}")
    for k in range(cfg.max_iters):
        if not bitwise_equal(replayed[k + 1], states[k + 1]):
            fail(f"fusedprof: K9 differs from K1 at bounce {k}")
        if not bitwise_equal(io[k + 1], st0) or bool(io_bits[k].any()):
            fail(f"fusedprof: K10 does not return its input at bounce {k}")

    # K9 and K10 against their plain versions at every bounce
    worst = dict(max_abs=0.0, max_rel=0.0)
    every = torch.ones(n, dtype=torch.bool, device="cuda")
    none = torch.zeros(n, dtype=torch.bool, device="cuda")
    plain_ms = dict(replay=[], io=[])
    for k, u in enumerate(u_p):
        ref, ms = run_ms(lambda: fused.bounce_replay_plain(
            spec, tab, states[k], u, bits[k]))
        plain_ms["replay"].append(ms)
        dev = compare_state(replayed[k + 1], ref, every, none, TORUS_BOUNCE)
        if not dev.pop("ok") or not torch.equal(replayed[k + 1]["aux"],
                                                ref["aux"]):
            fail(f"fusedprof: K9 against bounce_core replay at bounce {k}: {dev}")
        worst = {m: max(worst[m], dev[m]) for m in worst}
        (io_ref, io_ref_bits), ms = run_ms(lambda: fused.bounce_io_plain(
            spec, tab, states[k], u))
        plain_ms["io"].append(ms)
        got, got_bits = fused.fused_bounce_io(spec, tab, desc, states[k], u)
        if not (bitwise_equal(got, io_ref) and torch.equal(got_bits, io_ref_bits)):
            fail(f"fusedprof: K10 against its plain version at bounce {k}")

    # per-bounce device times, the three kernels in turns on the same state;
    # K1 also as the kernels phase times it (back-to-back launches, the host
    # enqueueing while the card runs), to show what the host's pace adds
    per = dict(k1=[], k9=[], k10=[], k1_host_paced=[])
    for k, u in enumerate(u_p):
        st, b = states[k], bits[k]
        per["k1"].append(device_ms(
            lambda: fused.fused_bounce_fwd(spec, tab, desc, st, u)))
        per["k9"].append(device_ms(
            lambda: fused.fused_bounce_replay(spec, tab, desc, st, u, b)))
        per["k10"].append(device_ms(
            lambda: fused.fused_bounce_io(spec, tab, desc, st, u)))
        per["k1_host_paced"].append(time_ms(
            lambda: fused.fused_bounce_fwd(spec, tab, desc, st, u), 20))
    med = {k: float(np.median(v)) for k, v in per.items()}
    alive = [int((s["aux"][0] > 0.5).sum()) for s in states[:-1]]
    segs = [int((b & 1).sum()) for b in bits]
    state_bytes = 4 * n * (8 + 2 * bins)
    table_bytes = 4 * (tab.numel() + desc.numel())
    # bounds at the first bounce, where every ray is alive
    b9 = bound(table_bytes + 2 * state_bytes + 4 * n
               + 4 * fused.N_UNIFORMS * alive[0],
               segs[0] * fused.bounce_flops(spec, replay=True))
    b10 = bound(table_bytes + 2 * state_bytes + 4 * n
                + 4 * fused.N_UNIFORMS * alive[0], 0)
    b1 = bound(table_bytes + 2 * state_bytes + 4 * n
               + 4 * fused.N_UNIFORMS * alive[0],
               segs[0] * fused.bounce_flops(spec))
    sass = sass_counts(fused.build_library(bins)[0], "k_bounce_io")
    if sass is not None and (sass["ldg"] < 8 + 2 * bins + fused.N_UNIFORMS
                             or sass["stg"] < 8 + 2 * bins + 1):
        fail(f"fusedprof: K10's SASS has fewer global loads or stores than "
             f"the state and uniforms need: {sass}")
    rows = {
        "fused_bounce_replay": dict(
            max_abs=worst["max_abs"], max_rel=worst["max_rel"],
            ms=per["k9"][0], ms_median_over_bounces=med["k9"],
            plain_ms=plain_ms["replay"][0], **b9),
        "fused_bounce_io": dict(
            max_abs=0.0, ms=per["k10"][0], ms_median_over_bounces=med["k10"],
            plain_ms=plain_ms["io"][0], **b10),
    }
    emit("fusedprof", rays=n, bins=bins, bounces=cfg.max_iters,
         launches=counts, k9_equals_k1=True, k10_identity=True,
         per_bounce_ms=per, alive=alive, segments=segs,
         median_ms=med, decision_ms=med["k1"] - med["k9"],
         arithmetic_ms=med["k9"] - med["k10"], floor_ms=med["k10"],
         k1_bound_ms=b1["bound_ms"], k1_bound_by=b1["bound_by"],
         k10_sass=sass, kernels=rows)
    return dict(rows=rows, launches=counts)


def min_advance(o):
    """intersect_scene's minimum advance per ray."""
    return 1e-4 * torch.clamp(torch.amax(torch.abs(o), dim=-1), min=1.0)


def bvh_case(name, scene, o, d, sort_rays, bvh):
    """Hold the analytic-BVH kernel against its specification (the threaded
    walk, ``analytic_bvh_winner_plain``) and against its own walk in torch
    (``pruned_walk_plain``) on one input; returns the measurements: the
    kernel's device time (``device_ms``, median), the wrapper's (by CUDA
    events, at the host's pace) and the specification's, the work of the two
    walks per ray in the order the kernel walks the rays (mean, p99, max,
    mean over 32-lane warps of the warp's largest), and the bound.

    The bound is the less work of the two walks, which compute the same
    function, bytes and operations each: the rays in and the records out,
    with the threaded walk's tables or the kernel's packed rows read once
    each; ``NODE_OPS`` a node visit, ``ITEM_BOX_OPS`` an item box test (the
    pruned walk), ``ITEM_OPS`` an item tested by its kind and
    ``CSG_CHILD_OPS`` a CSG child evaluated (``bound_walks``)."""
    tables, meta = scene.leaf_bvh, scene.leaf_bvh_meta
    eps = min_advance(o)
    N = o.shape[0]
    k = bvh.winner_records(tables, meta, o, d, eps, sort_rays)
    torch.cuda.synchronize()
    p = bvh.analytic_bvh_winner_plain(tables, meta, o, d, eps)
    same = torch.ones(N, dtype=torch.bool, device="cuda")
    for key in ("leaf", "entity", "inside", "crossing_hi"):
        same &= k[key] == p[key]
    flip = 1.0 - float(same.float().mean())
    hit = p["leaf"] >= 0
    leaf_type = torch.zeros(scene.n_leaves, dtype=torch.int64, device="cuda")
    for tid, a, b in scene.type_slices:
        leaf_type[a:b] = tid
    torus = hit & (leaf_type[p["leaf"].clamp(min=0).long()] == 5)
    dt = (k["t"] - p["t"]).abs()
    dn = (k["normal"] - p["normal"]).abs().amax(1)
    strict = same & hit & ~torus
    res = dict(scene=name, n=N, sort_rays=sort_rays, hit=float(hit.float().mean()),
               flip=flip, max_abs=0.0, torus_lanes=int(torus.sum()),
               torus_abs=0.0, torus_beyond=0.0)
    ok = flip <= MAX_FLIP
    if bool(strict.any()):
        res["max_abs"] = max(float(dt[strict].max()), float(dn[strict].max()))
        ok &= bool((dt[strict] <= ATOL + RTOL * p["t"][strict].abs()).all())
        ok &= bool((dn[strict] <= ATOL + RTOL).all())
    loose = same & torus
    if bool(loose.any()):
        # torus lanes beside a float64 evaluation of the plain version: the
        # f32 quartic is ill-conditioned near grazing hits (ROADMAP queue 3),
        # so kernel and plain version are each held to it, not to each other
        tab64 = {t: tables[t].double() for t in ("nodes", "leaves", "csg")}
        p64 = bvh.analytic_bvh_winner_plain(
            tab64, meta, o[loose].double(), d[loose].double(),
            eps[loose].double())
        on = p64["leaf"] == p["leaf"][loose]
        t64 = p64["t"][on]
        lim = ATOL + RTOL * t64.abs()
        k_dev = (k["t"][loose][on].double() - t64).abs()
        p_dev = (p["t"][loose][on].double() - t64).abs()
        res.update(torus_abs=float(dt[loose].max()),
                   torus_beyond=float((dt[loose] > ATOL + RTOL * p["t"][loose].abs())
                                      .float().mean()),
                   torus_kernel_vs_f64=float(k_dev.max()),
                   torus_plain_vs_f64=float(p_dev.max()),
                   torus_kernel_beyond_f64=float((k_dev > lim).double().mean()),
                   torus_plain_beyond_f64=float((p_dev > lim).double().mean()))
        ok &= (res["torus_kernel_vs_f64"]
               <= F64_FACTOR * res["torus_plain_vs_f64"] + ATOL)
        ok &= (res["torus_kernel_beyond_f64"]
               <= F64_FACTOR * res["torus_plain_beyond_f64"] + 1.0 / int(on.sum()))
    if not ok or not bool(torch.isfinite(k["normal"]).all()):
        fail(f"{name} analytic_bvh_winner: kernel against plain version {res}")
    # the kernel alone, on the rays in the order it walks them, against its
    # own walk in torch: winners and flags equal on every lane where none of
    # the three chose a torus, t and normal within RTOL/ATOL there
    if sort_rays and N > bvh._TILE:
        order = bvh._coherence_order(o, d, meta[3], meta[4])
    else:
        order = torch.arange(N, device="cuda")
    o_k, d_k, e_k = o[order], d[order], eps[order]
    rec = bvh.bvh_records(tables, meta)
    kw = bvh._launch(tables, meta, o_k, d_k, e_k)
    w = bvh.pruned_walk_plain(rec, o_k, d_k, e_k)
    agree = torch.ones(N, dtype=torch.bool, device="cuda")
    for key in ("leaf", "entity", "inside", "crossing_hi"):
        agree &= kw[key] == w[key]
    i32 = torch.int32
    bit_equal = (agree & (kw["t"].view(i32) == w["t"].view(i32))
                 & (kw["normal"].view(i32) == w["normal"].view(i32)).all(1))
    off_torus = ~torus[order]
    for x in (kw, w):
        off_torus &= ~((x["leaf"] >= 0)
                       & (leaf_type[x["leaf"].clamp(min=0).long()] == 5))
    on = off_torus & agree & (w["leaf"] >= 0)
    dtw = (kw["t"] - w["t"]).abs()
    dnw = (kw["normal"] - w["normal"]).abs().amax(1)
    res["against_walk"] = dict(
        differs=int((~agree).sum()), differs_off_torus=int((~agree & off_torus).sum()),
        not_bit_equal=int((~bit_equal).sum()),
        max_abs=max(float(dtw[on].max()), float(dnw[on].max())) if bool(on.any()) else 0.0)
    if (res["against_walk"]["differs_off_torus"]
            or not bool((dtw[on] <= ATOL + RTOL * w["t"][on].abs()).all())
            or not bool((dnw[on] <= ATOL + RTOL).all())):
        fail(f"{name} analytic_bvh_winner: kernel against pruned_walk_plain {res}")
    ms = device_ms(lambda: bvh._launch(tables, meta, o_k, d_k, e_k), 20)
    wrapper_ms = time_ms(lambda: bvh.winner_records(tables, meta, o, d, eps,
                                                    sort_rays), 20)
    plain_ms = time_ms(lambda: bvh.analytic_bvh_winner_plain(
        tables, meta, o, d, eps), 1)
    io_bytes = 4 * N * (7 + 8)

    def times(nbytes, ops):
        return dict(bytes_ms=(io_bytes + nbytes) / HBM_BYTES_PER_S * 1e3,
                    operations_ms=ops / F32_FLOPS * 1e3)

    def walk_ops(walk):
        kinds = walk["kind_tests"].tolist()
        return (NODE_OPS * int(walk["nodes_visited"].sum())
                + sum(ITEM_OPS[i] * kinds[i] for i in ITEM_OPS)
                + CSG_CHILD_OPS * int(walk["csg_children"].sum()))

    walks = dict(
        threaded=times(4 * sum(tables[t].numel() for t in ("nodes", "leaves", "csg")),
                       walk_ops(p)),
        pruned=times(4 * sum(x.numel() for x in (rec.nodes, rec.items, rec.children)),
                     walk_ops(w) + ITEM_BOX_OPS * int(w["box_tests"].sum())))
    t_bytes = min(x["bytes_ms"] for x in walks.values())
    t_ops = min(x["operations_ms"] for x in walks.values())
    res.update(
        ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops, bound_walks=walks,
        work=dict(
            threaded={key: fetch_stats(p[key][order]) for key in
                      ("nodes_visited", "items_visited", "csg_children")},
            pruned={key: fetch_stats(w[key]) for key in
                    ("nodes_visited", "box_tests", "items_visited",
                     "csg_children")}),
        item_tests_by_kind=dict(threaded=p["kind_tests"].tolist(),
                                pruned=w["kind_tests"].tolist()),
        n_nodes=int(meta[0]), records_bytes=rec.nbytes)
    return res


def csg_setup(T, scenes):
    """The CSG demo, its ray configuration and its 512x512 camera rays."""
    scene = T.compile_scene(scenes.csg_world(),
                            T.SpectralConfig(375.0, 740.0, CSG["bins"]))
    cfg = T.RayConfig(
        max_depth=CSG["max_depth"], extinction_prob=CSG["extinction_prob"],
        extinction_min_depth=3, importance_sampling=True,
        important_path_weight=0.25, max_iters=CSG["max_iters"],
        compact_schedule=CSG["compact_schedule"], spectral_dtype="float32")
    o, d = scenes.camera_rays(CSG["width"], CSG["height"], CSG["fov"],
                              CSG["position"])
    return scene, cfg, torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()


def phase_bvh_kernels(T, bvh, scenes):
    from source_tpu_torch.tracer.wavefront import trace_step
    scene, cfg, o, d = csg_setup(T, scenes)
    # the CSG demo's rays as intersect_scene hands them to the kernel: its
    # 7 BVH items are below the 64 at which intersect_scene sorts the rays
    sort = len(scene.bvh_leaf_ids) >= 64
    camera = bvh_case("csg_camera", scene, o, d, sort, bvh)
    # the rays of the third bounce: two wavefront bounces on, dead lanes
    # parked as trace_step parks them
    st = T.init_rays(o, d, CSG["bins"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for _ in range(2):
            u = torch.rand((o.shape[0], 10), generator=gen, device="cuda")
            st = trace_step(scene, cfg, st, u, differentiable=False)
    park = torch.full((1, 3), 3.0e7, device="cuda")
    o2 = torch.where(st.alive[:, None], st.origin, park).contiguous()
    bounce = bvh_case("csg_bounce2", scene, o2, st.direction.contiguous(), sort,
                      bvh)
    bounce["alive"] = int(st.alive.sum())
    field = T.compile_scene(scenes.leaf_field(), T.SpectralConfig(375.0, 740.0, 5))
    of, df = scenes.field_rays(N_FIELD, seed=6)
    deep = bvh_case("leaf_field", field, torch.as_tensor(of).cuda(),
                    torch.as_tensor(df).cuda(), True, bvh)
    emit("bvh_kernels", tolerance=dict(rtol=RTOL, atol=ATOL, max_flip=MAX_FLIP,
                                       f64_factor=F64_FACTOR),
         analytic_bvh_winner=[camera, bounce, deep])
    return camera


class StageClock:
    """Host milliseconds, synchronised on both sides, spent in the wrapped
    functions of one instrumented run: ``ms[stage]`` in all, and
    ``within[(outer, stage)]`` the part spent inside another wrapped stage."""

    def __init__(self):
        self.ms = {}
        self.within = {}
        self.undo = []
        self.open = []

    def wrap(self, module, name, stage):
        real = getattr(module, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            outer = self.open[-1] if self.open else None
            self.open.append(stage)
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            self.open.pop()
            self.ms[stage] = self.ms.get(stage, 0.0) + dt
            key = (outer, stage)
            self.within[key] = self.within.get(key, 0.0) + dt
            return out

        setattr(module, name, timed)
        self.undo.append((module, name, real))

    def restore(self):
        for module, name, real in reversed(self.undo):
            setattr(module, name, real)
        self.undo = []


def phase_wavefront(T, fused, scenes):
    from source_tpu_torch.tracer import intersect as I
    from source_tpu_torch.tracer import wavefront as W
    scene, cfg, o, d = csg_setup(T, scenes)
    n, bins = o.shape[0], CSG["bins"]
    if fused.scene_tables(scene, cfg) is not None:
        fail("wavefront: the CSG demo should be outside the fused route")

    # the main path: one render_batch, trace_step calls counted beside the
    # kernel launches
    steps = StageClock()
    calls = [0]
    real_step = W.trace_step

    def counting_step(*a, **kw):
        calls[0] += 1
        return real_step(*a, **kw)

    W.trace_step = counting_step
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        gen = torch.Generator(device="cuda").manual_seed(11)
        st = T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        launches = read_counts(fused)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        W.trace_step = real_step
    if launches != dict(NO_LAUNCHES, analytic_bvh_winner=calls[0]) or not (
            1 <= calls[0] <= cfg.max_iters):
        fail(f"wavefront: want one analytic_bvh_winner launch per traced "
             f"bounce ({calls[0]}) and nothing else: {launches}")
    rad = st.radiance
    if tuple(rad.shape) != (n, bins) or not bool(torch.isfinite(rad).all()):
        fail("wavefront: radiance has the wrong shape or is not finite")
    if not float(rad.mean()) > 0.0:
        fail("wavefront: no radiance reached the camera")

    walls, segs = [], 0
    gen = torch.Generator(device="cuda").manual_seed(12)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        segs = int(run.segments)
    wall = float(np.median(walls[1:]))

    # one instrumented run: where the wall time goes, stage by stage
    for module, name, stage in (
            (I, "analytic_bvh_winner", "bvh_kernel"),
            (W, "intersect_scene", "intersect"),
            (W, "_volume_interaction", "volume"),
            (W, "_surface_interaction", "surface"),
            (W, "_compact_lanes", "compaction")):
        steps.wrap(module, name, stage)
    try:
        gen = torch.Generator(device="cuda").manual_seed(12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        inst_ms = (time.perf_counter() - t0) * 1e3
    finally:
        steps.restore()
    stage = dict(steps.ms)
    stage["intersect_rest"] = stage.pop("intersect") - stage["bvh_kernel"]
    stage["other"] = inst_ms - sum(stage.values())

    # the route argument: the Cornell box, fused against wavefront route on
    # the same uniforms, f32 spectral state
    cb = T.compile_scene(scenes.cornell_box(glass=True),
                         T.SpectralConfig(375.0, 740.0, bins))
    cfg_c = T.RayConfig(max_depth=FLAGSHIP["max_depth"],
                        max_iters=FLAGSHIP["max_iters"])
    oc, dc = scenes.pinhole_rays(256, 256)
    oc, dc = torch.as_tensor(oc).cuda(), torch.as_tensor(dc).cuda()
    u_fix = torch.rand((cfg_c.max_iters, oc.shape[0], fused.N_UNIFORMS),
                       device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(13))

    def same_u(start, n_steps, n_lanes):
        return u_fix[start:start + n_steps, :n_lanes]

    by_fused = T.render_batch(cb, cfg_c, oc, dc, u_all=same_u)
    by_wave = T.render_batch(cb, cfg_c, oc, dc, u_all=same_u, route="wavefront")
    a, b = by_fused.radiance, by_wave.radiance
    beyond = float(((a - b).abs() > ATOL + RTOL * a.abs()).any(1).float().mean())
    r_diff, r_se, r_ok = mean_within(a, b)
    seg_dev = abs(int(by_wave.segments) - int(by_fused.segments)) / int(
        by_fused.segments)
    if beyond > MAX_FLIP or not r_ok or seg_dev > MAX_FLIP:
        fail(f"wavefront: route check on the Cornell box: {beyond} of lanes "
             f"beyond tolerance, means {r_diff} (se {r_se}), segments {seg_dev}")

    # MIS on against off on the CSG demo: the estimator's mean must not move
    # (its surfaces are glass and emitters, which do not sample the lights:
    # the two runs are then the same, and the check is reported as such)
    runs = {}
    for mis in (True, False):
        c = dataclasses.replace(cfg, importance_sampling=mis)
        gen = torch.Generator(device="cuda").manual_seed(14)
        runs[mis] = T.render_batch(scene, c, o[::4].contiguous(),
                                   d[::4].contiguous(), gen).radiance.t()
    diff, se, mis_ok = mean_within(runs[True], runs[False], n_sigma=4.0)
    if not mis_ok:
        fail(f"wavefront: MIS on/off means differ by {diff} (standard error {se})")

    emit("wavefront", rays=n, bins=bins, max_depth=cfg.max_depth,
         max_iters=cfg.max_iters, compact_schedule=cfg.compact_schedule,
         traced_bounces=calls[0], launches=launches,
         segments=int(st.segments), overflow=int(st.overflow),
         mean_radiance_per_bin=[round(float(x), 5) for x in rad.mean(0)],
         wall_ms=wall * 1e3, walls_ms=[w * 1e3 for w in walls[1:]],
         segments_per_s=segs / wall, instrumented_wall_ms=inst_ms,
         stages_ms=stage, peak_bytes=peak,
         route_check=dict(rays=oc.shape[0], beyond=beyond, mean_diff=r_diff,
                          mean_se=r_se, segments_rel_dev=seg_dev),
         mis_mean_diff=diff, mis_standard_error=se,
         mis_runs_identical=bool(torch.equal(runs[True], runs[False])))
    return launches


def median_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between its
    own pair of CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_ms(fn, reps=5):
    """Median device milliseconds of one ``fn()`` over ``reps`` calls, each
    between its own pair of CUDA events, with the card held busy
    (``torch.cuda._sleep``) while the host enqueues them all, so that the
    events time the kernels back to back and not the host's pace (a wrapper's
    checks and allocations take tens of microseconds, as long as a small
    kernel). The spin is lengthened until it outlasts the enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = 400_000 * reps
    for _ in range(6):
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(cycles)
        pairs = []
        t0 = time.perf_counter()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if e0.elapsed_time(pairs[0][0]) > host_ms:
            return float(np.median([a.elapsed_time(b) for a, b in pairs]))
        cycles *= 4
    fail("device_ms: the host did not get ahead of the card")


def mesh_local(mesh, o, d):
    """World rays in a mesh's local frame, the direction not renormalised
    (as intersect_scene hands them to the mesh kernel)."""
    from source_tpu_torch.core.math import batch as vmath
    return (vmath.transform_point(mesh.w2l[None], o).contiguous(),
            vmath.transform_vector(mesh.w2l[None], d).contiguous())


def tie_ulps(mesh, o, d, eps, lanes, tri_a, tri_b):
    """On ``lanes``, how many ulp apart the plain Woop test puts the t of two
    candidate triangles (a huge number where either is not a hit)."""
    from source_tpu_torch.tracer.watertight import woop_setup, woop_tri_test
    s = woop_setup(*o[lanes].unbind(1), *d[lanes].unbind(1))
    bits = []
    for tri in (tri_a, tri_b):
        abc = mesh.triangles.long()[tri.clamp(min=0).long()]
        vs = [mesh.vertices[abc[:, j], k] for j in range(3) for k in range(3)]
        t, _, _, _, valid = woop_tri_test(s, *vs, eps[lanes])
        t = torch.where(valid & (tri >= 0), t, float("inf"))
        bits.append(t.view(torch.int32).long())
    return (bits[0] - bits[1]).abs()


def mesh_parity(name, mesh, o, d, eps, mb, mt):
    """The mesh kernel (through its wrapper) against its plain version on the
    card: the lanes that choose another triangle (allowed only where the two
    candidates' t are equal to 1 ulp: a tie the strict t < t_best breaks by
    order), the largest deviations of t, u, v on the lanes that agree
    (MESH_RTOL / MESH_ATOL), front equal; and against the plain version of
    its own walk (``ordered_walk_plain``), t, tri, u, v and front equal bit
    for bit on every lane. Returns (result, kernel output, plain output,
    plain walk's output)."""
    N = o.shape[0]
    k = mb.mesh_bvh_winner(mesh, o, d, eps)
    torch.cuda.synchronize()
    p = mt.mesh_intersect_plain(mesh, o, d, eps)
    w = mb.ordered_walk_plain(mesh.records.current(mesh), o, d, eps)
    walk_differs = torch.zeros(N, dtype=torch.bool, device=o.device)
    for key in ("t", "tri", "u", "v", "front"):
        a, b = k[key], w[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        walk_differs |= a != b
    same = k["tri"] == p["tri"]
    lanes = torch.nonzero(~same).squeeze(1)
    tied = 0
    if lanes.numel():
        ulps = tie_ulps(mesh, o, d, eps, lanes, k["tri"][lanes], p["tri"][lanes])
        tied = int((ulps <= 1).sum())
    hit = same & (p["tri"] >= 0)
    res = dict(case=name, n=N, triangles=mesh.n_triangles, n_nodes=mesh.n_nodes,
               hit=float((p["tri"] >= 0).float().mean()),
               tri_differs=int(lanes.numel()), tri_differs_tied=tied,
               tri_differs_share=float(lanes.numel()) / N,
               front_equal=bool((k["front"] == p["front"])[same].all()),
               walk_differs=int(walk_differs.sum()))
    ok = (res["front_equal"] and tied == lanes.numel()
          and res["walk_differs"] == 0)
    for key in ("t", "u", "v"):
        dev = (k[key] - p[key]).abs()[hit]
        lim = MESH_ATOL + MESH_RTOL * p[key][hit].abs()
        res[f"max_abs_d{key}"] = float(dev.max()) if dev.numel() else 0.0
        ok &= bool((dev <= lim).all())
    if not ok or not bool(torch.isfinite(k["u"]).all()):
        fail(f"{name} mesh_bvh_winner: kernel against plain version {res}")
    return res, k, p, w


def fetch_stats(x):
    """Per-ray counts: mean, p99, the largest, and the mean over 32-lane
    warps of the warp's largest (a warp walks as long as its longest
    lane)."""
    x = x.float()
    warps = torch.nn.functional.pad(x, (0, -x.numel() % 32)).view(-1, 32)
    return dict(mean=float(x.mean()), p99=float(torch.quantile(x, 0.99)),
                max=float(x.max()), warp_max_mean=float(warps.amax(1).mean()))


def mesh_case(name, mesh, o, d, eps, mb, mt, orders=False):
    """mesh_parity, then the kernel's device time (``device_ms``, median),
    the wrapper's time (median by CUDA events, at the host's pace), the
    plain version's, visits per ray and the bound; with ``orders`` also the
    kernel on the rays in coherence order (``_coherence_order`` on the
    mesh's root box) and the sort itself.

    The bound is the less work of the two walks, which compute the same
    function: bytes, the rays in and the records out, and of the tables only
    the records this run's rays read, once each (the plain walks mark them):
    threaded, the nodes visited (36 B), the triangles tested (12 B) and
    their vertices (12 B); packed, the node rows (64 B, the root's 32) and
    the triangles tested (48 B); operations, ``MESH_RAY_OPS`` a ray,
    ``MESH_NODE_OPS`` a slab test (threaded: one a node visit; packed: one
    at the root, two a node row) and ``MESH_TRI_OPS`` a triangle tested.
    Each side takes the smaller of the two walks' counts (``bound_walks``).

    ``layouts``: per ray, the records each walk fetches and the triangles
    it tests, from the plain versions: the threaded walk over the SoA
    tables (a node visit fetches from five arrays, lo, hi, skip, first and
    count; a triangle its three vertex ids and three vertices) and the
    kernel's walk over the packed records (a node row, 64 B, or the root's
    half row; a leaf's triangles, 48 B each, in one range).
    ``requested_mb``: those fetches' bytes, each rounded up to 32-B sectors
    (threaded: 5 a node visit, at most, and 4 a triangle; packed: from
    ``ordered_walk_plain``), a reading of the traffic the walk asks of the
    memory system, not a bound."""
    from source_tpu_torch.tracer.analytic_bvh import _coherence_order
    res, _, p, w = mesh_parity(name, mesh, o, d, eps, mb, mt)
    N = o.shape[0]
    res["ms"] = device_ms(lambda: mb._launch(mesh, o, d, eps), 20)
    res["wrapper_ms"] = median_ms(lambda: mb.mesh_bvh_winner(mesh, o, d, eps), 20)
    if orders:
        def order():
            return _coherence_order(o, d, mesh.node_lo[0], mesh.node_hi[0])
        sort = order()
        o_s, d_s, e_s = o[sort], d[sort], eps[sort]
        res["sorted_ms"] = device_ms(lambda: mb._launch(mesh, o_s, d_s, e_s),
                                     20)
        res["sort_ms"] = median_ms(order, 20)
    res["plain_ms"] = run_ms(lambda: mt.mesh_intersect_plain(mesh, o, d, eps))[1]
    nv, tv = p["nodes_visited"].float(), p["tris_tested"].float()
    nodes = int(p["nodes_touched"].sum())
    tris = mesh.triangles[p["tris_touched"]]
    verts = int(torch.unique(tris).numel())
    rows, rec_tris = int(w["rows_touched"].sum()), int(w["tris_touched"].sum())
    io_bytes = 4 * N * (7 + 5)

    def times(nbytes, slab_tests, tris_tested):
        ops = (MESH_RAY_OPS * N + MESH_NODE_OPS * slab_tests
               + MESH_TRI_OPS * tris_tested)
        return dict(bytes_ms=(io_bytes + nbytes) / HBM_BYTES_PER_S * 1e3,
                    operations_ms=ops / F32_FLOPS * 1e3)

    walks = dict(
        # node: lo, hi (6 f32), skip, first, count (3 i32); triangle: 3 i32
        # vertex ids; vertex: 3 f32
        threaded=times(4 * (9 * nodes + 3 * tris.shape[0] + 3 * verts),
                       int(nv.sum()), int(tv.sum())),
        packed=times(64 * rows - 32 + 48 * rec_tris,
                     2 * int(w["node_fetches"].sum()) - N,
                     int(w["tris_tested"].sum())))
    t_bytes = min(x["bytes_ms"] for x in walks.values())
    t_ops = min(x["operations_ms"] for x in walks.values())
    rec = mesh.records.current(mesh)
    res.update(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops, bound_walks=walks,
        records_read=dict(nodes=nodes, triangles=int(tris.shape[0]),
                          vertices=verts, packed_rows=rows,
                          packed_triangles=rec_tris),
        nodes_per_ray=dict(mean=float(nv.mean()),
                           p99=float(torch.quantile(nv, 0.99))),
        tris_per_ray=dict(mean=float(tv.mean()),
                          p99=float(torch.quantile(tv, 0.99))),
        layouts=dict(
            threaded=dict(
                fetches=fetch_stats(nv + tv), tris_tested=fetch_stats(tv),
                requested_mb=32 * float((5 * nv + 4 * tv).sum()) / 1e6),
            packed=dict(
                fetches=fetch_stats(w["node_fetches"] + w["leaf_fetches"]),
                node_rows=fetch_stats(w["node_fetches"]),
                tris_tested=fetch_stats(w["tris_tested"]),
                requested_mb=32 * float(w["sectors"].double().sum()) / 1e6,
                records_mb=rec.nbytes / 1e6, depth=rec.depth)))
    return res


def mesh_setup(T, scenes, world=None, width=None, height=None,
               bins=MESH["bins"]):
    """A mesh world (the demo unless given), the demo's ray configuration
    and the demo camera's rays (512x384 unless given)."""
    scene = T.compile_scene(scenes.mesh_world() if world is None else world,
                            T.SpectralConfig(375.0, 740.0, bins))
    cfg = T.RayConfig(
        max_depth=MESH["max_depth"], extinction_prob=MESH["extinction_prob"],
        extinction_min_depth=3, importance_sampling=True,
        important_path_weight=0.25, max_iters=MESH["max_iters"],
        compact_schedule=MESH["compact_schedule"], spectral_dtype="float32")
    cam = dict(scenes.MESH_CAMERA)
    if width is not None:
        cam.update(width=width, height=height)
    o, d = scenes.camera_rays(**cam)
    return scene, cfg, torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()


def ball_rays(n, radius, rng):
    """``n`` rays from points uniform in a ball, directions uniform."""
    p = rng.normal(size=(n, 3))
    p *= (radius * rng.uniform(size=(n, 1)) ** (1.0 / 3.0)
          / np.linalg.norm(p, axis=1, keepdims=True))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


def phase_mesh_kernels(T, scenes):
    from source_tpu_torch.accel import bvh as accel_bvh
    from source_tpu_torch.primitive import MeshData
    from source_tpu_torch.tracer import mesh_bvh as mb
    from source_tpu_torch.tracer import meshtrace as mt
    from source_tpu_torch.tracer.wavefront import trace_step
    eye = np.eye(4)
    scene, cfg, o, d = mesh_setup(T, scenes)
    eps = min_advance(o)
    rows = {}
    # (a) the demo's camera rays against each mesh, in its local frame
    for slot, name in enumerate(("icosphere", "knot")):
        mesh = scene.meshes[slot]
        ol, dl = mesh_local(mesh, o, d)
        rows[f"camera_{name}"] = mesh_case(f"camera_{name}", mesh, ol, dl, eps,
                                           mb, mt)
    # (b) the live rays of the third traced bounce, dead lanes parked as
    # trace_step parks them
    st = T.init_rays(o, d, MESH["bins"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for _ in range(2):
            u = torch.rand((o.shape[0], 10), generator=gen, device="cuda")
            st = trace_step(scene, cfg, st, u, differentiable=False)
    park = torch.full((1, 3), 3.0e7, device="cuda")
    o2 = torch.where(st.alive[:, None], st.origin, park).contiguous()
    eps2 = min_advance(o2)
    for slot, name in enumerate(("icosphere", "knot")):
        mesh = scene.meshes[slot]
        ol, dl = mesh_local(mesh, o2, st.direction)
        rows[f"bounce2_{name}"] = mesh_case(f"bounce2_{name}", mesh, ol, dl,
                                            eps2, mb, mt)
        rows[f"bounce2_{name}"]["alive"] = int(st.alive.sum())
    # (c) icosphere(5): half the rays from inside, half scattered from outside
    rng = np.random.RandomState(21)
    ico5 = MeshData(*scenes.icosphere(5, 1.0), smoothing=True,
                    closed=True).to_tables(eye, eye, device="cuda")
    oi, di = ball_rays(N_ICO5 // 2, 0.9, rng)
    oo = rng.normal(size=(N_ICO5 // 2, 3))
    oo *= rng.uniform(1.5, 3.0, (N_ICO5 // 2, 1)) / np.linalg.norm(
        oo, axis=1, keepdims=True)
    do = ball_rays(N_ICO5 // 2, 1.2, rng)[0] - oo
    do /= np.linalg.norm(do, axis=1, keepdims=True)
    oc = torch.as_tensor(np.concatenate([oi, oo]), dtype=torch.float32).cuda()
    dc = torch.as_tensor(np.concatenate([di, do]), dtype=torch.float32).cuda()
    rows["icosphere5"] = mesh_case("icosphere5", ico5, oc, dc,
                                   min_advance(oc), mb, mt)
    # (d) the 1.31M-triangle icosphere of benchmarks/bigmesh.py, its rays
    # from (0, 0, -3) over a +-0.6 cone, sorted and unsorted
    t0 = time.perf_counter()
    big_data = MeshData(*scenes.icosphere(8, 1.0), smoothing=True, closed=True)
    build_s = time.perf_counter() - t0
    if accel_bvh._LIB is None:
        fail("mesh_kernels: the BVH was built by the numpy fallback, not "
             "csrc/bvh.cpp")
    big = big_data.to_tables(eye, eye, device="cuda")
    u = np.random.RandomState(0).uniform(size=(N_BIG, 2))
    db = np.stack([(u[:, 0] - 0.5) * 1.2, (u[:, 1] - 0.5) * 1.2,
                   np.ones(N_BIG)], axis=-1)
    db = torch.as_tensor(db / np.linalg.norm(db, axis=1, keepdims=True),
                         dtype=torch.float32).cuda()
    ob = torch.tensor([[0.0, 0.0, -3.0]], device="cuda").expand(N_BIG, 3)
    ob = ob.contiguous()
    rows["big"] = mesh_case("icosphere8", big, ob, db,
                            torch.zeros(N_BIG, device="cuda"), mb, mt,
                            orders=True)
    rows["big"]["bvh_build_s"] = build_s
    # (e) rays aimed at shared edges and vertices: no leak in either version
    leaks = {}
    for name, v, f, oe, de in scenes.watertight_cases():
        mesh = MeshData(v, f, smoothing=False, closed=True).to_tables(
            eye, eye, device="cuda")
        oe, de = torch.as_tensor(oe).cuda(), torch.as_tensor(de).cuda()
        res, k, p, _ = mesh_parity(name, mesh, oe, de,
                                   torch.zeros(oe.shape[0], device="cuda"),
                                   mb, mt)
        leaks[name] = dict(rays=oe.shape[0],
                           kernel=int((k["tri"] < 0).sum()),
                           plain=int((p["tri"] < 0).sum()),
                           tri_differs=res["tri_differs"],
                           walk_differs=res["walk_differs"])
        if leaks[name]["kernel"] or leaks[name]["plain"]:
            fail(f"mesh_kernels: rays aimed at edges and vertices leak: {leaks}")
    emit("mesh_kernels", tolerance=dict(rtol=MESH_RTOL, atol=MESH_ATOL,
                                        tie_ulps=1),
         mesh_bvh_winner=list(rows.values()),
         watertight=leaks)
    return rows


def phase_mesh_furnace(T, scenes):
    """Rays from inside a closed icosphere(5) that emits 1 W/m2/str/nm, on
    the wavefront route: every ray must return exactly 1.0 in every bin; a
    ray that leaks through the mesh returns 0."""
    from source_tpu_torch.optical.material import UnitySurfaceEmitter
    from source_tpu_torch.primitive import Mesh
    world = T.World()
    Mesh(*scenes.icosphere(5, 1.0), smoothing=True, closed=True, parent=world,
         material=UnitySurfaceEmitter())
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, 15))
    n = 65536
    o, d = ball_rays(n, 0.5, np.random.RandomState(2))
    gen = torch.Generator(device="cuda").manual_seed(3)
    st = T.render_batch(scene, T.RayConfig(max_iters=4), o, d, gen)
    exact = bool((st.radiance == 1.0).all())
    emit("mesh_furnace", rays=n, triangles=scene.meshes[0].n_triangles,
         exact=exact, segments=int(st.segments),
         min=float(st.radiance.min()), max=float(st.radiance.max()))
    if not exact or int(st.segments) != n:
        fail("mesh_furnace: radiance is not exactly 1.0 in every bin")


def phase_mesh(T, fused, scenes):
    from source_tpu_torch.tracer import intersect as I
    from source_tpu_torch.tracer import meshtrace as M
    from source_tpu_torch.tracer import wavefront as W
    scene, cfg, o, d = mesh_setup(T, scenes)
    n, bins = o.shape[0], MESH["bins"]
    if fused.scene_tables(scene, cfg) is not None:
        fail("mesh: the mesh demo should be outside the fused route")
    # per traced bounce: one launch per mesh in intersect_scene, and one
    # containment probe per closed mesh whose material is a volume (the
    # N-BK7 icosphere is a Beer-Lambert volume: _volume_interaction asks at
    # every bounce whether the segment's midpoint lies inside it)
    probes = sum(1 for v in scene.volume_entities
                 if v[5] >= 0 and scene.meshes[v[5]].closed)
    per_bounce = len(scene.meshes) + probes

    calls = [0]
    real_step = W.trace_step

    def counting_step(*a, **kw):
        calls[0] += 1
        return real_step(*a, **kw)

    W.trace_step = counting_step
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        gen = torch.Generator(device="cuda").manual_seed(11)
        st = T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        launches = read_counts(fused)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        W.trace_step = real_step
    want = dict(NO_LAUNCHES, analytic_bvh_winner=calls[0],
                mesh_bvh_winner=per_bounce * calls[0])
    if launches != want or not 1 <= calls[0] <= cfg.max_iters:
        fail(f"mesh: want per traced bounce ({calls[0]}) one "
             f"analytic_bvh_winner and {per_bounce} mesh_bvh_winner launches "
             f"and nothing else: {launches}")
    rad = st.radiance
    if tuple(rad.shape) != (n, bins) or not bool(torch.isfinite(rad).all()):
        fail("mesh: radiance has the wrong shape or is not finite")
    if not float(rad.mean()) > 0.0:
        fail("mesh: no radiance reached the camera")

    walls, segs = [], 0
    gen = torch.Generator(device="cuda").manual_seed(12)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        segs = int(run.segments)
    wall = float(np.median(walls[1:]))

    # one instrumented run: where the wall time goes, stage by stage
    steps = StageClock()
    for module, name, stage in (
            (I, "analytic_bvh_winner", "bvh_kernel"),
            (M, "_nearest", "mesh_kernel"),
            (W, "intersect_scene", "intersect"),
            (W, "_volume_interaction", "volume"),
            (W, "_surface_interaction", "surface"),
            (W, "_compact_lanes", "compaction")):
        steps.wrap(module, name, stage)
    try:
        gen = torch.Generator(device="cuda").manual_seed(12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        inst_ms = (time.perf_counter() - t0) * 1e3
    finally:
        steps.restore()
    w = steps.within
    mesh_in_isect = w.get(("intersect", "mesh_kernel"), 0.0)
    probe = w.get(("volume", "mesh_kernel"), 0.0)
    stage = dict(
        mesh_kernel=mesh_in_isect, bvh_kernel=steps.ms.get("bvh_kernel", 0.0),
        intersect_rest=(steps.ms["intersect"] - mesh_in_isect
                        - steps.ms.get("bvh_kernel", 0.0)),
        surface=steps.ms["surface"], volume_probe_kernel=probe,
        volume_rest=steps.ms["volume"] - probe,
        compaction=steps.ms.get("compaction", 0.0))
    stage["other"] = inst_ms - sum(stage.values())

    # MIS on against off: the floor and the wall sample the emitting box, so
    # the two estimators differ lane by lane; their means must agree
    runs = {}
    for mis in (True, False):
        c = dataclasses.replace(cfg, importance_sampling=mis)
        gen = torch.Generator(device="cuda").manual_seed(14)
        runs[mis] = T.render_batch(scene, c, o[::4].contiguous(),
                                   d[::4].contiguous(), gen).radiance.t()
    diff, se, mis_ok = mean_within(runs[True], runs[False], n_sigma=4.0)
    if not mis_ok:
        fail(f"mesh: MIS on/off means differ by {diff} (standard error {se})")
    lit = {k: float((v.sum(0) > 0).float().mean()) for k, v in runs.items()}

    # the big-mesh world: compile (BVH of 1.31M triangles) and one render
    # of 256x256 rays
    t0 = time.perf_counter()
    bscene, bcfg, ob, db = mesh_setup(T, scenes, world=scenes.big_mesh_world(),
                                      width=256, height=256, bins=5)
    compile_s = time.perf_counter() - t0
    reset_counts(fused)
    gen = torch.Generator(device="cuda").manual_seed(15)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = T.render_batch(bscene, bcfg, ob, db, gen)
    torch.cuda.synchronize()
    big_wall = time.perf_counter() - t0
    big_launches = read_counts(fused)
    if (big_launches["mesh_bvh_winner"] == 0
            or not bool(torch.isfinite(bst.radiance).all())
            or not float(bst.radiance.mean()) > 0.0):
        fail(f"mesh: the big-mesh world did not render: {big_launches}")

    emit("mesh", rays=n, bins=bins, max_depth=cfg.max_depth,
         max_iters=cfg.max_iters, compact_schedule=cfg.compact_schedule,
         traced_bounces=calls[0], launches=launches,
         mesh_launches_per_bounce=dict(intersect=len(scene.meshes),
                                       containment_probes=probes),
         segments=int(st.segments), overflow=int(st.overflow),
         mean_radiance_per_bin=[round(float(x), 5) for x in rad.mean(0)],
         wall_ms=wall * 1e3, walls_ms=[x * 1e3 for x in walls[1:]],
         segments_per_s=segs / wall, instrumented_wall_ms=inst_ms,
         stages_ms=stage, peak_bytes=peak,
         mis_mean_diff=diff, mis_standard_error=se, mis_lit_share=lit,
         big_mesh=dict(triangles=bscene.meshes[0].n_triangles,
                       rays=ob.shape[0], bins=5, compile_s=compile_s,
                       wall_ms=big_wall * 1e3, launches=big_launches,
                       segments=int(bst.segments),
                       mean_radiance=float(bst.radiance.mean())))
    return dict(launches=launches, big_launches=big_launches)


def kernels_line(cornell, grad, launches, step_launches, krng, prof, bvh_row,
                 wave_launches, mesh_rows, mesh_launches):
    """The per-kernel summary at the main paths' shapes (the Cornell box,
    262144 rays, 15 bins; the span kernels over all 24 bounces). Each
    kernel's launches are those of its own route's run of its main path:
    ``render_batch`` for the forward kernels (which the training step
    launches as often again), ``render_loss_and_grads`` for the adjoints;
    the kernel-RNG branches of the span kernels those of ``render_batch``
    and ``render_loss_and_grads`` with ``rng="kernel"``, and the profiling
    kernels those of the fusedprof chains."""
    src = "source_tpu_torch/csrc/"
    rows = []
    for name, m, line, source, count in (
            ("fused_bounce_fwd", cornell["fused_bounce_fwd"], 1319,
             "fused_kernels.cu", launches["perbounce"]),
            ("fused_span_fwd", cornell["fused_span_fwd"][-1], 1738,
             "fused_kernels.cu", launches["span"]),
            ("fused_bounce_bwd", grad["fused_bounce_bwd"], 1499,
             "fused_bwd_kernels.cu", step_launches["perbounce"]),
            ("fused_span_bwd", grad["fused_span_bwd"], 1824,
             "fused_bwd_kernels.cu", step_launches["multi"])):
        rows.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=f"source_tpu/tracer/pallas_fused.py:{line}",
            launches=count[name], max_abs_err=m["max_abs"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None))
    # the counting sort that schedules fused_bounce_bwd: part of K2's port
    # (the lane schedule of _bounce_bwd_call's grid), not a second kernel
    # ported; its time counts in K2's. max_abs_err: permutation entries and
    # live counts that differ from the plain version, summed over the
    # bounces. library_ms: one stable torch.sort of the keys
    m = grad["bin_live_lanes"]
    rows.append(dict(
        name="bin_live_lanes", route="cuda", source=src + "fused_bwd_kernels.cu",
        replaces="source_tpu/tracer/pallas_fused.py:1543",
        part_of="fused_bounce_bwd",
        launches=step_launches["perbounce"]["bin_live_lanes"],
        max_abs_err=m["max_abs"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m["library_ms"]))
    # the span kernels' kernel-RNG branch (_gen_u of the TPU kernels)
    for name, m, count in (
            ("fused_span_fwd (kernel RNG)", krng["fused_span_fwd"],
             krng["forward_launches"]),
            ("fused_span_bwd (kernel RNG)", krng["fused_span_bwd"],
             krng["step_launches"])):
        base = name.split()[0]
        rows.append(dict(
            name=name, route="cuda",
            source=src + ("fused_kernels.cu" if "fwd" in base
                          else "fused_bwd_kernels.cu") + " + philox.cuh",
            replaces="source_tpu/tracer/pallas_fused.py:1709",
            launches=count[base], max_abs_err=m["max_abs"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None))
    # the profiling kernels at the flagship's first bounce
    for name, line in (("fused_bounce_replay", 1375), ("fused_bounce_io", 1423)):
        m = prof["rows"][name]
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_kernels.cu",
            replaces=f"source_tpu/tracer/pallas_fused.py:{line}",
            launches=prof["launches"][name], max_abs_err=m["max_abs"],
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None))
    # the analytic-BVH kernel on the CSG demo's camera rays; its launches
    # are those of the wavefront route's render_batch of the CSG demo
    rows.append(dict(
        name="analytic_bvh_winner", route="cuda", source=src + "analytic_bvh.cu",
        replaces="source_tpu/tracer/pallas_analytic.py:702",
        launches=wave_launches["analytic_bvh_winner"],
        max_abs_err=bvh_row["max_abs"], ms=bvh_row["ms"],
        plain_ms=bvh_row["plain_ms"], bound_ms=bvh_row["bound_ms"],
        bound_by=bvh_row["bound_by"], library_ms=None))
    # the mesh kernel: at the demo camera's rays on its torus knot, with the
    # launches of the mesh demo's render_batch (K7's size), and on the
    # 1.31M-triangle icosphere with the launches of the big-mesh world's
    # render_batch (K8's size)
    for name, row, line, count in (
            ("mesh_bvh_winner", mesh_rows["camera_knot"], 192,
             mesh_launches["launches"]),
            ("mesh_bvh_winner (1.31M triangles)", mesh_rows["big"], 369,
             mesh_launches["big_launches"])):
        rows.append(dict(
            name=name, route="cuda", source=src + "mesh_bvh.cu",
            replaces=f"source_tpu/tracer/pallas_mesh.py:{line}",
            launches=count["mesh_bvh_winner"],
            max_abs_err=max(row["max_abs_dt"], row["max_abs_du"],
                            row["max_abs_dv"]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    return {"kernels": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,kernels,furnace,main,grad_kernels,step,"
                            "krng,fusedprof,bvh_kernels,wavefront,"
                            "mesh_kernels,mesh_furnace,mesh")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import source_tpu_torch as T
    from source_tpu_torch import scenes
    from source_tpu_torch.tracer import analytic_bvh, fused

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cornell = grad = launches = step_launches = krng = prof = None
    bvh_row = wave = None
    mesh_rows = mesh_launches = None
    mesh_furnace = False
    if "env" in phases:
        phase_env(fused, analytic_bvh)
    if "kernels" in phases:
        cornell = phase_kernels(T, fused, scenes)
    if "furnace" in phases:
        phase_furnace(T, scenes)
    if "main" in phases:
        launches = phase_main(T, fused, scenes)
    if "grad_kernels" in phases:
        grad = phase_grad_kernels(T, fused, scenes)
    if "step" in phases:
        step_launches = phase_step(T, fused, scenes)
    if "krng" in phases:
        krng = phase_krng(T, fused, scenes)
    if "fusedprof" in phases:
        prof = phase_fusedprof(T, fused, scenes)
    if "bvh_kernels" in phases:
        bvh_row = phase_bvh_kernels(T, analytic_bvh, scenes)
    if "wavefront" in phases:
        wave = phase_wavefront(T, fused, scenes)
    if "mesh_kernels" in phases:
        mesh_rows = phase_mesh_kernels(T, scenes)
    if "mesh_furnace" in phases:
        phase_mesh_furnace(T, scenes)
        mesh_furnace = True
    if "mesh" in phases:
        mesh_launches = phase_mesh(T, fused, scenes)
    emit("total", seconds=time.perf_counter() - t_start)
    if None in (cornell, grad, launches, step_launches, krng, prof, bvh_row,
                wave, mesh_rows, mesh_launches) or not mesh_furnace:
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 3
    print(gpu_line(), flush=True)
    print(json.dumps(kernels_line(cornell, grad, launches, step_launches,
                                  krng, prof, bvh_row, wave, mesh_rows,
                                  mesh_launches)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
