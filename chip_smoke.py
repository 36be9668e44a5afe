#!/usr/bin/env python3
"""Smoke run of source_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from source_tpu_torch/csrc/ (into
source_tpu_torch/_build/): the fused bounce kernels, forward and adjoint, the
analytic-BVH nearest-hit kernel and the mesh nearest-hit kernel. Holds each
against its plain PyTorch version on the card (and the forward kernels'
live-lane schedule bit for bit against its lane-order witnesses: the span
kernel run twice, against the adjoint kernel's forward replay and against
the chain of per-bounce kernels on live lists), runs the furnace checks
(analytic and watertight mesh), and drives the main paths: on
the glass Cornell box at 512x512 rays, 15 spectral bins, max_depth 16, 24
iterations, forward through ``compile_scene`` -> ``render_batch`` and the
training step through ``render_loss_and_grads``, each once through the
whole-span kernels and once through the per-bounce kernels (the adjoint
there over the live lanes binned by the counting-sort kernel, held to its
plain version and timed with the adjoint at every bounce), and both again
with the span kernels drawing their own uniforms (``rng="kernel"``, Philox in
the kernel: phase ``krng``); the per-bounce kernel beside its two profiling
variants, decisions replayed and loads and stores alone, each in place on
the live lists of the flagship's forward per-bounce route (17 launches),
and in lane order beside them (phase ``fusedprof``); and the CSG demo
(demos/csg.py) at 512x512 rays, 15 bins, max_depth 24, 32 iterations, with
compaction, through ``render_batch`` on the wavefront route; the mesh demo
(demos/mesh_render.py) at 512x384 rays, 12 bins, max_depth 12, 16
iterations, with compaction, on the wavefront route, and a world holding a
1.31M-triangle icosphere; the training step through the differentiable
wavefront route on the CSG demo and the mesh demo at those sizes (phase
``wstep``: checkpoint blocks of 1 and of 0 bounces, exact kernel launches,
the card against the CPU at 4 096 rays), and ``modifier_world`` (Blend, Add,
Roughen, user BSDFs, an inhomogeneous volume) at the CSG demo's camera,
forward and differentiable (phase ``modifiers``); and the observer layer
(phase ``observers``): the furnace through observers, tests/test_golden.py's
Cornell blocks, the card against the CPU on a small observation with
injected uniforms, and ``PinholeCamera.observe()`` on the five scenes of
benchmarks/suite.py at its sizes, timed by its protocol (one warm pass,
three timed passes), launches held exactly to each scene's route; the
per-ray entry points (phase ``queries``): ``World.hit`` and ``contains``
on analytic, CSG and mesh worlds, ``optical.Ray.sample`` of 1 048 576 rays
in the furnace and ``LoggingRay``, each against CPU tensors with exact
launches, the kernels they reach held to their plain versions at their
inputs; and the two lens demos (phase ``lenses``): the Cooke triplet's
analytic-BVH inputs recorded from an ``observe()`` pass and held to the
plain versions, a small observation against CPU tensors, and both demos at
their image sizes and bins by the suite's protocol; the mesh file IO
(phase ``meshio``): the bunny demo's 20 480-triangle stand-in through every
writer and reader (OBJ by the native tokenizer and by the Python reader,
STL, PLY, VTK, RSM), the bunny demo (demos/materials/bunny.py: the glass
mesh read back from PLY in a CSG glass light box) observed at 512x512, 5
spectral rays, 15 bins, by the suite's protocol (a warm pass, two timed
passes) with exact launches, K6 and K7 at its recorded rays against their
plain versions, a small observation against CPU tensors and the KDTree
facade's queries; and the function framework (phase ``functions``): the
tetrahedral-emission demo's ``Discrete3DMesh`` at 1 048 576 points and the
array interpolators against CPU tensors, the samplers' normalisation, and
the demo (demos/materials/tetrahedra_mesh_emission.py) observed at
512x512 with its field's memory at the observed batch. Every
phase prints one JSON line; any failure exits non-zero. Without a CUDA
device the script exits 2 and prints no result.
``--phases krng,fusedprof`` runs a subset while developing (the last line is
then not a pass).
"""

import argparse
import contextlib
import dataclasses
import json
import math
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


_T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


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


def schedule_gates(where, fused, spec, tab, desc, st0, u, span):
    """The forward kernels' schedule on one input. ``span()`` runs K3 (host
    or kernel RNG) and returns (state, bits); ``u`` f32[n_steps, 10, N] are
    the uniforms it read or drew. Fails unless K3 run twice is equal to
    itself bit for bit (only the order of lanes within a queue depends on
    the atomics, no float does); unless the chain of K1 over the same
    uniforms, each bounce on the lanes the one before left alive, in place
    (as the forward per-bounce route runs it), ends in K3's state and bits
    bit for bit; and unless each list K1 wrote is, as a set, the lanes alive
    after its bounce (``live_lanes_plain``). Returns (K3's state, bits, the
    lanes each list held)."""
    k_st, k_bits = span()
    again = span()
    if not (bitwise_equal(k_st, again[0]) and torch.equal(k_bits, again[1])):
        fail(f"{where}: fused_span_fwd run twice differs")
    st, live, listed, bits = {k: v.clone() for k, v in st0.items()}, None, [], []
    for k in range(u.shape[0]):
        st, b, live = fused.fused_bounce_fwd(spec, tab, desc, st, u[k],
                                             live=live, survivors=True,
                                             in_place=True)
        bits.append(b)
        n = int(live[1][0])
        if not torch.equal(torch.sort(live[0][:n]).values,
                           fused.live_lanes_plain(st["aux"])):
            fail(f"{where}: fused_bounce_fwd's live list at bounce {k} is not "
                 "the set of lanes alive after it")
        listed.append(n)
    if not (bitwise_equal(st, k_st) and torch.equal(torch.stack(bits), k_bits)):
        fail(f"{where}: the chain of fused_bounce_fwd on live lists differs "
             "from fused_span_fwd")
    return k_st, k_bits, listed


def short_list_gate(T, fused, scenes):
    """K1 on live lists at small sizes, where a gathered list (under half of
    the lanes) may be longer than the grid has warps: the chains of K1 on
    lists, in place and out of place, equal the lane-order chain bit for bit
    (state and bitfields) at every bounce, and each list is the set of lanes
    alive after its bounce; K3 (whose tail spreads a short step over all of
    its grid's warps) ends in the same state and bitfields. At every bounce,
    on the in-place chain's list and from a copy of the entry state, K9 in
    place and out of place equals K1 bit for bit and lists K1's survivors,
    and K10 returns the entry state, a zero bitfield and the entry's live
    lanes. Fails too if no bounce of a case ran such a list. Returns each
    case's list lengths."""
    cfg = T.RayConfig(max_depth=FLAGSHIP["max_depth"], max_iters=24)
    box = T.compile_scene(scenes.cornell_box(glass=True),
                          T.SpectralConfig(375.0, 740.0, FLAGSHIP["bins"]))
    zoo = T.compile_scene(scenes.zoo(), T.SpectralConfig(375.0, 740.0, 5))
    cases = []
    for name, scene, c, (o, d) in (
            ("cornell_64x64", box, cfg, scenes.pinhole_rays(64, 64)),
            ("cornell_128x128", box, cfg, scenes.pinhole_rays(128, 128)),
            ("zoo_1000", zoo, T.RayConfig(max_depth=6),
             scenes.scatter_rays(1000, seed=3))):
        spec, entry = fused.scene_tables(scene, c)
        desc = entry["desc"]
        with torch.no_grad():
            tab = fused.pack_tabvec(scene, spec)
        st0 = fused.pack_state(T.init_rays(torch.as_tensor(o).cuda(),
                                           torch.as_tensor(d).cuda(),
                                           spec.bins))
        N = st0["o"].shape[1]
        warps = (N + 127) // 128 * 4  # K1's grid
        u = torch.as_tensor(np.random.RandomState(N).random_sample(
            (24, fused.N_UNIFORMS, N)).astype(np.float32)).cuda()
        ref, outp, inp = st0, st0, {k: v.clone() for k, v in st0.items()}
        live_in = live_out = None
        listed, ref_bits_all = [], []
        for k in range(u.shape[0]):
            entry, listed_in = ref, live_in
            ref, ref_bits = fused.fused_bounce_fwd(spec, tab, desc, ref, u[k])
            ref_bits_all.append(ref_bits)
            inp, b_in, live_in = fused.fused_bounce_fwd(
                spec, tab, desc, inp, u[k], live=live_in, survivors=True,
                in_place=True)
            profiling_on_lists(f"short lists {name}", fused, spec, tab, desc,
                               entry, u[k], ref_bits, listed_in, ref)
            outp, b_out, live_out = fused.fused_bounce_fwd(
                spec, tab, desc, outp, u[k], live=live_out, survivors=True)
            if not (bitwise_equal(inp, ref) and torch.equal(b_in, ref_bits)):
                fail(f"short lists {name}: K1 on lists in place differs from "
                     f"lane order at bounce {k}")
            if not (bitwise_equal(outp, ref) and torch.equal(b_out, ref_bits)):
                fail(f"short lists {name}: K1 on lists out of place differs "
                     f"from lane order at bounce {k}")
            want = fused.live_lanes_plain(ref["aux"])
            for lanes, count in (live_in, live_out):
                n = int(count[0])
                if not torch.equal(torch.sort(lanes[:n]).values, want):
                    fail(f"short lists {name}: the live list after bounce {k} "
                         "is not the set of lanes alive")
            listed.append(n)
        k3_st, k3_bits = fused.fused_span_fwd(spec, tab, desc, st0, u)
        if not (bitwise_equal(k3_st, ref)
                and torch.equal(k3_bits, torch.stack(ref_bits_all))):
            fail(f"short lists {name}: fused_span_fwd differs from the "
                 "lane-order chain of fused_bounce_fwd")
        if not any(warps < n and 2 * n < N for n in listed[:-1]):
            fail(f"short lists {name}: no gathered list was longer than the "
                 f"grid's {warps} warps ({listed})")
        cases.append(dict(scene=name, n=N, warps=warps, listed=listed))
    return cases


def list_lanes(live):
    """The lanes of a live list (lanes, count) on the device, sorted."""
    return torch.sort(live[0][:int(live[1][0])]).values


def profiling_on_lists(where, fused, spec, tab, desc, entry, u, bits, live,
                       after, out_of_place=True):
    """K9 and K10 on the live list ``live`` of the lanes alive in ``entry``
    (None at a first bounce), in place from a copy and (``out_of_place``)
    out of place: K9,
    replaying ``bits`` (K1's), ends in K1's state ``after`` bit for bit and
    lists the lanes alive in it; K10 returns ``entry`` bit for bit, a zero
    bitfield and the lanes alive in ``entry``."""
    want9 = fused.live_lanes_plain(after["aux"])
    want10 = fused.live_lanes_plain(entry["aux"])
    for in_place in (True, False) if out_of_place else (True,):
        how = "in place" if in_place else "out of place"
        st = {k: v.clone() for k, v in entry.items()} if in_place else entry
        r_st, r_live = fused.fused_bounce_replay(
            spec, tab, desc, st, u, bits, live=live, survivors=True,
            in_place=in_place)
        if not bitwise_equal(r_st, after):
            fail(f"{where}: K9 on lists {how} differs from K1")
        if not torch.equal(list_lanes(r_live), want9):
            fail(f"{where}: K9's list {how} is not K1's survivors")
        st = {k: v.clone() for k, v in entry.items()} if in_place else entry
        i_st, i_bits, i_live = fused.fused_bounce_io(
            spec, tab, desc, st, u, live=live, survivors=True,
            in_place=in_place)
        if not bitwise_equal(i_st, entry) or bool(i_bits.any()):
            fail(f"{where}: K10 on lists {how} does not return its input "
                 "with a zero bitfield")
        if not torch.equal(list_lanes(i_live), want10):
            fail(f"{where}: K10's list {how} is not the lanes alive on entry")


def replay_gate(where, fused, scene, cfg, st0, n_steps, u=None, key=None):
    """K3 on the scene's general tables against K4's forward replay, which
    walks the span in lane order (an independent witness of the old
    schedule): equal bit for bit. Host RNG with ``u``, kernel RNG with the
    seed ``key``."""
    spec, entry = fused.scene_tables(scene, cfg, general=True)
    desc = entry["desc"]
    with torch.no_grad():
        tab = fused.pack_tabvec(scene, spec)
    n = st0["o"].shape[1]
    g_st, g_bits = fused.fused_span_fwd(spec, tab, desc, st0, u, seed=key,
                                        n_steps=n_steps)
    zeros = [torch.zeros((r, n), device="cuda") for r in (3, 3, spec.bins,
                                                          spec.bins)]
    got = fused.fused_span_bwd(spec, tab, desc,
                               {k: st0[k] for k in ("o", "d", "thr", "aux")},
                               u, g_bits, *zeros, return_replay=True, seed=key)
    if not bitwise_equal(got[4], torch.cat([g_st["o"], g_st["d"], g_st["thr"],
                                            g_st["aux"]])):
        fail(f"{where}: K4's replay (lane order) does not end in K3's state "
             "bit for bit")


def device_ms_chain(make, reps=5):
    """Median device milliseconds of each call of a chain, as device_ms
    times one call: ``make()`` returns one pass's calls in order (a call may
    use what the one before left: they run in turn), set up afresh for each
    pass outside the timing; the card spins while the host enqueues the
    pass. Returns a list, one median per call."""
    passes = []
    cycles = 400_000 * reps
    while len(passes) < reps + 1:
        fns = make()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(cycles)
        pairs = []
        t0 = time.perf_counter()
        for fn in fns:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if e0.elapsed_time(pairs[0][0]) > host_ms:
            passes.append([a.elapsed_time(b) for a, b in pairs])
        elif cycles > 400_000 * reps * 4 ** 6:
            fail("device_ms_chain: the host did not get ahead of the card")
        else:
            cycles *= 4
    return [float(np.median(col)) for col in zip(*passes[1:])]


def k3_timeline(fused, spec, tab, desc, st0, u):
    """One K3 run with its timeline: block 0's clock at the end of the head
    and after each step of the tail, and the lanes each tail step ran."""
    n_steps = u.shape[0]
    tl = torch.zeros((2 + 2 * n_steps,), dtype=torch.int64, device="cuda")
    _st, bits = fused.fused_span_fwd(spec, tab, desc, st0, u, timeline=tl)
    torch.cuda.synchronize()
    t = tl.tolist()
    ends = t[2:2 + n_steps]
    steps = [(b - a) * 1e-6 for a, b in zip([t[1]] + ends[:-1], ends)]
    return dict(total_ms=(ends[-1] - t[0]) * 1e-6, head_ms=(t[1] - t[0]) * 1e-6,
                tail_ms=(ends[-1] - t[1]) * 1e-6, tail_step_ms=steps,
                tail_lanes=t[2 + n_steps:],
                entered=[int(x) for x in (st0["aux"][0] > 0.5).sum().view(1)]
                + [int(x) for x in ((bits[:-1] >> fused.B_ALIVENEXT) & 1)
                   .sum(1)],
                tail_steps_run=sum(1 for x in t[2 + n_steps:] if x > 0))


def span_against_plain(name, fused, spec, tab, desc, st0, u):
    """Hold one fused_span_fwd call (packed state ``st0``, uniforms ``u``
    [n_steps, 10, N]) against span_fwd_plain on the same inputs: flips per
    bounce, the state of the lanes whose history agrees, and the mean
    radiance; returns its measurements, times and bound."""
    N, bins, n_steps = st0["o"].shape[1], spec.bins, u.shape[0]
    flops = fused.bounce_flops(spec)
    state_bytes = 4 * N * (8 + 2 * bins)
    table_bytes = 4 * (tab.numel() + desc.numel())
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
    return dict(
        scene=name, n=N, bins=bins, n_steps=n_steps, segments=segs,
        flip=flip, diverged=1.0 - float(agree.float().mean()), **dev,
        mean_diff=diff, mean_se=se, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes_ms=t_bytes, operations_ms=t_ops)


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
    spans = [span_against_plain(name, fused, spec, tab, desc, st0,
                                u_all[:n_steps].contiguous())
             for n_steps in span_steps]
    res["fused_span_fwd"] = spans

    # --- the schedule over the whole chain of n_max bounces: the gates (K3
    # twice, K3 against the chain of K1 on live lists and each list against
    # live_lanes_plain, K3 against K4's lane-order replay)
    k3_st, k3_bits, listed = schedule_gates(
        name, fused, spec, tab, desc, st0, u_all,
        lambda: fused.fused_span_fwd(spec, tab, desc, st0, u_all))
    replay_gate(name, fused, scene, cfg, st0, n_max, u=u_all)
    # K3's head and tail by its own clock, and a span whose rays all die in
    # their first bounce (sent out from far away): the floor of the launch,
    # the head, one grid barrier and the final pass
    spans[-1]["timeline"] = k3_timeline(fused, spec, tab, desc, st0, u_all)
    far = dict(st0, o=(st0["d"] * 1e4).contiguous())
    dead_bits = fused.fused_span_fwd(spec, tab, desc, far, u_all)[1]
    if bool((dead_bits[1:] != 0).any()):
        fail(f"{name}: rays sent outward from far away did not all die in "
             "their first bounce")
    spans[-1]["all_dead_ms"] = device_ms(
        lambda: fused.fused_span_fwd(spec, tab, desc, far, u_all))

    # K1 at every bounce of the chain by the device timer: on the live
    # lists in place, as the forward per-bounce route runs it (one pass of
    # the chain from a fresh copy of the state); on the lists out of place
    # (which the differentiable route, out of place, does not use: it timed
    # slower than lane order); and in lane order, the schedule before and
    # the differentiable route's. Beside each bounce its bound: the table, the bitfields, and
    # the state in and out and the uniforms of the lanes alive on entry.
    def route_pass():
        box = dict(st={k: v.clone() for k, v in st0.items()}, live=None)

        def call(k):
            def fn():
                box["st"], _b, box["live"] = fused.fused_bounce_fwd(
                    spec, tab, desc, box["st"], u_all[k], live=box["live"],
                    survivors=True, in_place=True)
            return fn
        return [call(k) for k in range(n_max)]

    in_place = device_ms_chain(route_pass)
    entries, lists, cur, live = [], [], st0, None
    for k in range(n_max):
        entries.append(cur)
        lists.append(live)
        cur, _b, live = fused.fused_bounce_fwd(spec, tab, desc, cur, u_all[k],
                                               live=live, survivors=True)
    listed_ms = [device_ms(lambda: fused.fused_bounce_fwd(
        spec, tab, desc, entries[k], u_all[k], live=lists[k], survivors=True))
        for k in range(n_max)]
    lane_order_ms = [device_ms(lambda: fused.fused_bounce_fwd(
        spec, tab, desc, entries[k], u_all[k])) for k in range(n_max)]
    alive = [int((e["aux"][0] > 0.5).sum()) for e in entries]
    segs_k = [int((b & 1).sum()) for b in k3_bits]
    bounds = [max((table_bytes + 4 * N + 4 * a * (2 * (8 + 2 * bins)
                                                  + fused.N_UNIFORMS))
                  / HBM_BYTES_PER_S, g * flops / F32_FLOPS) * 1e3
              for a, g in zip(alive, segs_k)]
    route = [k for k in range(n_max) if alive[k] > 0]  # the host early exit
    res["fused_bounce_fwd"].update(
        chain_bounces=n_max, route_launches=len(route), alive=alive,
        listed=listed, in_place_ms=in_place, listed_ms=listed_ms,
        lane_order_ms=lane_order_ms, bound_by_bounce_ms=bounds,
        route_ms=sum(in_place[k] for k in route),
        route_listed_ms=sum(listed_ms[k] for k in route),
        route_lane_order_ms=sum(lane_order_ms[k] for k in route),
        route_bound_ms=sum(bounds[k] for k in route))
    return res


def phase_env(fused, bvh, extra_fwd_bins=()):
    t0 = time.time()
    from source_tpu_torch.tracer import mesh_bvh
    jobs = [(b, which) for which in ("fwd", "bwd") for b in (FLAGSHIP["bins"], 5)]
    jobs += [(None, "bvh"), (None, "mesh")]
    # the bin counts of other phases' fused scenes (the MIS scene's 12)
    jobs += [(b, "fwd") for b in extra_fwd_bins]

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

    # the per-bounce loop's three instantiations, k_bounce<MODE>
    fwd = ptxas(logs[0])
    per_bounce = {k: next((v for name, v in fwd.items()
                           if f"k_bounceILi{mode}EE" in name), None)
                  for k, mode in (("K1", 0), ("K9", 1), ("K10", 2))}
    emit("env", gpu=gpu_line(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=round(build_s, 2),
         nvcc_flags=" ".join(fused.NVCC_FLAGS),
         ptxas_per_bounce_b15=per_bounce, ptxas_fwd_b15=fwd,
         ptxas_fwd_b5=ptxas(logs[1]), spill_at=fused.SPILL_AT,
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
    short = short_list_gate(T, fused, scenes)
    emit("kernels", tolerance=dict(rtol=RTOL, atol=ATOL, max_flip=MAX_FLIP,
                                   torus_bounce=TORUS_BOUNCE,
                                   torus_span=TORUS_SPAN,
                                   f64_factor=F64_FACTOR),
         fused_bounce_fwd=[cornell["fused_bounce_fwd"],
                           general["fused_bounce_fwd"], zoo["fused_bounce_fwd"]],
         fused_span_fwd=(cornell["fused_span_fwd"] + general["fused_span_fwd"]
                         + zoo["fused_span_fwd"]),
         short_lists=short)
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
    # the schedule under the kernel RNG: K3 twice, the chain of K1 on live
    # lists fed the same stream, each list against live_lanes_plain
    schedule_gates(f"krng {name}", fused, spec, tab, desc, st0, u_ref,
                   lambda: fused.fused_span_fwd(spec, tab, desc, st0, seed=key,
                                                n_steps=n_steps))
    segs = int((k_bits & 1).sum())
    entered = n + int(((k_bits[:-1] >> fused.B_ALIVENEXT) & 1).sum())
    row = dict(scene=name, n=n, bins=bins, n_steps=n_steps, segments=segs,
               entered=entered, equal_to_fed_kernel=True,
               equal_at_start_5=True, schedule_gates=True)
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
    schedule_gates(f"krng {name} (general records)", fused, spec, tab, desc,
                   st0, u_ref, lambda: fused.fused_span_fwd(
                       spec, tab, desc, st0, seed=key, n_steps=n_steps))
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
    """The flagship's forward per-bounce route as
    ``fused_forward_span(span="perbounce")`` runs it: from ``pack_state``,
    K1 (fused_bounce_fwd) in place on the previous bounce's live list until
    every lane is dead (17 launches at max_depth 16), each bounce's entry
    state, list and bitfield kept. At each bounce K9 (fused_bounce_replay,
    K1's bits) and K10 (fused_bounce_io) run in place on the same list from
    a copy of the entry state: K9 must equal K1 bit for bit on every state
    key and list K1's survivors, with K1's count; K10 must return the entry
    state bit for bit, a zero bitfield and the entry's live lanes. Then K9
    and K10 in lane order, out of place: K9 equal to K9 on lists, K10 to its
    input; K9 against ``bounce_core`` replay and K10 against its plain
    version. Launches counted exactly for each pass. Per bounce the device
    time of each kernel in place on its list from a fresh copy (made outside
    the timed window): K1 - K9 is the decision path, K9 - K10 the
    arithmetic, K10 the load/store and launch floor, summed over the route
    beside each kernel's bound over the live lanes. Beside them the same
    three in lane order, out of place, on the same entry states (the split
    of a K1 schedule no route launches, as the profiling kernels ran before
    they took K1's)."""
    bins = FLAGSHIP["bins"]
    scene, cfg, o, d, u_fixed, _same_u = flagship(T, fused, scenes)
    n = o.shape[0]
    spec, entry = fused.scene_tables(scene, cfg)
    desc, tab = entry["desc"], fused.forward_table(scene, spec, entry)
    state = T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype)
    u_p = fused.pack_u(u_fixed)

    def copy(st):
        return {k: v.clone() for k, v in st.items()}

    # the route itself, for its launches; then the same loop, each bounce's
    # entry kept
    reset_counts(fused)
    fused.fused_forward_span(tab, desc, spec, state, u_fixed, span="perbounce")
    torch.cuda.synchronize()
    route = read_counts(fused)["fused_bounce_fwd"]
    reset_counts(fused)
    st, live = fused.pack_state(state), None
    entries, lists, bits, pushed = [], [], [], []
    for u in u_p:
        if not bool((st["aux"][0] > 0.5).any()):
            break
        entries.append(copy(st))
        lists.append(live)
        st, b, live = fused.fused_bounce_fwd(spec, tab, desc, st, u, live=live,
                                             survivors=True, in_place=True)
        bits.append(b)
        pushed.append(int(live[1][0]))
    afters = entries[1:] + [st]
    n_route = len(entries)
    torch.cuda.synchronize()
    counts = dict(route=read_counts(fused))
    if (counts["route"] != dict(NO_LAUNCHES, fused_bounce_fwd=route)
            or n_route != route):
        fail(f"fusedprof: the route launched {route} K1, its loop "
             f"{counts['route']}")

    # K9 and K10 on the route's lists, in place, from copies
    reset_counts(fused)
    for k in range(n_route):
        profiling_on_lists(f"fusedprof, bounce {k}", fused, spec, tab, desc,
                           entries[k], u_p[k], bits[k], lists[k], afters[k],
                           out_of_place=False)
    torch.cuda.synchronize()
    counts["on_lists"] = read_counts(fused)

    # in lane order, out of place; and against the plain versions
    reset_counts(fused)
    worst = dict(max_abs=0.0, max_rel=0.0)
    every = torch.ones(n, dtype=torch.bool, device="cuda")
    none = torch.zeros(n, dtype=torch.bool, device="cuda")
    plain_ms = dict(replay=[], io=[])
    for k in range(n_route):
        u, e = u_p[k], entries[k]
        replayed = fused.fused_bounce_replay(spec, tab, desc, e, u, bits[k])
        if not bitwise_equal(replayed, afters[k]):
            fail(f"fusedprof: K9 in lane order differs from K9 on lists at "
                 f"bounce {k}")
        io, io_bits = fused.fused_bounce_io(spec, tab, desc, e, u)
        if not bitwise_equal(io, e) or bool(io_bits.any()):
            fail(f"fusedprof: K10 in lane order does not return its input at "
                 f"bounce {k}")
        ref, ms = run_ms(lambda: fused.bounce_replay_plain(
            spec, tab, e, u, bits[k]))
        plain_ms["replay"].append(ms)
        dev = compare_state(afters[k], ref, every, none, TORUS_BOUNCE)
        if not dev.pop("ok") or not torch.equal(afters[k]["aux"], ref["aux"]):
            fail(f"fusedprof: K9 against bounce_core replay at bounce {k}: {dev}")
        worst = {m: max(worst[m], dev[m]) for m in worst}
        (io_ref, io_ref_bits), ms = run_ms(lambda: fused.bounce_io_plain(
            spec, tab, e, u))
        plain_ms["io"].append(ms)
        if not (bitwise_equal(io, io_ref) and torch.equal(io_bits, io_ref_bits)):
            fail(f"fusedprof: K10 against its plain version at bounce {k}")
    torch.cuda.synchronize()
    counts["lane_order"] = read_counts(fused)
    want = dict(route=dict(NO_LAUNCHES, fused_bounce_fwd=n_route),
                on_lists=dict(NO_LAUNCHES, fused_bounce_replay=n_route,
                              fused_bounce_io=n_route),
                lane_order=dict(NO_LAUNCHES, fused_bounce_replay=n_route,
                                fused_bounce_io=n_route))
    if counts != want:
        fail(f"fusedprof: launches {counts}, want {want}")

    # per-bounce device times: on the lists in place, each kernel from a
    # fresh copy of the entry state made before its timed window; in lane
    # order out of place on the same entries; and K1's route as one chain
    def in_place_ms(k, call):
        def make():
            box = copy(entries[k])
            return [lambda: call(box)]
        return device_ms_chain(make)[0]

    per = dict(k1=[], k9=[], k10=[], k1_lane_order=[], k9_lane_order=[],
               k10_lane_order=[])
    for k in range(n_route):
        u, e, lst, b = u_p[k], entries[k], lists[k], bits[k]
        per["k1"].append(in_place_ms(k, lambda box: fused.fused_bounce_fwd(
            spec, tab, desc, box, u, live=lst, survivors=True, in_place=True)))
        per["k9"].append(in_place_ms(k, lambda box: fused.fused_bounce_replay(
            spec, tab, desc, box, u, b, live=lst, survivors=True,
            in_place=True)))
        per["k10"].append(in_place_ms(k, lambda box: fused.fused_bounce_io(
            spec, tab, desc, box, u, live=lst, survivors=True, in_place=True)))
        per["k1_lane_order"].append(device_ms(
            lambda: fused.fused_bounce_fwd(spec, tab, desc, e, u)))
        per["k9_lane_order"].append(device_ms(
            lambda: fused.fused_bounce_replay(spec, tab, desc, e, u, b)))
        per["k10_lane_order"].append(device_ms(
            lambda: fused.fused_bounce_io(spec, tab, desc, e, u)))

    def route_pass():
        box = dict(st=copy(entries[0]), live=None)

        def call(k):
            def fn():
                box["st"], _b, box["live"] = fused.fused_bounce_fwd(
                    spec, tab, desc, box["st"], u_p[k], live=box["live"],
                    survivors=True, in_place=True)
            return fn
        return [call(k) for k in range(n_route)]
    k1_chain = device_ms_chain(route_pass)

    # each kernel's bound at each bounce, over the lanes alive on entry: the
    # table, their state in and out and uniforms, the bitfield (K1 and K10
    # write all N; K9 reads the live lanes'), the list read (none at the
    # first bounce) and the lanes pushed; operations: the segments' bounce
    # (K1), the replayed bounce (K9), K10's sums (4 B + 29 a lane)
    alive = [int((e["aux"][0] > 0.5).sum()) for e in entries]
    segs = [int((b & 1).sum()) for b in bits]
    table_bytes = 4 * (tab.numel() + desc.numel())
    bounds = dict(k1=[], k9=[], k10=[])
    for k in range(n_route):
        a = alive[k]
        common = (table_bytes + 4 * a * (2 * (8 + 2 * bins) + fused.N_UNIFORMS)
                  + (4 * a if lists[k] is not None else 0))
        bounds["k1"].append(bound(common + 4 * n + 4 * pushed[k],
                                  segs[k] * fused.bounce_flops(spec)))
        bounds["k9"].append(bound(common + 4 * a + 4 * pushed[k],
                                  segs[k] * fused.bounce_flops(spec,
                                                               replay=True)))
        bounds["k10"].append(bound(common + 4 * n + 4 * a,
                                   a * (4 * bins + 29)))

    def total(rows):
        t = {m: sum(r[m] for r in rows)
             for m in ("bytes_ms", "f32_ms", "int32_ms", "bound_ms")}
        return dict(t, bound_by="bytes" if t["bytes_ms"] >= max(
            t["f32_ms"], t["int32_ms"]) else "operations")

    route_bound = {k: total(v) for k, v in bounds.items()}
    sums = {k: sum(v) for k, v in per.items()}

    def split_of(k1, k9, k10):
        """K1's time a bounce split by K9 and K10."""
        return dict(decision_ms=[a - b for a, b in zip(k1, k9)],
                    arithmetic_ms=[a - b for a, b in zip(k9, k10)],
                    floor_ms=list(k10))

    split = split_of(per["k1"], per["k9"], per["k10"])
    split_lane_order = split_of(per["k1_lane_order"], per["k9_lane_order"],
                                per["k10_lane_order"])
    # K10 is k_bounce<IO>, IO = 2 (csrc/fused_kernels.cu)
    sass = sass_counts(fused.build_library(bins)[0], "k_bounceILi2EE")
    if sass is not None and (sass["ldg"] < 8 + 2 * bins + fused.N_UNIFORMS
                             or sass["stg"] < 8 + 2 * bins + 1):
        fail(f"fusedprof: K10's SASS has fewer global loads or stores than "
             f"the state and uniforms need: {sass}")
    rows = {
        "fused_bounce_replay": dict(
            max_abs=worst["max_abs"], max_rel=worst["max_rel"],
            ms=sums["k9"], first_bounce_ms=per["k9"][0],
            lane_order_ms=sums["k9_lane_order"],
            plain_ms=sum(plain_ms["replay"]),
            bound_ms=route_bound["k9"]["bound_ms"],
            bound_by=route_bound["k9"]["bound_by"],
            first_bounce_bound_ms=bounds["k9"][0]["bound_ms"]),
        "fused_bounce_io": dict(
            max_abs=0.0, ms=sums["k10"], first_bounce_ms=per["k10"][0],
            lane_order_ms=sums["k10_lane_order"],
            plain_ms=sum(plain_ms["io"]),
            bound_ms=route_bound["k10"]["bound_ms"],
            bound_by=route_bound["k10"]["bound_by"],
            first_bounce_bound_ms=bounds["k10"][0]["bound_ms"]),
    }
    emit("fusedprof", rays=n, bins=bins, route_launches=n_route,
         launches=counts, k9_equals_k1=True, k10_identity=True,
         alive=alive, pushed=pushed, segments=segs,
         listed=[None if lst is None else int(lst[1][0]) for lst in lists],
         per_bounce_ms=per, split_by_bounce=split,
         split_by_bounce_lane_order=split_lane_order,
         route_ms=sums, k1_route_chain_ms=sum(k1_chain),
         k1_route_chain_by_bounce_ms=k1_chain,
         **{k: sum(v) for k, v in split.items()},
         lane_order_split={k: sum(v) for k, v in split_lane_order.items()},
         route_bound=route_bound,
         bound_by_bounce_ms={k: [r["bound_ms"] for r in v]
                             for k, v in bounds.items()},
         plain_ms_by_bounce=plain_ms, k10_sass=sass, kernels=rows)
    return dict(rows=rows, launches=counts["on_lists"])


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


def csg_setup_cfg(T):
    """The CSG demo's ray configuration."""
    return T.RayConfig(
        max_depth=CSG["max_depth"], extinction_prob=CSG["extinction_prob"],
        extinction_min_depth=3, importance_sampling=True,
        important_path_weight=0.25, max_iters=CSG["max_iters"],
        compact_schedule=CSG["compact_schedule"], spectral_dtype="float32")


def csg_setup(T, scenes, device="cuda"):
    """The CSG demo (its tables on ``device``), its ray configuration and its
    512x512 camera rays."""
    scene = T.compile_scene(scenes.csg_world(),
                            T.SpectralConfig(375.0, 740.0, CSG["bins"]),
                            device=device)
    cfg = csg_setup_cfg(T)
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
               bins=MESH["bins"], device="cuda"):
    """A mesh world (the demo unless given; its tables on ``device``), the
    demo's ray configuration and the demo camera's rays (512x384 unless
    given)."""
    scene = T.compile_scene(scenes.mesh_world() if world is None else world,
                            T.SpectralConfig(375.0, 740.0, bins),
                            device=device)
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


# --- the differentiable wavefront route (phases wstep and modifiers) ---------

WSTEP_SEED = 21
WSTEP_N_CPU = 4096       # rays of the card-against-CPU check (every 64th)
REMAT_LOSS_RTOL = 1e-6   # loss, remat_block 1 against 0
REMAT_GRAD_TOL = 1e-5    # gradient fields, of each field's largest entry
CPU_LOSS_RTOL = 1e-4     # loss over the agreeing lanes, card against CPU
CPU_GRAD_TOL = 1e-3      # gradient fields, of each field's largest entry
MOD_RAYS = 512           # modifier_world at the CSG demo's camera, 512x512
# bounces of the differentiable steps of the CSG demo and modifier_world:
# the demo's 32 cut to 16, to keep the whole script inside half its time
# limit (the gates count launches from it)
WSTEP_ITERS = 16


def emission_rows(scene):
    """(material, slot) of every spectral row that only emits: surface
    emitters and lights (slot 0), the checkerboard (slots 0 and 1),
    homogeneous volume emitters (slot 0)."""
    from source_tpu_torch.optical.material import base as mb
    rows = {(m, 0) for m, t in enumerate(scene.mat_types)
            if t in (mb.MAT_EMITTER, mb.MAT_EMITTER_ANISO, mb.MAT_LIGHT,
                     mb.MAT_CHECKERBOARD)}
    rows |= {(m, 1) for m, t in enumerate(scene.mat_types)
             if t == mb.MAT_CHECKERBOARD}
    rows |= {(r[1], 0) for r in scene.volume_entities
             if r[2] == mb.VOL_HOMOGENEOUS}
    return sorted(rows)


def euler_ratio(scene, loss, grads, rad_cross=0.0):
    """sum(value * gradient) over the emission rows over 2 (loss -
    rad_cross). Radiance less the part of the inhomogeneous volumes (whose
    emission is a closure, not a row) is homogeneous of degree 1 in the
    rows, so against a zero target the ratio is 1; ``rad_cross`` is
    mean(radiance * that part), 0 without such volumes."""
    lhs = sum(float((scene.mat_spectra[m, k] * grads["mat_spectra"][m, k])
                    .sum()) for m, k in emission_rows(scene))
    return lhs / (2.0 * (float(loss) - rad_cross))


def grad_gates(where, scene, loss, grads, nonzero, mesh_nonzero):
    """Finite loss > 0, finite gradients of the scene's shapes, the named
    fields not all zero (and each mesh's ``mesh_nonzero`` fields)."""
    if not (np.isfinite(float(loss)) and float(loss) > 0.0):
        fail(f"{where}: loss {float(loss)} is not finite and positive")
    for f, g in grads.items():
        if f == "meshes":
            continue
        if g.shape != getattr(scene, f).shape or not bool(
                torch.isfinite(g).all()):
            fail(f"{where}: gradient of {f} has the wrong shape or is not "
                 "finite")
    for f in nonzero:
        if not bool((grads[f] != 0).any()):
            fail(f"{where}: gradient of {f} is all zero")
    if bool(scene.meshes) != ("meshes" in grads):
        fail(f"{where}: grads['meshes'] is there for a scene without meshes "
             "or missing for one with them")
    for slot, mg in enumerate(grads.get("meshes", ())):
        for f, g in mg.items():
            if g.shape != getattr(scene.meshes[slot], f).shape or not bool(
                    torch.isfinite(g).all()):
                fail(f"{where}: gradient of mesh {slot}'s {f} has the wrong "
                     "shape or is not finite")
        for f in mesh_nonzero:
            if not bool((mg[f] != 0).any()):
                fail(f"{where}: gradient of mesh {slot}'s {f} is all zero")


def flat_grads(grads):
    """Field name -> gradient, each mesh's fields as ``mesh<slot>.<field>``."""
    out = {f: g for f, g in grads.items() if f != "meshes"}
    for slot, mg in enumerate(grads.get("meshes", ())):
        out.update({f"mesh{slot}.{f}": g for f, g in mg.items()})
    return out


def grad_deviation(a, b):
    """Per field, the largest |a - b| over the largest |a| (1e-6 at least)."""
    a, b = flat_grads(a), flat_grads(b)
    return {f: float((a[f].double().cpu() - b[f].double().cpu()).abs().max())
            / max(float(a[f].abs().max()), 1e-6) for f in a}


class ChoiceLog:
    """The per-bounce winning entity and alive flags of the first
    ``n_bounces`` traced bounces (a checkpointed step recomputes each bounce
    in its backward pass: only the forward's are kept)."""

    def __init__(self, W, n_bounces):
        self.W, self.n = W, n_bounces
        self.entity, self.alive = [], []
        self.real = (W.intersect_scene, W.trace_step)

    def __enter__(self):
        real_isect, real_step = self.real

        def isect(*a, **kw):
            rec = real_isect(*a, **kw)
            if len(self.entity) < self.n:
                self.entity.append(rec.entity.detach().cpu())
            return rec

        def step(*a, **kw):
            st = real_step(*a, **kw)
            if len(self.alive) < self.n:
                self.alive.append(st.alive.detach().cpu())
            return st

        self.W.intersect_scene, self.W.trace_step = isect, step
        return self

    def __exit__(self, *exc):
        self.W.intersect_scene, self.W.trace_step = self.real


def card_against_cpu(where, T, world, bins, cfg, o, d, seed):
    """The differentiable step at WSTEP_N_CPU rays, no compaction, on the card
    and on CPU tensors (the plain versions of the kernels), on the same
    host-drawn uniforms. The lanes whose per-bounce entity and alive flags
    differ are masked on both sides (their target is the run's own
    radiance, so they add nothing to the loss or the gradient); at most
    MAX_FLIP of them. Loss within CPU_LOSS_RTOL, each gradient field within
    CPU_GRAD_TOL of its largest entry."""
    from source_tpu_torch.tracer import wavefront as W
    cfg = dataclasses.replace(cfg, compact_schedule=())
    step = max(1, o.shape[0] // WSTEP_N_CPU)
    o, d = o[::step][:WSTEP_N_CPU].cpu(), d[::step][:WSTEP_N_CPU].cpu()
    spectral = T.SpectralConfig(375.0, 740.0, bins)
    scenes_by = {"cuda": T.compile_scene(world, spectral),
                 "cpu": T.compile_scene(world, spectral, device="cpu")}
    n_u = W._n_uniforms(scenes_by["cpu"])
    u_host = torch.rand((cfg.max_iters, o.shape[0], n_u),
                        generator=torch.Generator().manual_seed(seed))
    runs = {}
    for dev, scene in scenes_by.items():
        u_dev = u_host.to(dev)

        def same_u(start, n_steps, n_lanes, u_dev=u_dev):
            return u_dev[start:start + n_steps, :n_lanes]

        with ChoiceLog(W, cfg.max_iters) as log:
            rad = T.render_batch(scene, cfg, o, d, u_all=same_u,
                                 differentiable=True, device=dev).radiance
        runs[dev] = dict(scene=scene, u=same_u, rad=rad.detach(),
                         entity=torch.stack(log.entity),
                         alive=torch.stack(log.alive))
    agree = ((runs["cuda"]["entity"] == runs["cpu"]["entity"])
             & (runs["cuda"]["alive"] == runs["cpu"]["alive"])).all(0)
    masked = int((~agree).sum())
    if masked > MAX_FLIP * o.shape[0]:
        fail(f"{where}: {masked} of {o.shape[0]} lanes choose otherwise on "
             "the card than on the CPU")
    out = {}
    for dev, r in runs.items():
        target = torch.where(agree.to(dev)[:, None], 0.0, r["rad"])
        out[dev] = T.render_loss_and_grads(r["scene"], cfg, o, d, target,
                                           u_all=r["u"], device=dev)
    loss_c, loss_p = float(out["cuda"][0]), float(out["cpu"][0])
    dev_ = grad_deviation(out["cpu"][1], out["cuda"][1])
    res = dict(rays=o.shape[0], bounces=cfg.max_iters, masked_lanes=masked,
               loss_card=loss_c, loss_cpu=loss_p,
               loss_rel_dev=abs(loss_c - loss_p) / abs(loss_p),
               grad_deviation=dev_)
    if not abs(loss_c - loss_p) <= CPU_LOSS_RTOL * abs(loss_p):
        fail(f"{where}: card against CPU, loss {loss_c} against {loss_p}")
    for f, x in dev_.items():
        if x > CPU_GRAD_TOL:
            fail(f"{where}: card against CPU, gradient of {f} differs by {x} "
                 "of its largest entry")
    return res


def kernel_device_ms(fn):
    """Device milliseconds of the kernels launched under ``fn()``, per
    kernel name, by ``torch.profiler`` (CUPTI), and their total."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.key] = per.get(ev.key, 0.0) + dt / 1e3
    return per, sum(per.values())


def wstep_case(name, T, fused, scene, cfg, o, d, bins, nonzero,
               mesh_nonzero, rad_vol_of=None):
    """One scene's differentiable wavefront step at full width, at
    remat_block 1 and 0, with its gates, walls, peak memory, and the
    card against the CPU."""
    from source_tpu_torch.tracer import wavefront as W
    n = o.shape[0]
    if fused.scene_tables(scene, cfg, general=True) is not None:
        fail(f"{name}: the scene should be outside the fused route")
    target = torch.zeros((n, bins), device="cuda")
    # kernel launches a traced bounce: K6 once in intersect_scene where the
    # scene has BVH tables, the mesh kernel once per mesh there and once per
    # closed mesh whose material is a volume (the midpoint probe)
    k6 = int(scene.leaf_bvh is not None)
    k7 = len(scene.meshes) + sum(
        1 for v in scene.volume_entities
        if v[5] >= 0 and scene.meshes[v[5]].closed)
    runs, peak, launches = {}, {}, {}
    for rb in (1, 0):
        c = dataclasses.replace(cfg, remat_block=rb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        gen = torch.Generator(device="cuda").manual_seed(WSTEP_SEED)
        loss, grads = T.render_loss_and_grads(scene, c, o, d, target, gen)
        torch.cuda.synchronize()
        launches[rb] = read_counts(fused)
        peak[rb] = torch.cuda.max_memory_allocated() - base
        passes = 2 if rb else 1  # the forward and the checkpoint's recompute
        want = dict(NO_LAUNCHES,
                    analytic_bvh_winner=k6 * passes * cfg.max_iters,
                    mesh_bvh_winner=k7 * passes * cfg.max_iters)
        if launches[rb] != want:
            fail(f"{name}[remat_block={rb}]: launches {launches[rb]}, want "
                 f"{want}")
        grad_gates(f"{name}[remat_block={rb}]", scene, loss, grads, nonzero,
                   mesh_nonzero)
        if any(t.requires_grad for t in (scene.leaf_w2l, scene.mat_spectra)):
            fail(f"{name}: the caller's scene was left requiring gradients")
        runs[rb] = (loss, grads)
    (l1, g1), (l0, g0) = runs[1], runs[0]
    if not abs(float(l1) - float(l0)) <= REMAT_LOSS_RTOL * abs(float(l0)):
        fail(f"{name}: loss at remat_block 1 {float(l1)}, at 0 {float(l0)}")
    remat_dev = grad_deviation(g0, g1)
    for f, x in remat_dev.items():
        if x > REMAT_GRAD_TOL:
            fail(f"{name}: gradient of {f} differs between remat_block 1 and "
                 f"0 by {x} of its largest entry")
    rad_cross = 0.0
    if rad_vol_of is not None:
        rad_cross = rad_vol_of(scene, cfg, o, d)
    euler = euler_ratio(scene, l1, g1, rad_cross)
    if abs(euler - 1.0) > EULER_TOL:
        fail(f"{name}: Euler identity on the emission rows: "
             f"sum(value * gradient) / (2 loss) = {euler}")

    def walls(fn):
        out = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out[1:])), out[1:]

    def step(rb):
        return lambda: T.render_loss_and_grads(
            scene, dataclasses.replace(cfg, remat_block=rb), o, d, target,
            torch.Generator(device="cuda").manual_seed(WSTEP_SEED))

    wall = {rb: walls(step(rb)) for rb in (1, 0)}
    fwd_wall = walls(lambda: T.render_batch(
        scene, cfg, o, d,
        torch.Generator(device="cuda").manual_seed(WSTEP_SEED)))
    return dict(rays=n, bins=bins, max_depth=cfg.max_depth,
                max_iters=cfg.max_iters, compact_schedule=cfg.compact_schedule,
                loss=float(l1), euler=euler, launches=launches,
                launches_per_bounce=dict(analytic_bvh_winner=k6,
                                         mesh_bvh_winner=k7),
                remat_loss_rel_dev=abs(float(l1) - float(l0)) / abs(float(l0)),
                remat_grad_deviation=remat_dev,
                grad_max={f: float(g.abs().max())
                          for f, g in flat_grads(g1).items()},
                step_wall_ms={rb: w[0] for rb, w in wall.items()},
                step_walls_ms={rb: w[1] for rb, w in wall.items()},
                peak_bytes=peak, forward_wall_ms=fwd_wall[0],
                forward_walls_ms=fwd_wall[1],
                step=step(1))


def add_kernel_times(cases):
    """K6's and K7's device time inside one step at remat_block 1, by the
    profiler; both kernels are named ``winner_kernel``, and the CSG demo's
    step launches K6 alone, which tells their signatures apart."""
    per = {k: kernel_device_ms(row.pop("step")) for k, row in cases.items()}
    if not all(total > 0.0 for _, total in per.values()):
        fail(f"wstep: the profiler saw no device time: {per}")
    k6_keys = {k for k in per["csg"][0] if "winner_kernel" in k}
    for name, (ms, total) in per.items():
        cases[name]["kernel_ms_in_step"] = dict(
            analytic_bvh_winner=sum(v for k, v in ms.items() if k in k6_keys),
            mesh_bvh_winner=sum(v for k, v in ms.items()
                                if "winner_kernel" in k and k not in k6_keys))
        cases[name]["profiler_device_ms_total"] = total


def phase_wstep(T, fused, scenes):
    """The training step through the wavefront route: the CSG demo and the
    mesh demo at full width."""
    cases = {}
    scene, cfg, o, d = csg_setup(T, scenes)
    cfg = dataclasses.replace(cfg, max_iters=WSTEP_ITERS)
    cases["csg"] = wstep_case("wstep/csg", T, fused, scene, cfg, o, d,
                              CSG["bins"],
                              ("leaf_w2l", "leaf_params", "mat_spectra"), ())
    cases["csg"]["card_against_cpu"] = card_against_cpu(
        "wstep/csg", T, scenes.csg_world(), CSG["bins"], cfg, o, d, 31)
    scene, cfg, o, d = mesh_setup(T, scenes)
    cases["mesh"] = wstep_case("wstep/mesh", T, fused, scene, cfg, o, d,
                               MESH["bins"],
                               ("leaf_w2l", "leaf_params", "mat_spectra"),
                               ("vertices", "w2l"))
    cases["mesh"]["card_against_cpu"] = card_against_cpu(
        "wstep/mesh", T, scenes.mesh_world(), MESH["bins"], cfg, o, d, 32)
    add_kernel_times(cases)
    emit("wstep", cases=cases,
         tolerance=dict(remat_loss_rtol=REMAT_LOSS_RTOL,
                        remat_grad=REMAT_GRAD_TOL, cpu_loss_rtol=CPU_LOSS_RTOL,
                        cpu_grad=CPU_GRAD_TOL, euler=EULER_TOL,
                        max_masked=MAX_FLIP))
    return {k: v["launches"][1] for k, v in cases.items()}


def volume_cross(T, scene, cfg, o, d):
    """mean(radiance * the inhomogeneous volumes' part of it) on the step's
    uniforms: the forward route once as it is and once with every emission
    row zeroed, which leaves the volumes' part alone (the rows do not steer
    a path)."""
    from source_tpu_torch.tracer import wavefront as W
    dark = scene.mat_spectra.clone()
    for m, k in emission_rows(scene):
        dark[m, k] = 0.0
    rad = {}
    for key, s in (("all", scene),
                   ("volume", dataclasses.replace(scene, mat_spectra=dark))):
        gen = torch.Generator(device="cuda").manual_seed(WSTEP_SEED)
        rad[key] = W.trace_rays(s, cfg, T.init_rays(o, d, s.bins),
                                gen).radiance
    return float((rad["all"] * rad["volume"]).mean())


def phase_modifiers(T, fused, scenes):
    """The modifiers, user BSDFs and the inhomogeneous volume on the
    wavefront route: ``modifier_world`` at the CSG demo's camera and ray
    configuration, forward and differentiable."""
    from source_tpu_torch.tracer import intersect as I
    from source_tpu_torch.tracer import wavefront as W
    bins = CSG["bins"]
    scene = T.compile_scene(scenes.modifier_world(),
                            T.SpectralConfig(375.0, 740.0, bins))
    cfg = dataclasses.replace(csg_setup_cfg(T), max_iters=WSTEP_ITERS)
    o, d = scenes.camera_rays(MOD_RAYS, MOD_RAYS, CSG["fov"], CSG["position"])
    o, d = torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()
    n = o.shape[0]
    if fused.scene_tables(scene, cfg) is not None:
        fail("modifiers: modifier_world should be outside the fused route")
    if not (scene.mix_remaps and scene.custom_materials and scene.has_roughen
            and any(v[2] == 3 for v in scene.volume_entities)):
        fail("modifiers: modifier_world lacks one of its paths")

    # forward: one render_batch, trace_step calls counted beside the launches
    calls = [0]
    real_step = W.trace_step

    def counting_step(*a, **kw):
        calls[0] += 1
        return real_step(*a, **kw)

    W.trace_step = counting_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fused)
        gen = torch.Generator(device="cuda").manual_seed(WSTEP_SEED)
        st = T.render_batch(scene, cfg, o, d, gen)
        torch.cuda.synchronize()
        launches = read_counts(fused)
        fwd_peak = torch.cuda.max_memory_allocated() - base
    finally:
        W.trace_step = real_step
    if launches != dict(NO_LAUNCHES, analytic_bvh_winner=calls[0]) or not (
            1 <= calls[0] <= cfg.max_iters):
        fail(f"modifiers: want one analytic_bvh_winner launch per traced "
             f"bounce ({calls[0]}) and nothing else: {launches}")
    rad = st.radiance
    if tuple(rad.shape) != (n, bins) or not bool(torch.isfinite(rad).all()):
        fail("modifiers: radiance has the wrong shape or is not finite")
    # every material's lanes (by the entity the camera ray hits first)
    # receive radiance
    with torch.no_grad():
        first = I.intersect_scene(scene, o, d, need_grad=False).entity
    lit = {}
    for e in range(scene.n_entities):
        m = first == e
        lit[e] = dict(
            material=scene.mat_types[scene.entity_material_static[e]],
            lanes=int(m.sum()),
            mean_radiance=float(rad[m].mean()) if bool(m.any()) else 0.0)
        if not lit[e]["mean_radiance"] > 0.0:
            fail(f"modifiers: the lanes of entity {e} receive no radiance: "
                 f"{lit[e]}")
    case = wstep_case("modifiers", T, fused, scene, cfg, o, d, bins,
                      ("leaf_w2l", "leaf_params", "mat_spectra",
                       "entity_w2l"), (),
                      rad_vol_of=lambda *a: volume_cross(T, *a))
    case["card_against_cpu"] = card_against_cpu(
        "modifiers", T, scenes.modifier_world(), bins, cfg, o, d, 33)
    case.pop("step")
    emit("modifiers", forward=dict(
        rays=n, traced_bounces=calls[0], launches=launches,
        segments=int(st.segments), overflow=int(st.overflow),
        mean_radiance_per_bin=[round(float(x), 5) for x in rad.mean(0)],
        peak_bytes=fwd_peak, first_hit=lit), step=case)
    return dict(forward=launches, step=case["launches"][1])


# --- observers and pipelines (phase observers) --------------------------------

# the suite's five scenes at the settings of benchmarks/suite.py (the line
# of each bench_* function), and the route each must take: fused for the
# scenes fused.scene_tables accepts, wavefront for CSG and meshes
SUITE = {
    "cornell": dict(line=63, route="fused", pixels=(256, 256), fov=45, spp=64,
                    bins=15, max_depth=16, iters=24, schedule=((3, 4), (3, 4))),
    "prism": dict(line=80, route="wavefront", pixels=(256, 144), fov=45,
                  spp=32, bins=16,
                  spectral_rays=4, importance=True, path_weight=0.75,
                  max_depth=32, iters=40, schedule="auto"),
    "csg": dict(line=103, route="wavefront", pixels=(256, 256), fov=75,
                spp=64, bins=15, max_depth=24, iters=32,
                schedule=((4, 4), (4, 4))),
    "mis": dict(line=120, route="fused", pixels=(256, 192), fov=45, spp=64,
                bins=12,
                importance=True, path_weight=0.3, max_depth=12, iters=16,
                schedule=((3, 4), (3, 4))),
    "mesh": dict(line=140, route="wavefront", pixels=(192, 192), fov=45,
                 spp=32, bins=12,
                 max_depth=12, iters=16, schedule=((2, 8), (3, 4))),
}
OBS_REPEATS = 3         # timed passes a scene (the suite takes 9)
OBS_STALL_BUDGET = 6    # passes below half the best rate re-run, at most
OBS_FRAME_RTOL, OBS_FRAME_ATOL = 1e-4, 1e-6  # tests/test_torch_observers.py
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "data", "cornell_golden_blocks.npy")


def suite_world(T, scenes, name):
    """The scene's world and camera transform (benchmarks/suite.py)."""
    tr, rot = T.translate, T.rotate
    if name == "cornell":
        return scenes.cornell_box(glass=False), tr(0, 0, -3.3)
    if name == "prism":
        return scenes.prism_world(), (tr(0, 0.075, -0.05) * rot(180, -45, 0)
                                      * tr(0, 0, -0.75))
    if name == "csg":
        return scenes.csg_world(), tr(0, 0, -4)
    if name == "mis":
        return scenes.mis_world(), tr(0, 1.2, -3.5) * rot(0, -5, 0)
    return scenes.mesh_world(small=True), tr(0, 1.0, -4.5) * rot(0, -8, 0)


def suite_camera(T, O, scenes, name, device="cuda", pixels=None):
    s = SUITE[name]
    world, transform = suite_world(T, scenes, name)
    rgb = O.RGBPipeline2D()
    cam = O.PinholeCamera(pixels or s["pixels"], fov=s["fov"], parent=world,
                          transform=transform, pipelines=[rgb], device=device)
    cam.pixel_samples = s["spp"]
    cam.spectral_bins = s["bins"]
    cam.spectral_rays = s.get("spectral_rays", 1)
    if "importance" in s:
        cam.ray_importance_sampling = s["importance"]
        cam.ray_important_path_weight = s["path_weight"]
    cam.ray_max_depth = s["max_depth"]
    cam.max_wavefront_iters = s["iters"]
    cam.compact_schedule = s["schedule"]
    return cam, rgb


def observe_timed(cam):
    """benchmarks/suite.py ``_observe_timed``: one warm pass, then timed
    passes with ``accumulate=False`` (OBS_REPEATS of them, the suite's 9
    would push the script past its time); a pass below half the best rate
    so far counts as a stall and is run again (OBS_STALL_BUDGET at most).
    The kept rates are 25 %-trimmed at both ends; returns the median and
    spread of the trimmed set, the stalls, and every pass's figures."""
    cam.quiet = True
    cam.observe(seed=1)
    rates, passes, stalls, seed = [], [], 0, 2
    while len(rates) < OBS_REPEATS and stalls <= OBS_STALL_BUDGET:
        for p in cam.pipelines:
            if hasattr(p, "accumulate"):
                p.accumulate = False
        cam.observe(seed=seed)
        seed += 1
        r = cam.rays_per_second
        passes.append(dict(rays_per_s=r, render_time_s=cam.render_time,
                           segments=cam._stats_rays,
                           overflow=cam.compaction_overflow))
        if rates and r < 0.5 * max(rates):
            stalls += 1
            continue
        rates.append(r)
    rates.sort()
    k = len(rates) // 4
    trimmed = rates[k: len(rates) - k] if len(rates) > 2 * k else rates
    median = trimmed[len(trimmed) // 2]
    return median, (trimmed[-1] - trimmed[0]) / median, stalls, passes


class CallCount:
    """Counts the calls of module functions (the functions that trace one
    bounce and one fused span), to derive the launches a pass must make."""

    def __init__(self, *targets):
        self.n = {}
        self.undo = []
        for module, name in targets:
            real = getattr(module, name)
            self.n[name] = 0

            def counted(*a, _real=real, _name=name, **kw):
                self.n[_name] += 1
                return _real(*a, **kw)
            setattr(module, name, counted)
            self.undo.append((module, name, real))

    def restore(self):
        for module, name, real in self.undo:
            setattr(module, name, real)


def route_launches(scene, steps, spans):
    """The launches of the kernels of a scene's route, given its traced
    bounces (``trace_step`` calls: the wavefront route and the "auto"
    schedule's profile) and its fused spans (``fused_forward_span`` calls):
    one fused_span_fwd a span; per bounce one analytic_bvh_winner when the
    scene has the leaf BVH, one mesh_bvh_winner per mesh and per closed mesh
    a volume probes; nothing else."""
    probes = sum(1 for v in scene.volume_entities
                 if v[5] >= 0 and scene.meshes[v[5]].closed)
    return dict(NO_LAUNCHES, fused_span_fwd=spans,
                analytic_bvh_winner=steps if scene.leaf_bvh is not None else 0,
                mesh_bvh_winner=steps * (len(scene.meshes) + probes))


def route_calls(cam, s):
    """The calls of a pass on the scene's own route, from the camera's
    settings alone: a trace per tile, sample chunk and spectral slice; on
    the fused route exactly one fused span per stage of the explicit
    schedule (and one for the bounces left after it) and no traced bounce;
    on the wavefront route no fused span and between one and ``iters``
    traced bounces a trace (early exit), plus the "auto" schedule's profile
    of ``iters`` bounces. Returns (traces, fused spans, least and most
    traced bounces)."""
    n_pixels = int(np.prod(s["pixels"]))
    tile = int(cam.tile_size)
    spp = s["spp"]
    spt = max(1, min(int(cam.samples_per_task or spp), spp))
    traces = (-(-n_pixels // tile)) * (-(-spp // spt)) * s.get("spectral_rays", 1)
    if s["route"] == "wavefront":
        profile = s["iters"] if s["schedule"] == "auto" else 0
        return traces, 0, traces, traces * s["iters"] + profile
    if s["schedule"] == "auto":
        fail("observers: a fused suite scene needs an explicit schedule")
    done, spans = 0, 0
    for steps, _divisor in s["schedule"]:
        steps = min(steps, s["iters"] - done)
        if steps <= 0:
            break
        done, spans = done + steps, spans + 1
    spans += done < s["iters"]
    return traces, traces * spans, 0, 0


def span_inputs_against_plain(T, O, fused, scenes, name):
    """fused_span_fwd at the main path's own inputs: one observe() of a
    suite scene records the spans of its first trace (the scene's bins, the
    camera's ray config and rays, the widths its compaction leaves) as the
    observer launched them; each is then held against span_fwd_plain by the
    gates of phase kernels (the recorded launches are not counted)."""
    s = SUITE[name]
    cam, _rgb = suite_camera(T, O, scenes, name)
    cam.quiet = True
    traces, spans = route_calls(cam, s)[:2]
    n_first = spans // traces
    real, calls = fused.fused_forward_span, []

    def record(tab, desc, spec, state, u_all=None, **kw):
        # the packed state and uniforms the span's fused_span_fwd receives
        if u_all is not None and len(calls) < n_first:
            calls.append((spec, tab, desc, fused.pack_state(state),
                          fused.pack_u(u_all.to(torch.float32))))
        return real(tab, desc, spec, state, u_all, **kw)

    fused.fused_forward_span = record
    try:
        cam.observe(seed=7)
    finally:
        fused.fused_forward_span = real
    if len(calls) != n_first:
        fail(f"observers: {name}: recorded {len(calls)} spans of the first "
             f"trace, want {n_first}")
    return [span_against_plain(f"{name}_trace0_span{i}", fused, spec, tab,
                               desc, st, u)
            for i, (spec, tab, desc, st, u) in enumerate(calls)]


def observe_breakdown(T, fused, cam):
    """One instrumented pass. Its launches, counted from 0, beside the
    launches its traced bounces and fused spans require of its route; and
    host milliseconds (synchronised around each stage) in the schedule's
    profile, the camera rays, ``trace_rays``, the pipelines' projections
    and the sample sums; the rest of ``render_time`` is the tile and slice
    loop, the pull and the fold."""
    from source_tpu_torch.optical.observer import base as B
    from source_tpu_torch.optical.observer import pipelines as P
    from source_tpu_torch.tracer import wavefront as W
    scene = T.compile_scene(cam.root, T.SpectralConfig(
        cam.min_wavelength, cam.max_wavelength, cam.spectral_bins))
    clock = StageClock()
    for module, name, stage in (
            (B.ObserverBase, "_resolve_compact_schedule", "schedule"),
            (B.ObserverBase, "_camera_rays", "camera_rays"),
            (B, "trace_rays", "trace_rays"),
            (P.RGBPipeline2D, "project", "project"),
            (B, "_reduce_samples", "reduce")):
        clock.wrap(module, name, stage)
    calls = CallCount((W, "trace_step"), (fused, "fused_forward_span"))
    try:
        torch.cuda.synchronize()
        reset_counts(fused)
        cam.observe(seed=99)
        torch.cuda.synchronize()
        launches = read_counts(fused)
    finally:
        calls.restore()
        clock.restore()
    want = route_launches(scene, calls.n["trace_step"],
                          calls.n["fused_forward_span"])
    stages = dict(clock.ms)
    # the schedule's camera rays are inside "schedule"
    stages["camera_rays"] = (stages.get("camera_rays", 0.0)
                             - clock.within.get(("schedule", "camera_rays"), 0.0))
    render_ms = cam.render_time * 1e3
    stages["loop_pull_fold"] = render_ms - sum(stages.values())
    return launches, want, dict(calls.n), dict(render_ms=render_ms,
                                               stages_ms=stages)


def observer_furnace(T, O, engine=None, where="observers"):
    """Observers inside a unity emitter read exactly 1.0 in every bin: a
    2D camera of unit-weight rays with a spectral radiance pipeline, and a
    0D sight line (one task in a tile of 8), through ``engine``."""
    out = {}
    for name in ("orthographic", "sightline"):
        world = T.World()
        from source_tpu_torch.optical.material import UnitySurfaceEmitter
        from source_tpu_torch.primitive import Sphere
        Sphere(10.0, parent=world, material=UnitySurfaceEmitter())
        if name == "orthographic":
            pipe = O.SpectralRadiancePipeline2D()
            obs = O.OrthographicCamera((64, 64), width=1.0, parent=world,
                                       pipelines=[pipe])
            obs.pixel_samples = 16
        else:
            pipe = O.SpectralRadiancePipeline0D()
            obs = O.SightLine(parent=world, pipelines=[pipe])
            obs.pixel_samples = 64
        obs.spectral_bins = 8
        obs.render_engine = engine
        obs.quiet = True
        obs.observe(seed=3)
        mean = np.asarray(pipe.frame.mean)
        if not bool(np.all(mean == 1.0)):
            fail(f"{where}: furnace through {name} reads "
                 f"{float(mean.min())}..{float(mean.max())}, not exactly 1.0")
        out[name] = dict(bins=8, samples=int(np.asarray(pipe.frame.samples).min()),
                         max_variance=float(np.asarray(pipe.frame.variance).max()))
    return out


def golden_gate(T, O, scenes):
    """tests/test_golden.py's three assertions on the port's render: the
    glass Cornell box, 64x64 pixels, 64 spp, seed 54321, against the
    reference's golden XYZ block means."""
    rgb = O.RGBPipeline2D(accumulate=True, name="golden")
    cam = O.PinholeCamera((64, 64), parent=scenes.cornell_box(glass=True),
                          pipelines=[rgb])
    cam.transform = T.translate(0, 0, -3.3)
    cam.pixel_samples = 64
    cam.spectral_bins = 15
    cam.ray_max_depth = 24
    cam.max_wavefront_iters = 32
    cam.ray_extinction_prob = 0.05
    cam.quiet = True
    cam.observe(seed=54321)
    golden = np.load(GOLDEN)
    blocks = rgb.xyz_frame.mean.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))
    lum_dev = abs(blocks[..., 1].mean() - golden[..., 1].mean()) / golden[..., 1].mean()
    rel = np.abs(blocks[..., 1] - golden[..., 1]) / np.maximum(golden[..., 1], 0.05)
    red, green = blocks[0, 4], blocks[7, 4]
    red_ratio = red[0] / max(red[1], 1e-6)
    green_ratio = green[0] / max(green[1], 1e-6)
    out = dict(mean_luminance_rel_dev=float(lum_dev),
               block_rel_dev_p90=float(np.percentile(rel, 90)),
               red_block_x_over_y=float(red_ratio),
               green_block_x_over_y=float(green_ratio),
               schedule=cam._auto_schedule_cache[1])
    if not (lum_dev < 0.05 and out["block_rel_dev_p90"] < 0.25
            and red_ratio > green_ratio):
        fail(f"observers: the golden Cornell blocks do not hold: {out}")
    return out


def injected_streams(n_uniforms):
    """Streams that depend only on the site, made on the CPU: the same
    uniforms for a card run and a CPU run of one observation."""
    import zlib

    def gen(*key):
        return torch.Generator().manual_seed(zlib.crc32(repr(key).encode()))

    def camera_u(site, shape):
        return torch.rand(shape, generator=gen(site))

    def u_all(site, start, n_steps, n_lanes):
        return torch.rand((n_steps, n_lanes, n_uniforms),
                          generator=gen(site, start))

    def shifts(site, done, alive):
        return int(torch.randint(0, max(alive, 1), (), generator=gen(site, done)))

    return dict(camera_u=camera_u, u_all=u_all, shifts=shifts)


def card_against_cpu_observe(T, O, scenes, fused, pixels=(16, 16),
                             where="observers", engine=lambda device: None):
    """A small Cornell observation (no glass, 16x16 pixels unless given, 4
    spp, 5 bins, tiles of 128 pixels, two sample chunks, one compaction
    stage) with the same injected uniforms on the card and on CPU tensors,
    through ``engine(device)``: frames within the CPU parity test's
    tolerances on all but 0.5 % of the lanes' pixels, traced segments within
    that share."""
    frames, segs = {}, {}
    n_pixels = int(np.prod(pixels))
    for device in ("cuda", "cpu"):
        rgb, spec = O.RGBPipeline2D(), O.SpectralRadiancePipeline2D()
        cam = O.PinholeCamera(pixels, parent=scenes.cornell_box(glass=False),
                              transform=T.translate(0, 0, -3.3),
                              pipelines=[rgb, spec], device=device,
                              render_engine=engine(device))
        cam.pixel_samples = 4
        cam.spectral_bins = 5
        cam.max_wavefront_iters = 8
        cam.tile_size = 128
        cam.samples_per_task = 2
        cam.compact_schedule = ((3, 2),)
        cam.quiet = True
        cam.observe(seed=5, **injected_streams(fused.N_UNIFORMS))
        frames[device] = (rgb.xyz_frame, spec.frame)
        segs[device] = cam._stats_rays
    lanes = n_pixels * 4
    allowed = max(1, int(MAX_FLIP * lanes))
    apart = {}
    for k, (a, b) in zip(("rgb", "spectral"), zip(frames["cuda"], frames["cpu"])):
        for f in ("mean", "variance"):
            x = np.asarray(getattr(a, f)).reshape(n_pixels, -1)
            y = np.asarray(getattr(b, f)).reshape(n_pixels, -1)
            if not np.isfinite(x).all():
                fail(f"{where}: card frame {k} {f} is not finite")
            apart[f"{k}_{f}"] = int((~np.isclose(
                x, y, rtol=OBS_FRAME_RTOL * (10 if f == "variance" else 1),
                atol=OBS_FRAME_ATOL).all(-1)).sum())
    seg_dev = abs(segs["cuda"] - segs["cpu"]) / segs["cpu"]
    out = dict(pixels=n_pixels, lanes=lanes, allowed_pixels=allowed,
               pixels_apart=apart, segments=segs, segments_rel_dev=seg_dev)
    if max(apart.values()) > allowed or seg_dev > MAX_FLIP:
        fail(f"{where}: card and CPU disagree on the small observation: {out}")
    return out


def phase_observers(T, fused, scenes):
    """The observer layer: the furnace through observers, the golden
    Cornell blocks, the card against the CPU on one small observation, and
    the five scenes of benchmarks/suite.py at its sizes, each timed by the
    suite's protocol with its launches counted and held to its route's."""
    from source_tpu_torch.optical import observer as O
    furnace = observer_furnace(T, O)
    golden = golden_gate(T, O, scenes)
    cpu = card_against_cpu_observe(T, O, scenes, fused)
    # the MIS scene is the one fused scene at 12 bins: its forward library
    # is held to the plain version here only
    k3_mis = span_inputs_against_plain(T, O, fused, scenes, "mis")
    rows = {}
    for name in SUITE:
        t0 = time.perf_counter()
        cam, rgb = suite_camera(T, O, scenes, name)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        median, spread, stalls, passes = observe_timed(cam)
        peak = torch.cuda.max_memory_allocated() - base
        frame = np.asarray(rgb.xyz_frame.mean)
        if not np.isfinite(frame).all() or not frame.mean() >= 0.0:
            fail(f"observers: {name}: the frame is not finite or its mean is "
                 f"negative ({frame.mean()})")
        launches, want, calls, breakdown = observe_breakdown(T, fused, cam)
        if launches != want or not any(launches.values()):
            fail(f"observers: {name}: want exactly its route's launches "
                 f"{want} (calls {calls}), got {launches}")
        s = SUITE[name]
        _traces, spans, least, most = route_calls(cam, s)
        if (calls["fused_forward_span"] != spans
                or not least <= calls["trace_step"] <= most):
            fail(f"observers: {name} must take the {s['route']} route: want "
                 f"{spans} fused spans and {least}..{most} traced bounces a "
                 f"pass, got {calls}")
        rows[name] = dict(
            suite_line=f"benchmarks/suite.py:{s['line']}",
            pixels=list(s["pixels"]), spp=s["spp"], bins=s["bins"],
            spectral_rays=s.get("spectral_rays", 1), max_depth=s["max_depth"],
            max_iters=s["iters"], compact_schedule=cam.compact_schedule,
            resolved_schedule=(cam._auto_schedule_cache[1]
                               if s["schedule"] == "auto" else s["schedule"]),
            route=s["route"], want_spans=spans, want_bounces=[least, most],
            rays_per_s_median=median, rays_per_s_spread=spread,
            stalls_excluded=stalls, timed_passes=passes,
            peak_bytes=peak, frame_mean_xyz=[float(v) for v in
                                             frame.reshape(-1, 3).mean(0)],
            launches_per_pass=launches, calls_per_pass=calls,
            breakdown=breakdown, wall_s=time.perf_counter() - t0)
    emit("observers", gpu=gpu_line(), furnace=furnace, golden=golden,
         card_against_cpu=cpu, fused_span_fwd_mis=k3_mis, scenes=rows)
    return {name: r["launches_per_pass"] for name, r in rows.items()}


# --- the per-ray entry points (phase queries) ---------------------------------

QUERY_TOL = 1e-5        # card against CPU tensors
QUERY_FAN = 256         # World.hit rays of each fan
CONTAINS_POINTS = 2048  # of the demo's 20 000: a World.contains call each
SAMPLE_COUNT = 1 << 20  # optical.Ray.sample's batch
LOG_H = (-0.008, -0.004, 0.0, 0.004, 0.008)  # demos/optics/logging_trajectories.py:30


def hit_fields(ix, prims):
    """An Intersection as its primitive's index, its exiting flag, its t,
    the hit, inside and outside points and the normal (13 floats), and for
    a mesh the triangle and barycentrics; None for a miss."""
    if ix is None:
        return None
    vals = [ix.ray_distance]
    for k in ("hit_point", "inside_point", "outside_point", "normal"):
        v = getattr(ix, k)
        vals += [v.x, v.y, v.z]
    out = dict(primitive=prims.index(ix.primitive), exiting=bool(ix.exiting),
               vals=np.asarray(vals))
    if hasattr(ix, "triangle"):
        out.update(triangle=ix.triangle, uvw=np.asarray([ix.u, ix.v, ix.w]))
    return out


def hits_apart(card, cpu):
    """Indices of the queries whose card answer differs from the CPU's: hit
    or miss, primitive, exiting, a value beyond QUERY_TOL, or another mesh
    triangle (allowed only at a tie within 1 ulp of t, as in phase
    mesh_kernels; the two triangles' hit points then agree, their
    barycentrics and normals need not). Returns (apart, ties)."""
    apart, ties = [], 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if (a is None) != (b is None):
            apart.append(i)
            continue
        if a is None:
            continue
        if a["primitive"] != b["primitive"] or a["exiting"] != b["exiting"]:
            apart.append(i)
            continue
        vals = slice(None)
        if a.get("triangle", -1) != b.get("triangle", -1):
            ulp = abs(int(np.float32(a["vals"][0]).view(np.int32))
                      - int(np.float32(b["vals"][0]).view(np.int32)))
            if ulp > 1:
                apart.append(i)
                continue
            ties += 1
            vals = slice(0, 4)  # t and the hit point
        elif "uvw" in a and not np.allclose(a["uvw"], b["uvw"], rtol=QUERY_TOL,
                                            atol=QUERY_TOL):
            apart.append(i)
            continue
        if not np.allclose(a["vals"][vals], b["vals"][vals], rtol=QUERY_TOL,
                           atol=QUERY_TOL):
            apart.append(i)
    return apart, ties


def query_fan(n, centre, spread, depth, rng):
    """``n`` rays from a disc ``depth`` in front of ``centre`` (along -z),
    aimed at it with a spread of directions, not unit length."""
    o = np.c_[rng.uniform(-spread, spread, (n, 2)) + centre[:2],
              np.full(n, centre[2] - depth)]
    d = np.c_[rng.uniform(-0.1, 0.1, (n, 2)), np.ones(n)]
    return o, d * rng.uniform(0.5, 2.0, (n, 1))


def world_hits(T, world, o, d, device):
    from source_tpu_torch.core import Ray
    prims = world.primitives
    return [hit_fields(world.hit(Ray(T.Point3D(*a), T.Vector3D(*b)),
                                 device=device), prims)
            for a, b in zip(o, d)]


def as_queried(o, d):
    """A batch of World.hit's rays as it hands them to intersect_scene:
    f32 origins, f32 directions divided by their f32 norm on the host."""
    o32 = np.asarray(o, np.float32)
    d32 = np.stack([x / float(np.linalg.norm(x))
                    for x in np.asarray(d, np.float32)])
    return torch.as_tensor(o32).cuda(), torch.as_tensor(d32).cuda()


def counted(fused, fn):
    """(result, launches of every kernel) of ``fn()``, counts from 0."""
    torch.cuda.synchronize()
    reset_counts(fused)
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(fused)


def want_only(launches, where, **want):
    """Fail unless exactly ``want`` were launched and nothing else."""
    if launches != dict(NO_LAUNCHES, **want):
        fail(f"queries: {where}: want exactly {want} launched, got "
             f"{ {k: v for k, v in launches.items() if v} }")


def hit_walk(T, scenes, device):
    """demos/core/ray_intersection_hitpoints.py:33-45: World.hit from the
    box's corner, relaunched from each hit's inside or outside point."""
    from source_tpu_torch.core import Ray
    world, _solid = scenes.hitpoints_world()
    ray = Ray(T.Point3D(0.45, 0.45, -2), T.Vector3D(0, 0, 1))
    out = []
    while len(out) < 16:
        ix = world.hit(ray, device=device)
        if ix is None:
            break
        out.append(hit_fields(ix, world.primitives))
        p2w = ix.primitive_to_world
        ray = Ray((ix.outside_point if ix.exiting else ix.inside_point)
                  .transform(p2w), ray.direction)
    return out


def query_hits(T, fused, scenes, bvh):
    """The hit walk and two fans of World.hit: on the hitpoints solid (one
    BVH item, below LEAF_BVH_MIN_LEAVES: the streaming route, no kernel)
    and on the logging demo's lens and screen (two items: one K6 launch a
    query); the card against CPU tensors; K6 at the lens fan's rays
    against its plain versions (bvh_case)."""
    walk, walk_launches = counted(fused, lambda: hit_walk(T, scenes, "cuda"))
    walk_cpu = hit_walk(T, scenes, "cpu")
    apart, _ = hits_apart(walk, walk_cpu)
    if len(walk) < 2 or len(walk) != len(walk_cpu) or apart:
        fail(f"queries: the hit walk crosses {len(walk)} surfaces on the card, "
             f"{len(walk_cpu)} on the CPU, apart at {apart}")
    want_only(walk_launches, "hit walk")
    rng = np.random.default_rng(41)
    out = dict(walk=dict(surfaces=len(walk), z_local=[w["vals"][3] for w in walk],
                         launches={k: v for k, v in walk_launches.items() if v}))
    fans = (("hitpoints", scenes.hitpoints_world()[0], (0.0, 0.0, 2.0), 0.7, 4.0),
            ("lens", scenes.logging_lens_world(), (0.0, 0.0, 0.003), 0.07, 0.05))
    for name, world, centre, spread, depth in fans:
        o, d = query_fan(QUERY_FAN, centre, spread, depth, rng)
        world.build_accelerator(device="cuda")
        t0 = time.perf_counter()
        card, launches = counted(fused, lambda: world_hits(T, world, o, d,
                                                           "cuda"))
        wall = time.perf_counter() - t0
        cpu = world_hits(T, world, o, d, "cpu")
        apart, _ = hits_apart(card, cpu)
        scene = world._build_query_scene("cuda")
        k6 = QUERY_FAN if scene.leaf_bvh is not None else 0
        want_only(launches, f"{name} fan", **({"analytic_bvh_winner": k6}
                                              if k6 else {}))
        hits = sum(h is not None for h in cpu)
        if apart or not 0 < hits < QUERY_FAN:
            fail(f"queries: {name} fan: {len(apart)} of {QUERY_FAN} queries "
                 f"differ between card and CPU ({hits} hits)")
        out[name] = dict(queries=QUERY_FAN, hits=hits, launches=k6,
                         bvh_items=len(scene.bvh_leaf_ids), ms_per_query=
                         wall * 1e3 / QUERY_FAN)
        if k6:
            oq, dq = as_queried(o, d)
            out[name]["analytic_bvh_winner"] = bvh_case(
                f"query_{name}_fan", scene, oq, dq,
                len(scene.bvh_leaf_ids) >= 64, bvh)
    return out


def contains_grid(T, world, pts, device):
    return [len(world.contains(T.Point3D(*p), device=device)) for p in pts]


def query_contains(T, fused, scenes):
    """demos/core/world_contains_point.py: World.contains over points
    uniform in [-0.6, 0.6]^3 around a sphere of radius 0.5 (2 048 of the
    demo's 20 000, each a call), card equal to CPU on every point, and the
    volume fraction within the demo's 5 % of the closed form."""
    from source_tpu_torch.optical.material import AbsorbingSurface
    from source_tpu_torch.primitive import Sphere
    world = T.World()
    Sphere(0.5, parent=world, material=AbsorbingSurface())
    pts = np.random.default_rng(0).uniform(-0.6, 0.6, (CONTAINS_POINTS, 3))
    world.build_accelerator(device="cuda")
    t0 = time.perf_counter()
    card, launches = counted(fused, lambda: contains_grid(T, world, pts, "cuda"))
    wall = time.perf_counter() - t0
    cpu = contains_grid(T, world, pts, "cpu")
    want_only(launches, "contains grid")
    differ = int(sum(a != b for a, b in zip(card, cpu)))
    theory = 4.0 / 3.0 * math.pi * 0.5 ** 3
    err = abs(np.mean(np.asarray(card) > 0) * 1.2 ** 3 - theory) / theory
    if differ or err >= 0.05:
        fail(f"queries: contains grid: {differ} points differ between card "
             f"and CPU, volume error {err}")
    return dict(points=CONTAINS_POINTS, demo_points=20000, differ=differ,
                volume_rel_err=err, ms_per_query=wall * 1e3 / CONTAINS_POINTS)


def query_mesh(T, fused, scenes):
    """World.hit and contains on a closed icosphere(3) mesh: the card's
    MeshIntersection (triangle, barycentrics) against the CPU's, a tie
    within 1 ulp of t allowed; one K7 launch a hit and one a contains (its
    +z probe); K7 against its plain versions at the hits' rays
    (mesh_case, with times and bound) and at the probes (mesh_parity)."""
    from source_tpu_torch.core import Ray
    from source_tpu_torch.optical.material import AbsorbingSurface
    from source_tpu_torch.primitive import Mesh
    from source_tpu_torch.tracer import mesh_bvh as mb
    from source_tpu_torch.tracer import meshtrace as mt
    world = T.World()
    Mesh(*scenes.icosphere(3), closed=True, parent=world,
         transform=T.translate(0, 0, 3) * T.rotate(20, 10, 0),
         material=AbsorbingSurface())
    rng = np.random.default_rng(43)
    o, d = query_fan(QUERY_FAN // 2, (0.0, 0.0, 3.0), 1.2, 3.0, rng)
    oi, di = ball_rays(QUERY_FAN // 2, 0.8, rng)
    o = np.concatenate([o, oi + [0.0, 0.0, 3.0]])
    d = np.concatenate([d, di])
    pts = np.concatenate([oi[:64] + [0.0, 0.0, 3.0],
                          rng.uniform(-1.5, 1.5, (64, 3)) + [0.0, 0.0, 3.0]])
    world.build_accelerator(device="cuda")
    card, hit_launches = counted(fused, lambda: world_hits(T, world, o, d,
                                                           "cuda"))
    cpu = world_hits(T, world, o, d, "cpu")
    want_only(hit_launches, "mesh hits", mesh_bvh_winner=len(o))
    apart, ties = hits_apart(card, cpu)
    inside, in_launches = counted(fused, lambda: contains_grid(T, world, pts,
                                                               "cuda"))
    want_only(in_launches, "mesh contains", mesh_bvh_winner=len(pts))
    differ = int(sum(a != b for a, b in zip(inside, contains_grid(
        T, world, pts, "cpu"))))
    hits = sum(h is not None for h in cpu)
    if apart or differ or not 0 < hits < len(o) or not 0 < sum(inside) < len(pts):
        fail(f"queries: mesh: {len(apart)} hits and {differ} contains differ "
             f"between card and CPU ({hits} hits, {sum(inside)} inside)")
    if not all("triangle" in h for h in card if h is not None):
        fail("queries: a mesh hit did not return a MeshIntersection")
    mesh = world._build_query_scene("cuda").meshes[0]
    oq, dq = as_queried(o, d)
    ol, dl = mesh_local(mesh, oq, dq)
    case = mesh_case("query_mesh_hits", mesh, ol, dl, min_advance(oq), mb, mt)
    pq = torch.as_tensor(pts, dtype=torch.float32).cuda()
    up = torch.zeros_like(pq)
    up[:, 2] = 1.0
    pl, ul = mesh_local(mesh, pq, up)
    probe = mesh_parity("query_mesh_probes", mesh, pl, ul,
                        torch.zeros_like(pq[:, 0]), mb, mt)[0]
    return dict(hits=hits, queries=len(o), ties=ties, points=len(pts),
                inside=int(sum(inside)), launches=dict(
                    hits=hit_launches["mesh_bvh_winner"],
                    contains=in_launches["mesh_bvh_winner"]),
                mesh_bvh_winner=case, probes=probe)


def query_sample(T, fused, scenes):
    """optical.Ray.sample in the unity-emitter furnace: one batch of
    SAMPLE_COUNT identical rays, 15 bins, max_depth 4 (12 iterations, one
    span): exactly 1.0 in every bin from exactly one fused_span_fwd launch;
    wall ms and peak device memory of the call; K3 against span_fwd_plain
    at the span's own inputs, recorded from a first call."""
    from source_tpu_torch.optical import Ray as OpticalRay
    world = scenes.furnace()
    ray = OpticalRay(origin=(0, 0, 0), direction=(0, 0, 1), bins=15,
                     extinction_prob=0.0, max_depth=4)
    real, calls = fused.fused_forward_span, []

    def record(tab, desc, spec, state, u_all=None, **kw):
        if u_all is not None:
            calls.append((spec, tab, desc, fused.pack_state(state),
                          fused.pack_u(u_all.to(torch.float32))))
        return real(tab, desc, spec, state, u_all, **kw)

    fused.fused_forward_span = record
    try:
        ray.sample(world, SAMPLE_COUNT, seed=1)
    finally:
        fused.fused_forward_span = real
    if len(calls) != 1:
        fail(f"queries: Ray.sample made {len(calls)} fused spans, want 1")
    k3 = span_against_plain("ray_sample_furnace", fused, *calls[0])
    del calls[:]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    spec, launches = counted(fused, lambda: ray.sample(world, SAMPLE_COUNT,
                                                       seed=2))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    want_only(launches, "Ray.sample", fused_span_fwd=1)
    if not bool((spec.samples == 1.0).all()):
        fail(f"queries: Ray.sample in the furnace reads {spec.samples}, not "
             "exactly 1.0")
    return dict(count=SAMPLE_COUNT, bins=15, max_depth=4, wall_ms=wall * 1e3,
                peak_bytes=peak, ray_count=ray.ray_count, fused_span_fwd=k3,
                launches=1)


def logging_traces(T, world, device, heights, max_depth=8):
    """LoggingRay.trace from (h, 0, -0.05) along +z for each height, the
    bounce uniforms made on the CPU from the bounce's index (the same on
    the card and the CPU): the path vertices and per-vertex records."""
    from source_tpu_torch.optical import LoggingRay

    def u_all(i, n_steps, n_lanes):
        g = torch.Generator().manual_seed(1000 + i)
        return torch.rand((n_steps, n_lanes, 10), generator=g).to(device)

    out = []
    for h in heights:
        ray = LoggingRay(origin=(h, 0.0, -0.05), direction=(0, 0, 1), bins=4,
                         max_depth=max_depth)
        spectrum = ray.trace(world, device=device, u_all=u_all)
        out.append((np.asarray(ray.path_vertices), ray.path_intersections,
                    spectrum))
    return out


def query_logging(T, fused, scenes):
    """LoggingRay: tests/test_core_utils.py::test_logging_ray's mirror and
    emitter on the card with that test's assertions, and the five lens
    trajectories of demos/optics/logging_trajectories.py, the card against
    CPU tensors within QUERY_TOL; exactly two K6 launches a bounce (the
    log's intersect_scene and trace_step's), 8 bounces a trace."""
    from source_tpu_torch.optical import LoggingRay
    from source_tpu_torch.optical.material import (
        PerfectReflectingSurface, UnitySurfaceEmitter,
    )
    from source_tpu_torch.primitive import Box, Sphere
    w = T.World()
    Sphere(radius=5.0, parent=w, material=UnitySurfaceEmitter())
    Box(lower=T.Point3D(-1, -1, 2), upper=T.Point3D(1, 1, 2.5), parent=w,
        material=PerfectReflectingSurface())
    ray = LoggingRay(origin=(0, 0, 0), direction=(0, 0, 1), bins=4, max_depth=8)
    spectrum, mirror_launches = counted(fused, lambda: ray.trace(w))
    recs, verts = ray.path_intersections, ray.path_vertices
    ok = (np.allclose(spectrum, 1.0, atol=1e-4) and len(verts) >= 3
          and abs(verts[1][2] - 2.0) < 1e-3 and verts[2][2] < 0
          and len(recs) == len(verts) - 1 and recs[0]["entity"] == 1
          and recs[1]["entity"] == 0 and recs[0]["material"] != recs[1]["material"]
          and not recs[0]["exiting"] and abs(recs[0]["normal"][2] + 1.0) < 1e-4
          and np.allclose(recs[1]["throughput"], 1.0, atol=1e-5))
    if not ok:
        fail(f"queries: LoggingRay's mirror and emitter on the card: "
             f"{spectrum}, {verts}")
    want_only(mirror_launches, "LoggingRay mirror", analytic_bvh_winner=16)
    world = scenes.logging_lens_world()
    card, lens_launches = counted(fused, lambda: logging_traces(
        T, world, "cuda", LOG_H))
    want_only(lens_launches, "LoggingRay lens", analytic_bvh_winner=16 * len(LOG_H))
    cpu = logging_traces(T, world, "cpu", LOG_H)
    worst = 0.0
    for (vc, rc, sc), (vp, rp, sp) in zip(card, cpu):
        if vc.shape != vp.shape or len(rc) != len(rp):
            fail(f"queries: a lens trajectory has {len(vc)} vertices on the "
                 f"card, {len(vp)} on the CPU")
        worst = max(worst, float(np.abs(vc - vp).max()),
                    float(np.abs(sc - sp).max()))
        for a, b in zip(rc, rp):
            for k in ("entity", "material", "exiting", "alive"):
                if a[k] != b[k]:
                    fail(f"queries: a lens trajectory's {k} differs")
            for k in ("hit_point", "normal", "throughput", "t", "origin"):
                worst = max(worst, float(np.abs(np.asarray(a[k], np.float64)
                                                - b[k]).max()))
    if worst > QUERY_TOL:
        fail(f"queries: lens trajectories differ by {worst} card to CPU")
    return dict(mirror_vertices=len(verts), lens_vertices=[len(v) for v, _, _ in card],
                max_abs_card_cpu=worst,
                launches=dict(mirror=16, lens=16 * len(LOG_H)))


def phase_queries(T, fused, scenes, bvh):
    """The per-ray entry points on the card, each against CPU tensors: the
    World.hit walk and fans, World.contains, a mesh's MeshIntersection and
    contains, optical.Ray.sample in the furnace, LoggingRay; each with its
    exact launches and the kernels it reaches held to their plain versions
    at its own inputs."""
    t0 = time.perf_counter()
    hits = query_hits(T, fused, scenes, bvh)
    contains = query_contains(T, fused, scenes)
    mesh = query_mesh(T, fused, scenes)
    sample = query_sample(T, fused, scenes)
    logging = query_logging(T, fused, scenes)
    emit("queries", gpu=gpu_line(), tolerance=QUERY_TOL, hits=hits,
         contains=contains, mesh=mesh, sample=sample, logging=logging,
         wall_s=time.perf_counter() - t0)
    return dict(
        analytic_bvh_winner=dict(lens_fan=hits["lens"]["launches"],
                                 logging_mirror=logging["launches"]["mirror"],
                                 logging_lens=logging["launches"]["lens"]),
        mesh_bvh_winner=mesh["launches"], fused_span_fwd=dict(ray_sample=1),
        k6_row=hits["lens"]["analytic_bvh_winner"],
        k7_row=mesh["mesh_bvh_winner"], k3_row=sample["fused_span_fwd"])


# --- the lens demos observed (phase lenses) -------------------------------------

# demos/observers/*: the image size, bins and depth of each, nothing cut but
# the samples (250 a pixel in both demos, 8 here). The passes are paced by
# the host, a traced bounce at a time (10.5 ms a bounce at the observer's
# default tile of 4 096 pixels: 21.5 s a Cooke pass), so the timed passes
# take tiles of LENS_TILE pixels, a quarter of the bounces for the same rays
LENS_TILE = 16384
LENS_DEMOS = {
    "cooke": dict(source="demos/observers/cornell_box_cooke_triplet.py:68-80",
                  pixels=(360, 360), spp=8, demo_spp=250, bins=15,
                  max_depth=500, iters=64),
    "metal": dict(source="demos/observers/metal_with_lens.py:60-72",
                  pixels=(360, 240), spp=8, demo_spp=250, bins=20,
                  max_depth=100, iters=64),
}


def lens_camera(T, O, scenes, name, device="cuda", pixels=None):
    """The demo's TargetedCCDArray and pipelines on the port's world."""
    s = LENS_DEMOS[name]
    if name == "cooke":
        world, parent, aperture = scenes.cooke_triplet_world()
        pipes = [O.RGBPipeline2D(display_unsaturated_fraction=0.96)]
        kw = dict(transform=T.rotate(0, 0, 180), width=0.035)
    else:
        from source_tpu_torch.optical.colour import ciexyz_x, ciexyz_y, ciexyz_z
        world, parent, aperture = scenes.metal_lens_world()
        pipes = [O.RGBPipeline2D(display_unsaturated_fraction=0.98),
                 O.BayerPipeline2D(ciexyz_x, ciexyz_y, ciexyz_z,
                                   display_unsaturated_fraction=0.98)]
        kw = {}
    cam = O.TargetedCCDArray(targets=[aperture], parent=parent, pipelines=pipes,
                             pixels=pixels or s["pixels"], device=device, **kw)
    cam.pixel_samples = s["spp"]
    cam.spectral_bins = s["bins"]
    cam.ray_max_depth = s["max_depth"]
    cam.max_wavefront_iters = s["iters"]
    cam.tile_size = LENS_TILE
    cam.quiet = True
    return cam, pipes[0]


def lens_passes(T, fused, cam, record=None, repeats=OBS_REPEATS,
                where="lenses"):
    """One warm pass, then ``repeats`` timed passes (``accumulate=False``),
    each with its launches counted from 0 and held exactly to its route's:
    one K6 a traced bounce (the schedule's profile included), no fused
    span; ``record``, if given, wraps the warm pass. Returns the timed
    passes' figures and the median rays/s."""
    from source_tpu_torch.tracer import wavefront as W
    scene = T.compile_scene(cam.root, T.SpectralConfig(
        cam.min_wavelength, cam.max_wavelength, cam.spectral_bins))
    calls = CallCount((W, "trace_step"), (fused, "fused_forward_span"))
    passes = []
    try:
        for p in range(1 + repeats):
            if p:
                for pipe in cam.pipelines:
                    if hasattr(pipe, "accumulate"):
                        pipe.accumulate = False
            calls.n = dict.fromkeys(calls.n, 0)
            with (record() if record and not p else contextlib.nullcontext()):
                _, launches = counted(fused, lambda: cam.observe(seed=1 + p))
            want = route_launches(scene, calls.n["trace_step"],
                                  calls.n["fused_forward_span"])
            if (launches != want or calls.n["fused_forward_span"]
                    or not launches["analytic_bvh_winner"]):
                fail(f"{where}: want exactly the wavefront route's launches "
                     f"{want} (calls {calls.n}), got {launches}")
            if p:
                passes.append(dict(
                    rays_per_s=cam.rays_per_second, render_time_s=cam.render_time,
                    segments=cam._stats_rays, overflow=cam.compaction_overflow,
                    traced_bounces=calls.n["trace_step"],
                    analytic_bvh_winner=launches["analytic_bvh_winner"],
                    mesh_bvh_winner=launches["mesh_bvh_winner"]))
    finally:
        calls.restore()
    rates = [x["rays_per_s"] for x in passes]
    median = float(np.median(rates))
    return passes, median, (max(rates) - min(rates)) / median


@contextlib.contextmanager
def kernel_recorder(out, busiest=False):
    """Records, from the first trace of a pass that reaches a third bounce
    (with ``busiest``: from the trace whose camera rays hit the scene's mesh
    most often, or the leaf BVH's items in a scene without a mesh), the
    scene and the inputs of the analytic-BVH kernel's first and third
    launches (``out[0]``, ``out[2]``: the camera rays and the third bounce's
    rays, parked as trace_step parks them) and, for a scene with a mesh, of
    the mesh kernel's (``out["mesh", 0]``, ``out["mesh", 2]``: the tables
    and the local-frame rays of its one mesh); ``out["hits"]``, the camera
    rays' hits. A trace whose rays all leave the scene (a tile of sky) ends
    before its third bounce."""
    from source_tpu_torch.optical.observer import base as B
    from source_tpu_torch.tracer import intersect as I
    from source_tpu_torch.tracer import meshtrace as MT
    real_k6, real_k7, real_trace = (I.analytic_bvh_winner, MT.mesh_bvh_winner,
                                    B.trace_rays)
    buf = {}

    def trace(scene, *a, **kw):
        buf.clear()
        buf.update(k6=0, k7=0, on=busiest or not out)
        res = real_trace(scene, *a, **kw)
        need = [0, 2] + ([("mesh", 0), ("mesh", 2)] if scene.meshes else [])
        hits = buf.get("hits_mesh" if scene.meshes else "hits", 0)
        if (buf["on"] and all(k in buf for k in need)
                and hits > out.get("hits", -1)):
            out.update({k: buf[k] for k in need}, scene=scene, hits=hits)
        buf["on"] = False
        return res

    def k6(tables, meta, origin, direction, t_min, **kw):
        res = real_k6(tables, meta, origin, direction, t_min, **kw)
        if buf.get("on"):
            if buf["k6"] in (0, 2):
                buf[buf["k6"]] = (origin.clone(), direction.clone())
            if buf["k6"] == 0:
                buf["hits"] = int((res["leaf"] >= 0).sum())
            buf["k6"] += 1
        return res

    def k7(mesh, origin, direction, t_min, *a, **kw):
        res = real_k7(mesh, origin, direction, t_min, *a, **kw)
        if buf.get("on"):
            if buf["k7"] in (0, 2):
                buf["mesh", buf["k7"]] = (mesh, origin.clone(),
                                          direction.clone(), t_min.clone())
            if buf["k7"] == 0:
                buf["hits_mesh"] = int((res["tri"] >= 0).sum())
            buf["k7"] += 1
        return res

    B.trace_rays, I.analytic_bvh_winner, MT.mesh_bvh_winner = trace, k6, k7
    try:
        yield
    finally:
        B.trace_rays, I.analytic_bvh_winner, MT.mesh_bvh_winner = (
            real_trace, real_k6, real_k7)


def card_against_cpu_lens(T, O, scenes):
    """A small Cooke-triplet observation (16x16 pixels, 2 spp, the demo's
    15 bins, 16 iterations, one compaction stage) with the same injected
    streams on the card and on CPU tensors: frames within phase observers'
    tolerances on all but 0.5 % of the lanes' pixels, their atol taken
    relative to the CPU frame's largest entry (the CCD reads power, ~1e-7 a
    pixel, where an absolute 1e-6 would pass anything), traced segments
    within that share."""
    frames, segs = {}, {}
    for device in ("cuda", "cpu"):
        cam, rgb = lens_camera(T, O, scenes, "cooke", device=device,
                               pixels=(16, 16))
        cam.pixel_samples = 2
        cam.max_wavefront_iters = 16
        cam.tile_size = 128
        cam.compact_schedule = ((4, 2),)
        cam.observe(seed=5, **injected_streams(10))
        frames[device] = rgb.xyz_frame
        segs[device] = cam._stats_rays
    lanes = 16 * 16 * 2
    allowed = max(1, int(MAX_FLIP * lanes))
    apart = {}
    for f in ("mean", "variance"):
        x = np.asarray(getattr(frames["cuda"], f)).reshape(256, -1)
        y = np.asarray(getattr(frames["cpu"], f)).reshape(256, -1)
        if not np.isfinite(x).all() or not np.abs(y).max() > 0:
            fail(f"lenses: the small Cooke frame ({f}) is not finite or zero")
        apart[f] = int((~np.isclose(
            x, y, rtol=OBS_FRAME_RTOL * (10 if f == "variance" else 1),
            atol=OBS_FRAME_ATOL * np.abs(y).max()).all(-1)).sum())
    seg_dev = abs(segs["cuda"] - segs["cpu"]) / max(segs["cpu"], 1)
    out = dict(pixels=256, lanes=lanes, allowed_pixels=allowed,
               pixels_apart=apart, segments=segs, segments_rel_dev=seg_dev,
               mean_y=float(np.asarray(frames["cpu"].mean)[..., 1].mean()))
    if max(apart.values()) > allowed or seg_dev > MAX_FLIP:
        fail(f"lenses: card and CPU disagree on the small Cooke observation: {out}")
    return out


def phase_lenses(T, fused, scenes, bvh):
    """The two lens demos observed on the card: the Cooke triplet's K6
    inputs recorded from its warm pass and held against the plain versions
    (bvh_case), a small Cooke observation against CPU tensors, and both
    demos at their full image size and bins timed by observe_timed's
    protocol with exact launches a pass."""
    from source_tpu_torch.optical import observer as O
    t0 = time.perf_counter()
    cpu = card_against_cpu_lens(T, O, scenes)
    rows, k6 = {}, {}
    for name, s in LENS_DEMOS.items():
        t1 = time.perf_counter()
        cam, rgb = lens_camera(T, O, scenes, name)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec = {}
        passes, median, spread = lens_passes(
            T, fused, cam, (lambda: kernel_recorder(rec)) if name == "cooke" else None)
        peak = torch.cuda.max_memory_allocated() - base
        frame = np.asarray(rgb.xyz_frame.mean)
        if not np.isfinite(frame).all() or not frame.mean() >= 0.0:
            fail(f"lenses: {name}: the frame is not finite or its mean is "
                 f"negative ({frame.mean()})")
        if name == "cooke":
            if "scene" not in rec:
                fail("lenses: no Cooke trace reached a third bounce")
            scene = rec["scene"]
            sort = len(scene.bvh_leaf_ids) >= 64
            k6 = dict(
                bvh_items=len(scene.bvh_leaf_ids),
                csg_in_kernel=len(scene.kernel_csg_entities),
                csg_entities=len(scene.csg_entities),
                camera=bvh_case("cooke_camera", scene, *rec[0], sort, bvh),
                bounce3=bvh_case("cooke_bounce3", scene, *rec[2], sort, bvh))
            if len(scene.bvh_leaf_ids) != scene.n_leaves:
                fail("lenses: a Cooke leaf falls outside the BVH (streamed)")
        rows[name] = dict(
            source=s["source"], pixels=list(s["pixels"]), spp=s["spp"],
            spp_cut_from=s["demo_spp"], bins=s["bins"], max_depth=s["max_depth"],
            max_iters=s["iters"], tile_size=cam.tile_size, rays_per_s_median=median,
            rays_per_s_spread=spread, timed_passes=passes, peak_bytes=peak,
            schedule=getattr(cam, "_auto_schedule_cache", (None, None))[1],
            frame_mean_xyz=[float(v) for v in frame.reshape(-1, 3).mean(0)],
            wall_s=time.perf_counter() - t1)
    emit("lenses", gpu=gpu_line(), card_against_cpu=cpu, analytic_bvh_winner=k6,
         demos=rows, wall_s=time.perf_counter() - t0)
    return dict(k6=k6, launches={n: [p["analytic_bvh_winner"]
                                     for p in r["timed_passes"]]
                                 for n, r in rows.items()})


# --- mesh file IO and the bunny demo (phase meshio) ---------------------------

# demos/materials/bunny.py:103-112 on the demo's stand-in for the Stanford scan
# (the 20 480-triangle displaced icosphere(5), written to PLY and read back):
# the image, spectral rays, bins, depth, iterations and extinction of the
# demo, tiles of LENS_TILE pixels; the samples cut from 250 to BUNNY["spp"].
# A pass is 80 traces of up to 64 host-paced bounces (3 860 traced bounces),
# 41-47 s at 1 and at 4 samples alike: fewer samples do not shorten it
BUNNY = dict(source="demos/materials/bunny.py:103-112", pixels=(512, 512),
             spp=4, demo_spp=250, spectral_rays=5, bins=15, max_depth=500,
             iters=64, extinction=0.01, subdivisions=5)
OBS_TIMED = 2  # timed passes a new demo (after a warm pass)
BUNNY_TIMED = 1  # the bunny's (3 860 host-paced bounces a pass)
# every writer and reader: (format, writer keywords, reader)
MESHIO_FORMATS = {
    "obj": ("obj", {}, "native"), "obj_python": ("obj", {}, "python"),
    "stl_ascii": ("stl", {"mode": "ascii"}, None),
    "stl_binary": ("stl", {"mode": "binary"}, None),
    "ply_ascii": ("ply", {"mode": "ascii"}, None),
    "ply_binary": ("ply", {"mode": "binary"}, None),
    "vtk": ("vtk", {}, None), "rsm": ("rsm", {}, None)}
STL_WELD_TOL = 6e-7   # STL welds its soup rounded to 6 decimals (5e-7 + f32)
BVH_FIELDS = ("node_lo", "node_hi", "node_skip", "node_first", "node_count",
              "order")


def in_file_order(data):
    """A MeshData's triangle soup [T, 3, 3] in the order of its input."""
    return data.vertices[data.triangles[np.argsort(data.bvh.order)]]


def meshio_round_trips(T, scenes):
    """The bunny stand-in through every writer and reader: the mesh read
    back against the mesh built from the written arrays, vertices,
    triangles and the BVH node for node equal (STL: the soup within its
    weld's rounding, the BVH that of the welded geometry);
    the OBJ file through the native tokenizer, which must have been built."""
    import tempfile
    from source_tpu_torch.primitive import Mesh
    from source_tpu_torch.primitive.mesh import io
    v, f = scenes.bunny_mesh(BUNNY["subdivisions"])
    mesh = Mesh(v, f)
    direct = Mesh(mesh.data.vertices, mesh.data.triangles).data
    t0 = time.perf_counter()
    native = io._load_meshio()
    build_s = time.perf_counter() - t0
    if native is None:
        fail("meshio: the native OBJ tokenizer (csrc/meshio.cpp) did not build")
    out = dict(triangles=direct.n_triangles, vertices=direct.n_vertices,
               bvh_nodes=direct.bvh.n_nodes, meshio_build_s=build_s, formats={})
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fmt, kw, reader) in MESHIO_FORMATS.items():
            path = os.path.join(tmp, f"bunny_{name}.{fmt}")
            t0 = time.perf_counter()
            getattr(io, f"export_{fmt}")(mesh, path, **kw)
            t1 = time.perf_counter()
            if reader == "python":
                back = io._import_obj_python(path)
            elif reader == "native":
                back = io._import_obj_native(path, 1.0)
                if back is None:
                    fail("meshio: the native OBJ reader was not taken")
            else:
                back = getattr(io, f"import_{fmt}")(path)
            t2 = time.perf_counter()
            b = back.data
            # the triangle soup in the order the file lists the triangles
            # (a BVH build permutes them into leaf order)
            soup = np.abs(in_file_order(b) - in_file_order(direct)).max()
            if fmt == "stl":
                # STL welds its soup at 6 decimals: the geometry within that
                # rounding, the BVH that of the welded geometry
                ok = soup <= STL_WELD_TOL
                ref = Mesh(b.vertices, b.triangles[np.argsort(b.bvh.order)]).data
            else:
                ok = (soup == 0.0 and np.array_equal(b.vertices, direct.vertices)
                      and np.array_equal(b.triangles, direct.triangles))
                ref = direct
            for k in BVH_FIELDS:
                ok &= np.array_equal(getattr(b.bvh, k), getattr(ref.bvh, k))
            row = dict(bytes=os.path.getsize(path), write_s=t1 - t0,
                       read_s=t2 - t1, max_abs_vertex=float(soup))
            if not ok:
                fail(f"meshio: {name} does not read back the bunny: {row}")
            out["formats"][name] = row
    return out


def demo_pinhole(T, O, setting, pixels, world, rgb, device):
    """A PinholeCamera placed as ``setting`` (``scenes.BUNNY_CAMERA`` or
    ``scenes.TET_CAMERA``: fov, position, rotation) says."""
    return O.PinholeCamera(
        pixels, fov=setting["fov"], parent=world, pipelines=[rgb],
        transform=T.translate(*setting["position"])
        * T.rotate(*setting.get("rotation", (0.0, 0.0, 0.0))),
        device=device)


def bunny_camera(T, O, scenes, world=None, device="cuda", pixels=None):
    """The demo's PinholeCamera and RGB pipeline on the port's world."""
    s = BUNNY
    rgb = O.RGBPipeline2D(display_unsaturated_fraction=0.96)
    cam = demo_pinhole(T, O, scenes.BUNNY_CAMERA, pixels or s["pixels"],
                       world or scenes.bunny_world(), rgb, device)
    cam.spectral_rays = s["spectral_rays"]
    cam.spectral_bins = s["bins"]
    cam.pixel_samples = s["spp"]
    cam.ray_max_depth = s["max_depth"]
    cam.max_wavefront_iters = s["iters"]
    cam.ray_extinction_prob = s["extinction"]
    cam.tile_size = LENS_TILE
    cam.quiet = True
    return cam, rgb


def small_against_cpu(where, make, pixels, spp, iters, n_uniforms=10):
    """A small observation (``make(device)`` -> (camera, pipeline)) with the
    same injected streams on the card and on CPU tensors: frames within
    phase observers' tolerances (atol relative to the CPU frame's largest
    entry) on all but MAX_FLIP of the lanes' pixels, segments within that
    share."""
    frames, segs = {}, {}
    for device in ("cuda", "cpu"):
        cam, rgb = make(device)
        cam.pixel_samples = spp
        cam.max_wavefront_iters = iters
        cam.tile_size = 512
        cam.compact_schedule = ((4, 2),)
        cam.quiet = True
        cam.observe(seed=5, **injected_streams(n_uniforms))
        frames[device] = rgb.xyz_frame
        segs[device] = cam._stats_rays
    n_pix = int(np.prod(pixels))
    lanes = n_pix * spp
    allowed = max(1, int(MAX_FLIP * lanes))
    apart = {}
    for f in ("mean", "variance"):
        x = np.asarray(getattr(frames["cuda"], f)).reshape(n_pix, -1)
        y = np.asarray(getattr(frames["cpu"], f)).reshape(n_pix, -1)
        if not np.isfinite(x).all() or not np.abs(y).max() > 0:
            fail(f"{where}: the small frame ({f}) is not finite or zero")
        apart[f] = int((~np.isclose(
            x, y, rtol=OBS_FRAME_RTOL * (10 if f == "variance" else 1),
            atol=OBS_FRAME_ATOL * np.abs(y).max()).all(-1)).sum())
    seg_dev = abs(segs["cuda"] - segs["cpu"]) / max(segs["cpu"], 1)
    out = dict(pixels=n_pix, spp=spp, lanes=lanes, allowed_pixels=allowed,
               pixels_apart=apart, segments=segs, segments_rel_dev=seg_dev)
    if max(apart.values()) > allowed or seg_dev > MAX_FLIP:
        fail(f"{where}: card and CPU disagree on the small observation: {out}")
    return out


def observed_demo(T, fused, cam, rgb, where, record, repeats=OBS_TIMED):
    """observe() by the suite's protocol (a warm pass, recorded by
    ``record``, then ``repeats`` timed passes) with exact launches a pass:
    figures of the timed passes, peak device memory (from the last reset
    of the peak, which a recorder may make inside the warm pass), the
    frame's mean."""
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    passes, median, spread = lens_passes(T, fused, cam, record, repeats, where)
    peak = torch.cuda.max_memory_allocated() - base
    frame = np.asarray(rgb.xyz_frame.mean)
    if not np.isfinite(frame).all() or not frame.mean() >= 0.0:
        fail(f"{where}: the frame is not finite or its mean is negative "
             f"({frame.mean()})")
    return dict(rays_per_s_median=median, rays_per_s_spread=spread,
                timed_passes=passes, peak_bytes=peak,
                schedule=getattr(cam, "_auto_schedule_cache", (None, None))[1],
                frame_mean_xyz=[float(v) for v in frame.reshape(-1, 3).mean(0)],
                wall_s=time.perf_counter() - t0)


def recorded_kernels(where, rec, bvh, mesh_too):
    """K6 (and K7) at the recorded camera and third-bounce rays, each held
    against its plain versions (bvh_case, mesh_case) with its time and
    bound."""
    from source_tpu_torch.tracer import mesh_bvh as mb
    from source_tpu_torch.tracer import meshtrace as mt
    scene = rec.get("scene")
    if scene is None:
        fail(f"{where}: no trace of the warm pass reached a third bounce")
    sort = len(scene.bvh_leaf_ids) >= 64
    out = dict(camera_hits=rec["hits"], k6=dict(bvh_items=len(scene.bvh_leaf_ids),
                       csg_in_kernel=len(scene.kernel_csg_entities),
                       camera=bvh_case(f"{where}_camera", scene, *rec[0], sort, bvh),
                       bounce3=bvh_case(f"{where}_bounce3", scene, *rec[2], sort,
                                        bvh)))
    if mesh_too:
        out["k7"] = {k: mesh_case(f"{where}_{k}", *rec["mesh", i], mb, mt)
                     for k, i in (("camera", 0), ("bounce3", 2))}
    return out


def kdtree_fan(T, fused, world):
    """accel.KDTree().build(world), then hit on a 256-ray fan at the mesh:
    equal to World.hit on every ray, one K6 and one K7 launch a query."""
    from source_tpu_torch import accel
    from source_tpu_torch.core import Ray
    rng = np.random.default_rng(47)
    o, d = query_fan(QUERY_FAN, (0.0, 0.055, 0.0), 0.06, 0.4, rng)
    kd = accel.KDTree()
    kd.build(world)
    rays = [Ray(T.Point3D(*a), T.Vector3D(*b)) for a, b in zip(o, d)]
    t0 = time.perf_counter()
    got, launches = counted(fused, lambda: [hit_fields(kd.hit(r), world.primitives)
                                            for r in rays])
    wall = time.perf_counter() - t0
    want = [hit_fields(world.hit(r), world.primitives) for r in rays]
    apart = [i for i, (a, b) in enumerate(zip(got, want))
             if (a is None) != (b is None) or (a is not None and (
                 a["primitive"] != b["primitive"]
                 or a.get("triangle") != b.get("triangle")
                 or not np.array_equal(a["vals"], b["vals"])))]
    on_mesh = sum(1 for h in got if h is not None and h.get("triangle", -1) >= 0)
    want_only(launches, "KDTree fan", analytic_bvh_winner=QUERY_FAN,
              mesh_bvh_winner=QUERY_FAN)
    if apart or not on_mesh:
        fail(f"meshio: KDTree.hit differs from World.hit on {len(apart)} of "
             f"{QUERY_FAN} rays ({on_mesh} mesh hits)")
    return dict(queries=QUERY_FAN, mesh_hits=on_mesh, ms_per_query=wall * 1e3 /
                QUERY_FAN, launches=dict(analytic_bvh_winner=QUERY_FAN,
                                         mesh_bvh_winner=QUERY_FAN))


def phase_meshio(T, fused, scenes, bvh):
    """Mesh file IO and the bunny demo on the card: the stand-in's round
    trips, the demo observed at 512x512 by the suite's protocol with exact
    launches, K6 and K7 at its recorded rays against their plain versions,
    a small observation against CPU tensors, and the KDTree facade."""
    from source_tpu_torch.optical import observer as O
    t0 = time.perf_counter()
    trips = meshio_round_trips(T, scenes)
    t1 = time.perf_counter()
    world = scenes.bunny_world()
    world_s = time.perf_counter() - t1
    small_world = scenes.bunny_world()
    cpu = small_against_cpu(
        "meshio", lambda dev: bunny_camera(T, O, scenes, small_world, dev,
                                           (32, 32)),
        (32, 32), 2, 8)
    cam, rgb = bunny_camera(T, O, scenes, world)
    rec = {}
    demo = observed_demo(T, fused, cam, rgb, "meshio",
                         lambda: kernel_recorder(rec, busiest=True),
                         BUNNY_TIMED)
    kernels = recorded_kernels("bunny", rec, bvh, mesh_too=True)
    fan = kdtree_fan(T, fused, world)
    s = BUNNY
    emit("meshio", gpu=gpu_line(), round_trips=trips, card_against_cpu=cpu,
         bunny=dict(source=s["source"], pixels=list(s["pixels"]), spp=s["spp"],
                    spp_cut_from=s["demo_spp"], spectral_rays=s["spectral_rays"],
                    bins=s["bins"], max_depth=s["max_depth"], max_iters=s["iters"],
                    tile_size=LENS_TILE, triangles=trips["triangles"],
                    world_build_s=world_s, **demo),
         kernels=kernels, kdtree=fan, wall_s=time.perf_counter() - t0)
    return dict(kernels=kernels, fan=fan,
                launches={k: [p[k] for p in demo["timed_passes"]]
                          for k in ("analytic_bvh_winner", "mesh_bvh_winner")})


# --- the function framework and the tetrahedral-emission demo (phase functions)

# demos/materials/tetrahedra_mesh_emission.py:100-106: 512x512, 4 bins,
# depth 32, the march at 24 samples over 320 tetrahedra; the samples cut
# from 200 to TET["spp"]; tiles of LENS_TILE pixels
TET = dict(source="demos/materials/tetrahedra_mesh_emission.py:100-106",
           pixels=(512, 512), spp=4, demo_spp=200, bins=4, max_depth=32,
           subdivisions=2)
N_FIELD_POINTS = 1 << 20
FIELD_PEAK_LIMIT = 4e9      # bytes of one Discrete3DMesh call at the observed batch
FACE_TOL = 1e-6             # tet ids may differ only this near a face
INTERP_RTOL = 1e-6          # interpolators, card against CPU
N_INTERP = 65536


def tet_field(scenes, device=None):
    from source_tpu_torch.core.math.function import Discrete3DMesh
    verts, tets = scenes.icosphere_tets(TET["subdivisions"])
    data = 1.0 + 4.0 * np.clip(verts[tets].mean(axis=1)[:, 1] + 0.5, 0, 1)
    return verts, tets, Discrete3DMesh(verts, tets, data, limit=False,
                                       device=device)


def near_a_face(verts, tets, ids, pts):
    """Float64 distance (in barycentric terms, scaled by the tet's size) of
    each point to the nearest face of the tetrahedron ``ids`` names."""
    p = verts[tets[ids]]  # [n, 4, 3]
    m = np.stack([p[:, 0] - p[:, 3], p[:, 1] - p[:, 3], p[:, 2] - p[:, 3]], -1)
    lam = np.linalg.solve(m, (pts - p[:, 3])[..., None])[..., 0]
    lam = np.concatenate([lam, 1.0 - lam.sum(-1, keepdims=True)], -1)
    size = np.linalg.norm(p - p.mean(1, keepdims=True), axis=-1).max(-1)
    return np.abs(lam).min(-1) * size


def field_against_cpu(scenes):
    """The demo's Discrete3DMesh at N_FIELD_POINTS seeded points in the
    emitter's box on the card against CPU tensors: ids equal but within
    FACE_TOL of a face of both candidates, values equal where ids are."""
    verts, tets, field = tet_field(scenes)
    g = torch.Generator().manual_seed(17)
    pts = torch.rand((N_FIELD_POINTS, 3), generator=g) * 1.2 - 0.6
    pc = pts.cuda()
    ids_gpu, ms = run_ms(lambda: field.locate(pc[:, 0], pc[:, 1], pc[:, 2]))
    t0 = time.perf_counter()
    ids_cpu = field.locate(pts[:, 0], pts[:, 1], pts[:, 2])
    cpu_s = time.perf_counter() - t0
    vals_gpu = field(pc[:, 0], pc[:, 1], pc[:, 2]).cpu()
    vals_cpu = field(pts[:, 0], pts[:, 1], pts[:, 2])
    ids_gpu = ids_gpu.cpu()
    differ = torch.nonzero(ids_gpu != ids_cpu).squeeze(1).numpy()
    p64 = pts.numpy().astype(np.float64)
    worst = 0.0
    for ids in (ids_gpu.numpy(), ids_cpu.numpy()):
        sel = differ[ids[differ] >= 0]
        if sel.size:
            worst = max(worst, float(near_a_face(verts, tets, ids[sel],
                                                 p64[sel]).max()))
    same = ids_gpu == ids_cpu
    out = dict(points=N_FIELD_POINTS, inside=float((ids_cpu >= 0).float().mean()),
               ids_differ=int(differ.size), worst_face_distance=worst,
               values_differ_where_ids_agree=int(
                   (vals_gpu[same] != vals_cpu[same]).sum()),
               ms=ms, cpu_s=cpu_s, tets=len(tets),
               candidates_a_cell=int(field._host["cand"].shape[1]))
    if (worst > FACE_TOL or out["values_differ_where_ids_agree"]
            or not 0.1 < out["inside"] < 0.9):
        fail(f"functions: Discrete3DMesh card against CPU: {out}")
    return out


def interpolators_against_cpu():
    """Interpolator1D/2D/3DArray, linear and cubic, each extrapolation type,
    at N_INTERP seeded points (inside, the band, beyond): the card against
    CPU tensors within INTERP_RTOL (atol INTERP_RTOL of the largest value),
    NaN where the CPU gives NaN."""
    from source_tpu_torch.core.math import function as F
    out, worst = {}, 0.0
    for nd in (1, 2, 3):
        rng = np.random.default_rng(nd)
        axes = [np.cumsum(rng.uniform(0.2, 1.0, 6 + k)) - 2.0 for k in range(nd)]
        f = rng.normal(size=tuple(len(a) for a in axes))
        q = [torch.from_numpy(rng.uniform(a[0] - 0.9, a[-1] + 0.9, N_INTERP)
                              .astype(np.float32)) for a in axes]
        qc = [x.cuda() for x in q]
        for interp in ("linear", "cubic"):
            for extrap in ("none", "nearest", "linear", "quadratic"):
                if extrap == "quadratic" and (interp != "cubic" or nd > 1):
                    continue
                rng_kw = ({"extrapolation_range": 0.5} if nd == 1 else
                          {f"extrapolation_range_{c}": 0.5 for c in "xyz"[:nd]})
                fn = getattr(F, f"Interpolator{nd}DArray")(*axes, f, interp,
                                                           extrap, **rng_kw)
                a = fn(*qc).cpu().numpy()
                b = fn(*q).numpy()
                scale = np.nanmax(np.abs(b))
                ok = np.array_equal(np.isnan(a), np.isnan(b)) and np.allclose(
                    a, b, rtol=INTERP_RTOL, atol=INTERP_RTOL * scale,
                    equal_nan=True)
                dev = float(np.nanmax(np.abs(a - b)) / scale)
                worst = max(worst, dev)
                out[f"{nd}d_{interp}_{extrap}"] = dev
                if not ok:
                    fail(f"functions: Interpolator{nd}DArray {interp}/{extrap} "
                         f"card against CPU: {dev} of the largest value")
    return dict(points=N_INTERP, worst_rel=worst, cases=out)


def samplers_on_the_card():
    """tests/test_samplers.py's checks on the card, the draws from a CUDA
    generator: each solid-angle pdf integrates to 1 over the sphere (Monte
    Carlo over 1 048 576 uniform directions, within 0.01), E[1/pdf] is the
    support's solid angle (within 0.1 %: exact for these uniform samplers),
    the surface pdfs 1/area; the pdf integrals within 0.02 (Monte Carlo,
    5 standard errors of the narrowest cone's)."""
    from source_tpu_torch.core.math import sampler as S
    g = torch.Generator(device="cuda").manual_seed(0)
    d = S.SphereSampler().sample(g, 1 << 20)
    targets = [((0.0, 0.0, 5.0), 1.0, 1.0), ((1.0, 0.0, 3.0), 0.5, 2.0)]
    out = {}
    for name, s in (("sphere", S.SphereSampler()),
                    ("hemisphere_uniform", S.HemisphereUniformSampler()),
                    ("hemisphere_cosine", S.HemisphereCosineSampler()),
                    ("cone30", S.ConeUniformSampler(30.0)),
                    ("targeted_sphere", S.TargetedSphereSampler(targets)),
                    ("targeted_hemisphere", S.TargetedHemisphereSampler(targets))):
        out[name] = float(s.pdf(d).double().mean()) * 4 * math.pi
    for name, s, sa in (("sphere_inv", S.SphereSampler(), 4 * math.pi),
                        ("hemisphere_inv", S.HemisphereUniformSampler(), 2 * math.pi),
                        ("cone45_inv", S.ConeUniformSampler(45.0),
                         2 * math.pi * (1 - math.cos(math.radians(45))))):
        x, pdf = s.samples_with_pdfs(g, 1 << 20)
        out[name] = float((1.0 / pdf.double()).mean()) / sa
        if x.device.type != "cuda":
            fail("functions: a sampler drew off the card")
    for name, s in (("disk", S.DiskSampler3D(2.0)),
                    ("rectangle", S.RectangleSampler3D(2.0, 1.0)),
                    ("triangle", S.TriangleSampler3D((0, 0, 0), (1, 0, 0),
                                                     (0, 1, 0)))):
        p = s.sample(g, 4096)
        out[name] = float(s.pdf(p).mean()) * s.area
    tol = dict(dict.fromkeys(("sphere_inv", "hemisphere_inv", "cone45_inv"),
                             1e-3),
               **dict.fromkeys(("disk", "rectangle", "triangle"), 1e-5))
    bad = {k: v for k, v in out.items() if abs(v - 1.0) > tol.get(k, 0.02)}
    if bad:
        fail(f"functions: sampler normalisation off on the card: {bad}")
    return out


def tet_camera(T, O, scenes, world=None, device="cuda", pixels=None):
    s = TET
    rgb = O.RGBPipeline2D()
    cam = demo_pinhole(T, O, scenes.TET_CAMERA, pixels or s["pixels"],
                       world or scenes.tet_emission_world(s["subdivisions"]),
                       rgb, device)
    cam.spectral_bins = s["bins"]
    cam.pixel_samples = s["spp"]
    cam.ray_max_depth = s["max_depth"]
    cam.tile_size = LENS_TILE
    cam.quiet = True
    return cam, rgb


@contextlib.contextmanager
def field_meter(world, out):
    """Wraps the inhomogeneous emitter's closure: the largest batch of
    points one call evaluates and that call's peak device memory above
    what was allocated before it."""
    mat = next(p.material for p in world.primitives
               if hasattr(p.material, "emission_function"))
    real = mat.emission_function

    def metered(p, direction, wavelengths):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = real(p, direction, wavelengths)
        torch.cuda.synchronize()
        n = int(np.prod(p.shape[:-1]))
        peak = torch.cuda.max_memory_allocated() - base
        if n >= out.get("points", 0):
            out.update(points=n, batch_shape=list(p.shape[:-1]), peak_bytes=peak)
        out["calls"] = out.get("calls", 0) + 1
        return res

    mat.emission_function = metered
    try:
        yield
    finally:
        mat.emission_function = real


def phase_functions(T, fused, scenes, bvh):
    """The function framework on the card: the demo's Discrete3DMesh and the
    array interpolators against CPU tensors, the samplers' normalisation,
    and the tetrahedral-emission demo observed at 512x512 by the suite's
    protocol with exact launches, its field's memory at the observed batch,
    K6 at its camera rays against its plain versions, and a small
    observation against CPU tensors."""
    from source_tpu_torch.optical import observer as O
    t0 = time.perf_counter()
    field = field_against_cpu(scenes)
    interps = interpolators_against_cpu()
    samplers = samplers_on_the_card()
    cpu = small_against_cpu(
        "functions", lambda dev: tet_camera(T, O, scenes, None, dev, (32, 32)),
        (32, 32), 2, 8)
    world = scenes.tet_emission_world(TET["subdivisions"])
    cam, rgb = tet_camera(T, O, scenes, world)
    rec, meter = {}, {}

    @contextlib.contextmanager
    def record():
        with kernel_recorder(rec, busiest=True), field_meter(world, meter):
            yield
    demo = observed_demo(T, fused, cam, rgb, "functions", record)
    if not meter or meter["peak_bytes"] > FIELD_PEAK_LIMIT:
        fail(f"functions: the field's call at the observed batch takes "
             f"{meter} (limit {FIELD_PEAK_LIMIT:.0f} bytes)")
    kernels = recorded_kernels("tet", rec, bvh, mesh_too=False)
    s = TET
    emit("functions", gpu=gpu_line(), discrete3d=field, interpolators=interps,
         samplers=samplers, card_against_cpu=cpu,
         field_at_observed_batch=dict(meter, limit_bytes=FIELD_PEAK_LIMIT),
         tet=dict(source=s["source"], pixels=list(s["pixels"]), spp=s["spp"],
                  spp_cut_from=s["demo_spp"], bins=s["bins"],
                  max_depth=s["max_depth"], max_iters=cam.max_wavefront_iters,
                  tile_size=LENS_TILE, tets=field["tets"], **demo),
         kernels=kernels, wall_s=time.perf_counter() - t0)
    return dict(kernels=kernels, launches=[p["analytic_bvh_winner"]
                                           for p in demo["timed_passes"]])


# --- multi-GPU: sharded entry points, engines and a process group (phase sharded)

SHARD_SEED = 41
SHARD_REPS = 5           # timed runs (median) of each sharded entry point
SHARD_OBS = (32, 32)     # the sharded observation held to CPU tensors, 4 spp
DIST_OBS = (64, 64)      # the 2-rank DistributedEngine observation, 4 spp
RANKS = 2
RANK_TIMEOUT_S = 180     # ranks not done by then (one deadline) fail the phase


def shard_mesh():
    """Every card of the machine, or cuda:0 twice on a machine of one (two
    shards, run one after the other on it)."""
    from source_tpu_torch.parallel.engine import default_mesh
    n = torch.cuda.device_count()
    if n > 1:
        return default_mesh()
    return default_mesh([torch.device("cuda", 0)] * 2)


def wall_ms(fn, reps=SHARD_REPS):
    """Median host milliseconds of ``fn()`` over ``reps`` synchronised calls,
    after one warm-up."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


LANE_FIELDS = ("origin", "direction", "throughput", "radiance", "alive",
               "depth")


def states_equal(a, b):
    """Two RayStates equal bit for bit, lanes and counters."""
    return (all(bitwise_equal(getattr(a, f), getattr(b, f).to(
        getattr(a, f).device)) for f in LANE_FIELDS)
            and int(a.segments) == int(b.segments)
            and int(a.overflow) == int(b.overflow))


def shard_rows(mesh, n):
    """The row range of each of the mesh's shards of n rays."""
    k = len(mesh.devices)
    return [slice(i * n // k, (i + 1) * n // k) for i in range(k)]


def per_shard_loop(T, fused, mesh, scene, cfg, o, d, **kw):
    """``render_batch`` on each shard in turn with the sharded run's
    generators, counted; returns the concatenated state and the launches."""
    from source_tpu_torch.parallel import engine as E
    gens = E.shard_generators(mesh, SHARD_SEED)

    def loop():
        parts = [T.render_batch(E.scene_replica(scene, dev), cfg,
                                o[rows].to(dev), d[rows].to(dev), g,
                                device=dev, **kw)
                 for dev, g, rows in zip(mesh.devices, gens,
                                         shard_rows(mesh, o.shape[0]))]
        home = mesh.devices[0]
        return T.RayState(**{f: torch.cat([getattr(p, f).to(home)
                                           for p in parts])
                             for f in LANE_FIELDS},
                          segments=sum(int(p.segments) for p in parts),
                          overflow=sum(int(p.overflow) for p in parts))
    return counted(fused, loop)


def sharded_forward(T, fused, scenes, mesh):
    """The flagship forward: sharded_render_batch against the per-shard loop
    (bit for bit, segments included), one K3 a shard, wall beside the
    unsharded render_batch; and the same run from a scene compiled on the
    CPU, whose replica on the card is made once."""
    from source_tpu_torch.parallel import engine as E
    k = len(mesh.devices)
    scene, cfg, o, d, _, _ = flagship(T, fused, scenes)
    one, one_launches = counted(fused, lambda: T.render_batch(
        scene, cfg, o, d, torch.Generator(device="cuda").manual_seed(3)))
    st, launches = counted(fused, lambda: T.sharded_render_batch(
        scene, cfg, o, d, SHARD_SEED, mesh=mesh))
    loop, loop_launches = per_shard_loop(T, fused, mesh, scene, cfg, o, d)
    want = {name: c * k for name, c in one_launches.items()}
    if launches != want or loop_launches != want:
        fail(f"sharded: the flagship forward must launch {want} (the "
             f"unsharded count times {k} shards), got {launches} sharded "
             f"and {loop_launches} in the per-shard loop")
    if not states_equal(st, loop):
        fail("sharded: sharded_render_batch differs from the per-shard loop "
             "of render_batch on the flagship")
    rad = st.radiance.float()
    if tuple(rad.shape) != (o.shape[0], FLAGSHIP["bins"]) or not bool(
            torch.isfinite(rad).all()):
        fail("sharded: the flagship radiance has the wrong shape or is not "
             "finite")
    # a scene compiled on the CPU: its replica on the card, made at the
    # first call and kept
    cpu_scene = T.compile_scene(scenes.cornell_box(glass=True),
                                T.SpectralConfig(375.0, 740.0,
                                                 FLAGSHIP["bins"]),
                                device="cpu")
    from_cpu = T.sharded_render_batch(cpu_scene, cfg, o, d, SHARD_SEED,
                                      mesh=mesh)
    replica = E.scene_replica(cpu_scene, mesh.devices[0])
    again = T.sharded_render_batch(cpu_scene, cfg, o, d, SHARD_SEED, mesh=mesh)
    if (not states_equal(st, from_cpu) or not states_equal(st, again)
            or E.scene_replica(cpu_scene, mesh.devices[0]) is not replica):
        fail("sharded: the replica of a CPU-compiled scene traces otherwise "
             "or was made twice")
    return dict(
        rays=o.shape[0], shards=k, segments=int(st.segments),
        launches=launches, unsharded_launches=one_launches,
        bit_equal_to_loop=True, replica_from_cpu_bit_equal=True,
        wall_ms=wall_ms(lambda: T.sharded_render_batch(
            scene, cfg, o, d, SHARD_SEED, mesh=mesh)),
        unsharded_wall_ms=wall_ms(lambda: T.render_batch(
            scene, cfg, o, d, torch.Generator(device="cuda").manual_seed(3)))
    ), launches


def sharded_step(T, fused, scenes, mesh):
    """The flagship training step on the whole-span route: the loss against
    the per-shard loop's (the shards' means over their count) to rtol 1e-6,
    every gradient field within ROUTE_TOL of its largest entry (K4 adds the
    table cotangent with float atomics), one K3 and one K4 a shard; wall and
    peak memory beside the unsharded step."""
    from source_tpu_torch.parallel import engine as E
    k = len(mesh.devices)
    scene, cfg, o, d, _, _ = flagship(T, fused, scenes)
    target = torch.zeros((o.shape[0], FLAGSHIP["bins"]), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (loss, grads), launches = counted(fused, lambda: (
        T.sharded_render_loss_and_grads(scene, cfg, o, d, target, SHARD_SEED,
                                        mesh=mesh, span="multi")))
    peak = torch.cuda.max_memory_allocated() - base
    want = dict(NO_LAUNCHES, fused_span_fwd=k, fused_span_bwd=k)
    if launches != want:
        fail(f"sharded: the flagship step must launch {want}, got {launches}")
    gens = E.shard_generators(mesh, SHARD_SEED)
    parts = [T.render_loss_and_grads(E.scene_replica(scene, dev), cfg,
                                     o[rows], d[rows], target[rows], g,
                                     device=dev, span="multi")
             for dev, g, rows in zip(mesh.devices, gens,
                                     shard_rows(mesh, o.shape[0]))]
    loop_loss = sum(float(p[0]) for p in parts) / k
    loop_grads = {f: sum(p[1][f].to(mesh.devices[0]) for p in parts) / k
                  for f in grads}
    loss_dev = abs(float(loss) - loop_loss) / abs(loop_loss)
    dev = grad_deviation(loop_grads, grads)
    if not loss_dev <= 1e-6 or max(dev.values()) > ROUTE_TOL:
        fail(f"sharded: the step differs from the per-shard loop: loss "
             f"{float(loss)} against {loop_loss}, gradients {dev}")
    for f, g in grads.items():
        if g.shape != getattr(scene, f).shape or not bool(
                torch.isfinite(g).all()):
            fail(f"sharded: gradient of {f} has the wrong shape or is not "
                 f"finite")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one_ms = wall_ms(lambda: T.render_loss_and_grads(
        scene, cfg, o, d, target, torch.Generator(device="cuda").manual_seed(3),
        span="multi"))
    one_peak = torch.cuda.max_memory_allocated() - base
    return dict(
        loss=float(loss), loop_loss=loop_loss, loss_rel_dev=loss_dev,
        grad_dev=dev, launches=launches, peak_bytes=peak,
        wall_ms=wall_ms(lambda: T.sharded_render_loss_and_grads(
            scene, cfg, o, d, target, SHARD_SEED, mesh=mesh, span="multi")),
        unsharded_wall_ms=one_ms, unsharded_peak_bytes=one_peak), launches


def sharded_wavefront(T, fused, scenes, mesh, name):
    """The CSG demo (K6) or the mesh demo (K7) forward at chip_smoke's
    settings, each shard compacted alone by the demo's schedule: bit for bit
    the per-shard loop, K6/K7 launches equal to the loop's; the same run
    from the demo compiled on the CPU, its replica on the card (the leaf
    BVH's tables moved, a mesh's kernel records packed there), bit for bit
    with the same launches; wall (median of 3) beside the unsharded
    render_batch."""
    setup = csg_setup if name == "csg" else mesh_setup
    scene, cfg, o, d = setup(T, scenes)
    st, launches = counted(fused, lambda: T.sharded_render_batch(
        scene, cfg, o, d, SHARD_SEED, mesh=mesh))
    loop, loop_launches = per_shard_loop(T, fused, mesh, scene, cfg, o, d)
    kernel = "analytic_bvh_winner" if name == "csg" else "mesh_bvh_winner"
    if launches != loop_launches or not launches[kernel]:
        fail(f"sharded: {name}: launches {launches}, the per-shard loop's "
             f"{loop_launches}")
    if not states_equal(st, loop):
        fail(f"sharded: {name}: sharded_render_batch differs from the "
             f"per-shard loop")
    if not bool(torch.isfinite(st.radiance).all()):
        fail(f"sharded: {name}: radiance is not finite")
    cpu_scene = setup(T, scenes, device="cpu")[0]
    from_cpu, cpu_launches = counted(fused, lambda: T.sharded_render_batch(
        cpu_scene, cfg, o, d, SHARD_SEED, mesh=mesh))
    if cpu_launches != launches or not states_equal(st, from_cpu):
        fail(f"sharded: {name}: the replica of the CPU-compiled demo traces "
             f"otherwise: launches {cpu_launches} against {launches}")
    return dict(rays=o.shape[0], schedule=cfg.compact_schedule,
                segments=int(st.segments), overflow=int(st.overflow),
                launches=launches, bit_equal_to_loop=True,
                replica_from_cpu_bit_equal=True,
                wall_ms=wall_ms(lambda: T.sharded_render_batch(
                    scene, cfg, o, d, SHARD_SEED, mesh=mesh), reps=3),
                unsharded_wall_ms=wall_ms(lambda: T.render_batch(
                    scene, cfg, o, d,
                    torch.Generator(device="cuda").manual_seed(3)), reps=3)
                ), launches


def sharded_observer(T, fused, scenes, mesh):
    """The observer through ShardedEngine: the furnace (exactly 1.0), a
    32x32, 4 spp observation on the card against CPU tensors with the same
    per-shard streams (phase observers' frame gates), and the suite's
    Cornell box by its protocol beside the unsharded camera, with exact K3
    launches a pass (its route's spans times the shards)."""
    from source_tpu_torch.optical import observer as O
    from source_tpu_torch.parallel.engine import ShardedEngine, default_mesh
    k = len(mesh.devices)
    furnace = observer_furnace(T, O, ShardedEngine(mesh), "sharded")
    cpu = card_against_cpu_observe(
        T, O, scenes, fused, pixels=SHARD_OBS, where="sharded",
        engine=lambda device: ShardedEngine(
            mesh if device == "cuda" else default_mesh(["cpu"] * k)))
    out = {}
    for label, engine in (("unsharded", None), ("sharded", ShardedEngine(mesh))):
        cam, rgb = suite_camera(T, O, scenes, "cornell")
        cam.render_engine = engine
        median, spread, stalls, passes = observe_timed(cam)
        frame = np.asarray(rgb.xyz_frame.mean)
        if not np.isfinite(frame).all() or not frame.mean() >= 0.0:
            fail(f"sharded: the {label} Cornell frame is not finite or its "
                 f"mean is negative")
        _, launches = counted(fused, lambda: cam.observe(seed=99))
        spans = route_calls(cam, SUITE["cornell"])[1]
        want = dict(NO_LAUNCHES, fused_span_fwd=spans * (k if engine else 1))
        if launches != want:
            fail(f"sharded: {label} Cornell pass: want {want}, got {launches}")
        out[label] = dict(rays_per_s_median=median, rays_per_s_spread=spread,
                          stalls_excluded=stalls, timed_passes=passes,
                          launches_per_pass=launches)
    return dict(furnace=furnace, card_against_cpu=cpu,
                cornell=dict(suite_line="benchmarks/suite.py:63",
                             pixels=list(SUITE["cornell"]["pixels"]), **out)
                ), out["sharded"]["launches_per_pass"]


def dist_observation(T, O, scenes, engine):
    """The suite's Cornell box at DIST_OBS pixels, 4 spp, through ``engine``:
    the frame's mean and the traced segments."""
    cam, rgb = suite_camera(T, O, scenes, "cornell", pixels=DIST_OBS)
    cam.pixel_samples = 4
    cam.render_engine = engine
    cam.quiet = True
    cam.observe(seed=SHARD_SEED)
    return np.asarray(rgb.xyz_frame.mean), cam._stats_rays


def dist_runs(T, fused, scenes, mesh, rows=slice(None)):
    """The flagship forward (``rows`` of it) and whole-span step over
    ``mesh``."""
    scene, cfg, o, d, _, _ = flagship(T, fused, scenes)
    target = torch.zeros((o.shape[0], FLAGSHIP["bins"]), device="cuda")
    st = T.sharded_render_batch(scene, cfg, o[rows], d[rows], SHARD_SEED,
                                mesh=mesh)
    loss, grads = T.sharded_render_loss_and_grads(
        scene, cfg, o[rows], d[rows], target[rows], SHARD_SEED, mesh=mesh,
        span="multi")
    return st, loss, grads


def sharded_rank(out):
    """One rank of phase sharded's process group (``--sharded-rank OUT``,
    started by ``two_ranks``): its rows of the flagship forward, the step
    and a DistributedEngine observation, saved to OUT. Prints no result."""
    import source_tpu_torch as T
    from source_tpu_torch import scenes
    from source_tpu_torch.optical import observer as O
    from source_tpu_torch.parallel import distributed
    from source_tpu_torch.tracer import fused
    t0 = time.perf_counter()
    distributed.initialise()
    rendezvous_s = time.perf_counter() - t0
    joined_at = time.time()
    engine = distributed.DistributedEngine()
    n = FLAGSHIP["width"] * FLAGSHIP["height"]
    start, stop = distributed.host_local_shard(n)
    st, loss, grads = dist_runs(T, fused, scenes, engine.mesh,
                                slice(start, stop))
    frame, rays = dist_observation(T, O, scenes, engine)
    np.savez(out, radiance=st.radiance.float().cpu().numpy(),
             alive=st.alive.cpu().numpy(), depth=st.depth.cpu().numpy(),
             segments=int(st.segments), loss=float(loss), frame=frame,
             rays=rays, backend=distributed.backend(),
             rank=distributed.process_index(),
             count=distributed.process_count(), rendezvous_s=rendezvous_s,
             joined_at=joined_at,
             **{f"grad_{f}": g.cpu().numpy() for f, g in grads.items()})
    return 0


def two_ranks(T, fused, scenes):
    """RANKS processes of a gloo group on the card(s), each a ``sharded_rank``
    of this script: the assembled flagship rows equal the single-process
    sharded run over RANKS shards bit for bit, the all-reduced step's
    gradients within ROUTE_TOL of its own, and both ranks fold the same
    frame as the single-process ShardedEngine observation, bit for bit."""
    import socket
    from source_tpu_torch.optical import observer as O
    from source_tpu_torch.parallel.engine import ShardedEngine, default_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "source_tpu_torch", "_build", "sharded_ranks")
    os.makedirs(work, exist_ok=True)
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(RANKS)]
    for path in outs:
        if os.path.exists(path):
            os.remove(path)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS))
    spawned_at = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", outs[r]],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(RANKS)]
    logs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(
                    deadline - time.monotonic(), 1))[0].decode())
            except subprocess.TimeoutExpired:
                fail(f"sharded: the ranks ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"sharded: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    ranks_s = time.time() - spawned_at
    got = [np.load(path) for path in outs]
    n_cards = torch.cuda.device_count()
    mesh = default_mesh([torch.device("cuda", r % n_cards)
                         for r in range(RANKS)])
    st, loss, grads = dist_runs(T, fused, scenes, mesh)
    rows = np.concatenate([g["radiance"] for g in got])
    same_rows = (np.array_equal(rows.view(np.int32),
                                st.radiance.float().cpu().numpy().view(np.int32))
                 and np.array_equal(np.concatenate([g["alive"] for g in got]),
                                    st.alive.cpu().numpy())
                 and np.array_equal(np.concatenate([g["depth"] for g in got]),
                                    st.depth.cpu().numpy())
                 and all(int(g["segments"]) == int(st.segments) for g in got))
    dev = {}
    for f, g in grads.items():
        a = g.double().cpu().numpy()
        scale = max(float(np.abs(a).max()), 1e-6)
        dev[f] = max(float(np.abs(x[f"grad_{f}"] - a).max()) / scale
                     for x in got)
    loss_dev = max(abs(float(x["loss"]) - float(loss)) / float(loss)
                   for x in got)
    frame, rays = dist_observation(T, O, scenes, ShardedEngine(mesh))
    same_frames = all(np.array_equal(x["frame"], frame)
                      and int(x["rays"]) == rays for x in got)
    backends = sorted({str(x["backend"]) for x in got})
    out = dict(ranks=RANKS, backend=backends, devices=[str(d) for d in mesh.devices],
               spawn_to_rendezvous_s=[float(x["joined_at"]) - spawned_at
                                      for x in got],
               rendezvous_s=[float(x["rendezvous_s"]) for x in got],
               ranks_wall_s=ranks_s, rows_bit_equal=same_rows,
               loss_rel_dev=loss_dev, grad_dev=dev,
               frames_bit_equal=same_frames, observation=list(DIST_OBS))
    if (not same_rows or loss_dev > 1e-6 or max(dev.values()) > ROUTE_TOL
            or not same_frames or any(int(x["count"]) != RANKS for x in got)):
        fail(f"sharded: the {RANKS}-rank run differs from the single-process "
             f"sharded run: {out}")
    return out


def phase_sharded(T, fused, scenes):
    """Multi-GPU on the card: the flagship forward and step, the CSG and
    mesh demos, and the observer through the sharded entry points over
    every card (cuda:0 twice on a machine of one), each against its
    per-shard loop with exact launches; and a 2-rank gloo group."""
    mesh = shard_mesh()
    t0 = time.perf_counter()
    forward, fwd_launches = sharded_forward(T, fused, scenes, mesh)
    step, step_launches = sharded_step(T, fused, scenes, mesh)
    csg, csg_launches = sharded_wavefront(T, fused, scenes, mesh, "csg")
    mesh_demo, mesh_launches = sharded_wavefront(T, fused, scenes, mesh, "mesh")
    observer, obs_launches = sharded_observer(T, fused, scenes, mesh)
    ranks = two_ranks(T, fused, scenes)
    emit("sharded", gpu=gpu_line(), devices=[str(d) for d in mesh.devices],
         cards=torch.cuda.device_count(), flagship_forward=forward,
         flagship_step=step, csg=csg, mesh_demo=mesh_demo, observer=observer,
         process_group=ranks, wall_s=time.perf_counter() - t0)
    return dict(forward=fwd_launches, step=step_launches, csg=csg_launches,
                mesh=mesh_launches, observer=obs_launches)


def kernels_line(cornell, grad, launches, step_launches, krng, prof, bvh_row,
                 wave_launches, mesh_rows, mesh_launches, wstep, mods, obs,
                 queries, lenses, meshio, functions, sharded):
    """The per-kernel summary at the main paths' shapes (the Cornell box,
    262144 rays, 15 bins; the span kernels over all 24 bounces). Each
    kernel's launches are those of its own route's run of its main path:
    ``render_batch`` for the forward kernels (which the training step
    launches as often again), ``render_loss_and_grads`` for the adjoints;
    the kernel-RNG branches of the span kernels those of ``render_batch``
    and ``render_loss_and_grads`` with ``rng="kernel"``, and the profiling
    kernels those of the flagship's forward per-bounce route (phase
    fusedprof: one a bounce, on the route's live lists, in place; their
    times and bounds summed over it). The rows of K6 and K7 also carry
    ``step_launches``: their launches in one differentiable wavefront step at
    remat_block 1 (phases wstep and modifiers). Every row carries
    ``observer_launches``: its kernel's launches in one observe() pass of
    each of the suite's five scenes (phase observers), where nonzero. The
    rows of K3, K6 and K7 carry ``query_launches``, their launches on the
    per-ray entry points (phase queries), and the kernel's time beside its
    bound at those inputs (``at_ray_sample``, ``at_query_fan``,
    ``at_query_hits``); K6's row carries ``lens_launches`` (each timed pass
    of both lens demos) and its time at the Cooke triplet's rays
    (``at_lens_rays``, phase lenses). The rows of K6 and K7 carry
    ``bunny_launches`` (each timed pass of the bunny demo, and the
    KDTree fan's, phase meshio) and their times at the bunny's camera and
    third-bounce rays (``at_bunny_rays``); K6's row also ``tet_launches``
    and ``at_tet_rays`` (phase functions). The rows of K3, K4, K6 and K7
    carry ``sharded_launches``: their launches on the sharded entry points
    (phase sharded: the flagship's forward, step and observed Cornell pass,
    the CSG and mesh demos' forward)."""
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
    # K1 summed over the launches of the per-bounce route (its live lists,
    # in place), and K3's head and tail by its own clock
    k1, k3 = cornell["fused_bounce_fwd"], cornell["fused_span_fwd"][-1]
    rows[0].update(route_ms=k1["route_ms"], route_bound_ms=k1["route_bound_ms"],
                   route_launches=k1["route_launches"])
    rows[1].update(head_ms=k3["timeline"]["head_ms"],
                   tail_ms=k3["timeline"]["tail_ms"],
                   all_dead_ms=k3["all_dead_ms"])
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
    # the profiling kernels summed over the flagship's forward per-bounce
    # route, in place on its live lists (time, plain version and bound),
    # with the first bounce and the lane-order sum beside them
    for name, line in (("fused_bounce_replay", 1375), ("fused_bounce_io", 1423)):
        m = prof["rows"][name]
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_kernels.cu",
            replaces=f"source_tpu/tracer/pallas_fused.py:{line}",
            launches=prof["launches"][name], max_abs_err=m["max_abs"],
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None,
            first_bounce_ms=m["first_bounce_ms"],
            first_bounce_bound_ms=m["first_bounce_bound_ms"],
            lane_order_ms=m["lane_order_ms"]))
    # the analytic-BVH kernel on the CSG demo's camera rays; its launches
    # are those of the wavefront route's render_batch of the CSG demo
    rows.append(dict(
        name="analytic_bvh_winner", route="cuda", source=src + "analytic_bvh.cu",
        replaces="source_tpu/tracer/pallas_analytic.py:702",
        launches=wave_launches["analytic_bvh_winner"],
        max_abs_err=bvh_row["max_abs"], ms=bvh_row["ms"],
        plain_ms=bvh_row["plain_ms"], bound_ms=bvh_row["bound_ms"],
        bound_by=bvh_row["bound_by"], library_ms=None,
        step_launches=dict(
            {k: v["analytic_bvh_winner"] for k, v in wstep.items()},
            modifiers=mods["step"]["analytic_bvh_winner"])))
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
    rows[-2]["step_launches"] = dict(mesh=wstep["mesh"]["mesh_bvh_winner"])
    for row in rows:
        base = row["name"].split()[0]
        row["observer_launches"] = (
            {} if "(" in row["name"] else
            {k: v[base] for k, v in obs.items() if v[base]})

    def at(m):
        return {k: m[k] for k in ("n", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "max_abs") if k in m}
    by_name = {row["name"]: row for row in rows}
    by_name["fused_span_fwd"].update(
        query_launches=queries["fused_span_fwd"],
        at_ray_sample=at(queries["k3_row"]))
    by_name["analytic_bvh_winner"].update(
        query_launches=queries["analytic_bvh_winner"],
        at_query_fan=at(queries["k6_row"]),
        lens_launches=lenses["launches"],
        at_lens_rays={k: at(lenses["k6"][k]) for k in ("camera", "bounce3")},
        bunny_launches=dict(passes=meshio["launches"]["analytic_bvh_winner"],
                            kdtree_fan=meshio["fan"]["launches"][
                                "analytic_bvh_winner"]),
        at_bunny_rays={k: at(meshio["kernels"]["k6"][k])
                       for k in ("camera", "bounce3")},
        tet_launches=functions["launches"],
        at_tet_rays={k: at(functions["kernels"]["k6"][k])
                     for k in ("camera", "bounce3")})
    def at_mesh(m):
        return dict(at(m), max_abs=max(m[k] for k in ("max_abs_dt", "max_abs_du",
                                                      "max_abs_dv")))
    by_name["mesh_bvh_winner"].update(
        query_launches=queries["mesh_bvh_winner"],
        at_query_hits=at_mesh(queries["k7_row"]),
        bunny_launches=dict(passes=meshio["launches"]["mesh_bvh_winner"],
                            kdtree_fan=meshio["fan"]["launches"][
                                "mesh_bvh_winner"]),
        at_bunny_rays={k: at_mesh(m) for k, m in meshio["kernels"]["k7"].items()})
    for name, runs in (("fused_span_fwd", ("forward", "step", "observer")),
                       ("fused_span_bwd", ("step",)),
                       ("analytic_bvh_winner", ("csg",)),
                       ("mesh_bvh_winner", ("mesh",))):
        by_name[name]["sharded_launches"] = {r: sharded[r][name] for r in runs}
    return {"kernels": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="env,kernels,furnace,main,grad_kernels,step,"
                            "krng,fusedprof,bvh_kernels,wavefront,"
                            "mesh_kernels,mesh_furnace,mesh,wstep,modifiers,"
                            "observers,queries,lenses,meshio,functions,sharded")
    # one rank of phase sharded's process group (started by the phase)
    ap.add_argument("--sharded-rank", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.sharded_rank:
        return sharded_rank(args.sharded_rank)
    import source_tpu_torch as T
    from source_tpu_torch import scenes
    from source_tpu_torch.tracer import analytic_bvh, fused

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cornell = grad = launches = step_launches = krng = prof = None
    bvh_row = wave = None
    mesh_rows = mesh_launches = wstep = mods = obs = None
    queries = lenses = meshio = functions = sharded = None
    mesh_furnace = False
    if "env" in phases:
        phase_env(fused, analytic_bvh,
                  (SUITE["mis"]["bins"],) if "observers" in phases else ())
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
    if "wstep" in phases:
        wstep = phase_wstep(T, fused, scenes)
    if "modifiers" in phases:
        mods = phase_modifiers(T, fused, scenes)
    if "observers" in phases:
        obs = phase_observers(T, fused, scenes)
    if "queries" in phases:
        queries = phase_queries(T, fused, scenes, analytic_bvh)
    if "lenses" in phases:
        lenses = phase_lenses(T, fused, scenes, analytic_bvh)
    if "meshio" in phases:
        meshio = phase_meshio(T, fused, scenes, analytic_bvh)
    if "functions" in phases:
        functions = phase_functions(T, fused, scenes, analytic_bvh)
    if "sharded" in phases:
        sharded = phase_sharded(T, fused, scenes)
    emit("total", seconds=time.perf_counter() - t_start)
    if None in (cornell, grad, launches, step_launches, krng, prof, bvh_row,
                wave, mesh_rows, mesh_launches, wstep, mods, obs, queries,
                lenses, meshio, functions, sharded) or not mesh_furnace:
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 3
    print(gpu_line(), flush=True)
    print(json.dumps(kernels_line(cornell, grad, launches, step_launches,
                                  krng, prof, bvh_row, wave, mesh_rows,
                                  mesh_launches, wstep, mods, obs, queries,
                                  lenses, meshio, functions, sharded)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
