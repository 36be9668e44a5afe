#!/usr/bin/env python3
"""Smoke run of source_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused CUDA kernels from source_tpu_torch/csrc/ (into
source_tpu_torch/_build/), holds each against its plain PyTorch version on
the card, runs the furnace check, and drives the main path: the glass
Cornell box at 512x512 rays, 15 spectral bins, max_depth 16, 24 iterations,
through ``compile_scene`` -> ``render_batch``, once through the whole-span
kernel and once through the per-bounce kernel. Every phase prints one JSON
line; any failure exits non-zero. Without a CUDA device the script exits 2
and prints no result. ``--phases env,kernels`` runs a subset while developing
(the last line is then not a pass).
"""

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM data sheet, f32 outside the tensor cores
RTOL, ATOL = 1e-3, 1e-4     # kernel vs plain on lanes whose choices agree
MAX_FLIP = 0.005            # lanes per bounce that may choose differently
# lanes that hit a torus (see torus_lanes): (worst lane, as a multiple of
# 1+|ref|; fraction of such lanes that may exceed RTOL/ATOL)
TORUS_BOUNCE = (1e-2, 0.01)  # after one bounce
TORUS_SPAN = (5e-2, 0.02)    # after a span, which carries the offset on
F64_FACTOR = 2.0            # kernel's distance from float64 over the plain version's
N_ZOO = 65536
FLAGSHIP = dict(width=512, height=512, bins=15, max_depth=16, max_iters=24)


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


def kernel_case(name, world, bins, cfg, o, d, span_steps, seed, T, fused):
    """Hold fused_bounce_fwd and fused_span_fwd against their plain versions
    on one scene; returns a dict of measurements per kernel."""
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, bins))
    spec = fused.fused_spec(scene, cfg)
    if spec is None:
        fail(f"{name}: scene is outside the fused class")
    tab = fused.pack_tabvec(scene, spec)
    desc = torch.as_tensor(fused.spec_descriptor(spec), device="cuda")
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
    ms = time_ms(lambda: fused.fused_bounce_fwd(spec, tab, desc, st0, u_all[0]), 20)
    plain_ms = time_ms(lambda: fused.bounce_fwd_plain(spec, tab, st0, u_all[0]), 2)
    nbytes = table_bytes + 2 * state_bytes + 4 * N + 4 * fused.N_UNIFORMS * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, segs * flops / F32_FLOPS * 1e3
    res["fused_bounce_fwd"] = dict(
        scene=name, n=N, bins=bins, segments=segs, **worst, ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
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


def phase_env(fused):
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        logs = list(pool.map(lambda b: fused.build_library(b, verbose=True)[1],
                             (FLAGSHIP["bins"], 5)))
    build_s = time.time() - t0
    ptxas = [ln.strip() for ln in logs[0].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("env", gpu=gpu_line(), torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=round(build_s, 2),
         nvcc_flags=" ".join(fused.NVCC_FLAGS), ptxas_b15=ptxas)


def phase_kernels(T, fused, scenes):
    cfg = T.RayConfig(max_depth=FLAGSHIP["max_depth"], max_iters=24)
    o, d = scenes.pinhole_rays(FLAGSHIP["width"], FLAGSHIP["height"])
    cornell = kernel_case("cornell", scenes.cornell_box(glass=True),
                          FLAGSHIP["bins"], cfg, o, d, (8, 24), 11, T, fused)
    o, d = scenes.scatter_rays(N_ZOO, seed=1)
    zoo = kernel_case("zoo", scenes.zoo(), 5, T.RayConfig(max_depth=6), o, d,
                      (8, 24), 12, T, fused)
    emit("kernels", tolerance=dict(rtol=RTOL, atol=ATOL, max_flip=MAX_FLIP,
                                   torus_bounce=TORUS_BOUNCE,
                                   torus_span=TORUS_SPAN,
                                   f64_factor=F64_FACTOR),
         fused_bounce_fwd=[cornell["fused_bounce_fwd"], zoo["fused_bounce_fwd"]],
         fused_span_fwd=cornell["fused_span_fwd"] + zoo["fused_span_fwd"])
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


def phase_main(T, fused, scenes):
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
    n = o.shape[0]
    u_fixed = torch.rand((cfg.max_iters, n, fused.N_UNIFORMS), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))

    def same_u(start, n_steps, n_lanes):
        return u_fixed[start:start + n_steps, :n_lanes]

    # the main path, once per kernel route; each route's launch counts are
    # set to 0 just before it and read just after, and must be its own
    # kernel's alone
    def counted(span):
        fused.fused_span_fwd.launches = 0
        fused.fused_bounce_fwd.launches = 0
        st = T.render_batch(scene, cfg, o, d, u_all=same_u, span=span)
        torch.cuda.synchronize()
        return st, {"fused_span_fwd": fused.fused_span_fwd.launches,
                    "fused_bounce_fwd": fused.fused_bounce_fwd.launches}

    multi, n_span = counted("multi")
    per, n_per = counted("perbounce")
    launches = {"span": n_span, "perbounce": n_per}
    if n_span != {"fused_span_fwd": 1, "fused_bounce_fwd": 0}:
        fail(f"main: the span route must launch fused_span_fwd once and "
             f"nothing else: {launches}")
    if (n_per["fused_span_fwd"] != 0
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
    def stage_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    spec = fused.fused_spec(scene, cfg)
    tab = fused.pack_tabvec(scene, spec)
    desc = torch.as_tensor(fused.spec_descriptor(spec), device="cuda")
    state = T.init_rays(o, d, bins, spectral_dtype=cfg.spectral_dtype)
    st, u_p = fused.pack_state(state), fused.pack_u(u_fixed)
    out, _ = fused.fused_span_fwd(spec, tab, desc, st, u_p)
    stages = dict(
        tables_ms=stage_ms(lambda: (
            fused.pack_tabvec(scene, fused.fused_spec(scene, cfg)),
            torch.as_tensor(fused.spec_descriptor(spec), device="cuda"))),
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
         mis_mean_diff=diff, mis_standard_error=se)
    return launches


def kernels_line(cornell, launches):
    """The per-kernel summary at the main path's shapes (the Cornell box,
    262144 rays, 15 bins; the span kernel over all 24 bounces). Each kernel's
    launches are those of its own route's run of the main path."""
    rows = []
    for name, m, line, route in (
            ("fused_bounce_fwd", cornell["fused_bounce_fwd"], 1319, "perbounce"),
            ("fused_span_fwd", cornell["fused_span_fwd"][-1], 1738, "span")):
        rows.append(dict(
            name=name, route="cuda",
            source="source_tpu_torch/csrc/fused_kernels.cu",
            replaces=f"source_tpu/tracer/pallas_fused.py:{line}",
            launches=launches[route][name], max_abs_err=m["max_abs"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None))
    return {"kernels": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="env,kernels,furnace,main")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import source_tpu_torch as T
    from source_tpu_torch import scenes
    from source_tpu_torch.tracer import fused

    torch.backends.cuda.matmul.allow_tf32 = False
    cornell = launches = None
    if "env" in phases:
        phase_env(fused)
    if "kernels" in phases:
        cornell = phase_kernels(T, fused, scenes)
    if "furnace" in phases:
        phase_furnace(T, scenes)
    if "main" in phases:
        launches = phase_main(T, fused, scenes)
    if cornell is None or launches is None:
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 3
    print(gpu_line(), flush=True)
    print(json.dumps(kernels_line(cornell, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
