"""Wavefront path tracer: ray state, configuration and the forward loop.

Replacement for the reference's recursive estimator (optical/ray.pyx:338-455
``trace``; material dispatch per material.pyx). The recursion becomes an
iterative loop over bounce depth with a ray-state SoA; Russian roulette,
one-sample MIS (material.pyx:327-352), the dielectric path roulette
(dielectric.pyx:248-302) and volume responses (Beer-Lambert
dielectric.pyx:313-328, homogeneous and inhomogeneous emitters) all preserve
the reference's exact estimator so images converge to the same answer.

Two routes share the loop over spans and its stream compaction:

  * the fused route (tracer/fused.py): every span of bounces goes through
    the hand-written bounce kernels on the card, forward and adjoint, or
    their plain PyTorch versions for CPU tensors. ``trace_rays`` and
    ``trace_rays_diff`` take it for every scene ``fused.scene_tables``
    accepts;
  * the wavefront route: one ``trace_step`` per bounce, its stages separate
    tensor programs -- ``intersect_scene`` (tracer/intersect.py, with the
    analytic-BVH and mesh kernels on the card), the volume stage and the
    material dispatch -- for the scenes the fused route rejects (CSG,
    meshes, the material modifiers, user BSDFs, inhomogeneous volumes) and,
    on request (``route="wavefront"``), for any scene. It rounds the
    spectral state to its dtype after every bounce, as the reference's
    ``trace_step`` does; the fused span does not. ``trace_rays_diff`` runs
    it under autograd, ``cfg.remat_block`` bounces to a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..compiler.scene import CompiledScene, _program_to_closure
from ..core.math import batch as vmath
from ..optical.material.base import (
    MAT_CHECKERBOARD,
    MAT_CONDUCTOR,
    MAT_DIELECTRIC,
    MAT_DISCRETE_BSDF,
    MAT_EMITTER,
    MAT_EMITTER_ANISO,
    MAT_LAMBERT,
    MAT_LIGHT,
    MAT_NULL,
    MAT_PERFECT_REFLECT,
    MAT_ROUGH_CONDUCTOR,
    ROUGHEN_SLOT,
    VOL_BEER,
    VOL_HOMOGENEOUS,
    VOL_INHOMOGENEOUS,
)
from ..primitive import analytic as _a
from . import fused
from .intersect import HitRecord, intersect_scene, mesh_contains

__all__ = ["RayConfig", "RayState", "init_rays", "trace_step", "trace_rays",
           "trace_rays_diff", "alive_profile", "schedule_from_profile",
           "trace_rays_logged", "reconstruct_trajectories"]

_PI = 3.141592653589793
_INF = float("inf")
_2PI = 2.0 * _PI


@dataclasses.dataclass(frozen=True)
class RayConfig:
    """Static per-render ray parameters (optical/ray.pyx:85-126 defaults)."""

    max_depth: int = 32
    extinction_prob: float = 0.1
    extinction_min_depth: int = 3
    importance_sampling: bool = True
    important_path_weight: float = 0.25
    max_iters: int = 256  # wavefront loop bound (null hops excluded from depth)
    # per-segment hit-distance bound (core/ray.pyx:38 Ray.max_distance;
    # daughters inherit it, optical/ray.pyx:528)
    max_distance: float = float("inf")
    # stream compaction: ((steps, shrink_divisor), ...) — after `steps`
    # bounces, partition alive-first and keep N/divisor lanes. Empty = off.
    compact_schedule: tuple = ()
    # per-bounce route only: True stops once every lane is dead (one host
    # sync per bounce); False runs every bounce of the span
    early_exit: bool = True
    # the differentiable wavefront route's bounces per checkpoint block
    # (torch.utils.checkpoint): a block keeps its entry state and recomputes
    # its bounces in the backward pass; 0 keeps every bounce's intermediates
    # (no recompute). The fused route has no use for it.
    remat_block: int = 1
    # storage dtype for the spectral path state (throughput/radiance):
    # "float32" (default, bit-faithful to the reference estimator) or
    # "bfloat16" (halves the state between spans; the bounce arithmetic
    # always runs in f32, only the stored state rounds)
    spectral_dtype: str = "float32"


@dataclasses.dataclass
class RayState:
    origin: Any  # f32[N,3]
    direction: Any  # f32[N,3]
    throughput: Any  # f32|bf16[N,B]
    radiance: Any  # f32|bf16[N,B]
    alive: Any  # bool[N]
    depth: Any  # i32[N]
    segments: Any  # i32[] total path segments traced (rays/s accounting)
    # i32[] alive lanes beyond a compaction stage's capacity, summed over
    # stages — each adds roulette variance (not bias); nonzero says the
    # compact_schedule divisors are too aggressive for this scene
    overflow: Any


# the differentiable route's default span mode: the faster of the two on an
# NVIDIA H100 (chip_smoke.py, phase ``step``, times both)
DIFF_SPAN = "multi"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def init_rays(origin, direction, bins, weight=None, spectral_dtype=None):
    """Fresh ray state for a batch of camera rays (on ``origin``'s device)."""
    N = origin.shape[0]
    dev = origin.device
    sdt = _DTYPES[str(spectral_dtype)] if spectral_dtype else origin.dtype
    throughput = torch.ones((N, bins), dtype=sdt, device=dev)
    if weight is not None:
        throughput = throughput * weight[:, None].to(sdt)
    return RayState(
        origin=origin,
        direction=direction,
        throughput=throughput,
        radiance=torch.zeros((N, bins), dtype=sdt, device=dev),
        alive=torch.ones(N, dtype=torch.bool, device=dev),
        depth=torch.zeros(N, dtype=torch.int32, device=dev),
        segments=torch.zeros((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _compact_lanes(st: RayState, divisor: int, lane_ids, radiance_full,
                   generator, shift=None):
    """Partition lanes alive-first (random rotation within the alive block)
    and keep the top N/divisor.

    If more than N/divisor lanes are alive, the survivors are a random
    ROTATION of the alive ranks: every alive lane's marginal keep
    probability is exactly M/A, and the kept throughput scales by A/M —
    Russian-roulette reweighting, so compaction stays UNBIASED under
    overflow (extra variance instead of truncation bias).

    ``shift`` is the rotation; by default it is drawn from ``generator``.

    Returns (sub_state, kept lane ids, full-batch radiance updated with the
    current lanes' radiance — dead lanes' values are final).
    """
    N = st.origin.shape[0]
    dev = st.origin.device
    M = max(1, N // divisor)
    alive = st.alive
    cnt = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32)
    alive_count = cnt[-1]
    pos_alive = cnt - 1
    modulus = torch.clamp(alive_count, min=1)
    if shift is None:
        shift = (torch.rand((), generator=generator, device=dev)
                 * modulus).to(torch.int32)
        shift = torch.minimum(shift, modulus - 1)
    rank = (pos_alive + shift) % modulus
    sel = alive & (rank < M)
    n_sel = torch.sum(sel, dtype=torch.int32)
    dest = torch.where(
        sel, rank,
        n_sel + torch.cumsum((~sel).to(torch.int32), 0, dtype=torch.int32) - 1)
    perm = torch.zeros((N,), dtype=torch.int64, device=dev)
    perm[dest.to(torch.int64)] = torch.arange(N, device=dev)
    keep = perm[:M]
    overflow_scale = torch.clamp(
        alive_count.to(torch.float32).to(st.throughput.dtype) / M, min=1.0)
    radiance_full = radiance_full.index_put((lane_ids,), st.radiance)
    lane_ids = lane_ids[keep]
    alive_kept = st.alive[keep]
    one = torch.ones((), dtype=overflow_scale.dtype, device=dev)
    thr_kept = (
        st.throughput[keep]
        * torch.where(alive_kept, overflow_scale, one)[:, None]
    ).to(st.throughput.dtype)
    sub = RayState(
        origin=st.origin[keep],
        direction=st.direction[keep],
        throughput=thr_kept,
        radiance=st.radiance[keep],
        alive=alive_kept,
        depth=st.depth[keep],
        segments=st.segments,
        overflow=st.overflow + torch.clamp(alive_count - M, min=0),
    )
    return sub, lane_ids, radiance_full


def _check_device(scene, state):
    if scene.device != state.origin.device:
        raise ValueError(
            f"scene on {scene.device}, rays on {state.origin.device}")


def _check_rng(rng, u_all, seeds):
    if rng not in ("host", "kernel"):
        raise ValueError(f"rng must be 'host' or 'kernel', not {rng!r}")
    if rng == "kernel" and u_all is not None:
        raise ValueError("u_all supplies host uniforms: it cannot go with "
                         "rng='kernel' (inject the seeds with seeds=)")
    if rng == "host" and seeds is not None:
        raise ValueError("seeds= is the kernel RNG's: pass rng='kernel'")


def _n_uniforms(scene: CompiledScene):
    """Uniform draws per bounce on the wavefront route: 10, and 6 more when
    a Roughen modifier is present (its four rejection tries read columns 8
    to 15)."""
    return 16 if scene.has_roughen else 10


def _trace_spans(cfg, state, run_span, generator, u_all, shifts, rng, seeds,
                 n_uniforms):
    """The loop over spans both tracers share: ``run_span(st, start,
    n_steps, u, seed)`` traces one span of ``n_steps`` bounces from absolute
    bounce ``start``, with the host's uniforms ``u`` [n_steps, N,
    n_uniforms] (``rng="host"``, ``seed`` None) or the span's i32[2] kernel
    seed (``rng="kernel"``, ``u`` None); between the spans of
    ``cfg.compact_schedule`` the batch partitions alive-first and shrinks.
    Gathers and scatters are out of place, so autograd can follow them."""
    dev = state.origin.device

    def run_range(st, start, end):
        nsteps = end - start
        n = st.origin.shape[0]
        if rng == "kernel":
            # one seed per span, as the reference's _kernel_seed(fold_in(
            # key, 0x7A000 + start)); the kernel counts (lane, bounce) under it
            seed = (seeds(start) if seeds is not None else torch.randint(
                -2 ** 31, 2 ** 31, (2,), generator=generator,
                dtype=torch.int32, device=dev))
            return run_span(st, start, nsteps, None, seed)
        if u_all is not None:
            u = u_all(start, nsteps, n)
        else:
            u = torch.rand((nsteps, n, n_uniforms), generator=generator,
                           dtype=torch.float32, device=dev)
        return run_span(st, start, nsteps, u, None)

    schedule = cfg.compact_schedule
    if not schedule:
        return run_range(state, 0, cfg.max_iters)

    N = state.origin.shape[0]
    done = 0
    st = state
    lane_ids = torch.arange(N, device=dev)
    radiance_full = torch.zeros_like(state.radiance)
    for steps, divisor in schedule:
        steps = min(steps, cfg.max_iters - done)
        if steps <= 0:
            break
        st = run_range(st, done, done + steps)
        done += steps
        st, lane_ids, radiance_full = _compact_lanes(
            st, divisor, lane_ids, radiance_full, generator,
            shift=(None if shifts is None
                   else shifts(done, int(st.alive.sum()))))
    if done < cfg.max_iters:
        st = run_range(st, done, cfg.max_iters)
    radiance_full = radiance_full.index_put((lane_ids,), st.radiance)
    return RayState(
        origin=state.origin,
        direction=state.direction,
        throughput=state.throughput,
        radiance=radiance_full,
        alive=torch.zeros(N, dtype=torch.bool, device=dev),
        depth=state.depth,
        segments=st.segments,
        overflow=st.overflow,
    )


def trace_rays(scene: CompiledScene, cfg: RayConfig, state: RayState,
               generator=None, u_all=None, shifts=None, span="multi",
               route="auto", rng="host", seeds=None):
    """Trace to termination. Returns the final RayState.

    ``generator`` is the ``torch.Generator`` (on the state's device) the
    bounce uniforms and compaction rotations are drawn from, one
    ``[n_steps, N, 10]`` draw per span (16 columns on the wavefront route
    when the scene holds a Roughen modifier). ``u_all`` instead supplies
    them: a callable ``u_all(start, n_steps, n_lanes)`` returning that tensor
    (parity
    tests inject the reference's stream this way); ``shifts`` likewise is a
    callable ``shifts(bounces_done, alive_count)`` returning the rotation of
    the compaction stage after that many bounces.

    ``rng`` is where the bounce uniforms come from: ``"host"`` (the default,
    the reference's) draws them as above; ``"kernel"`` (the reference's
    SOURCE_TPU_RNG=kernel) draws one i32[2] seed per span from ``generator``
    and the whole-span kernel draws the uniforms itself with Philox, keyed by
    the seed and counted by (lane, absolute bounce): no uniform tensor is
    made, and the stream is ``fused.philox_uniforms``'s. ``seeds`` injects
    the seeds instead: a callable ``seeds(start)`` returning the i32[2] of
    the span that starts at bounce ``start``. Compaction rotations stay
    host-drawn. The kernel RNG exists on the fused route's whole-span kernel
    only: with ``rng="kernel"``, ``span`` other than ``"multi"`` and a scene
    that takes the wavefront route raise ``ValueError`` -- never a silent
    fall back to host uniforms, which the reference takes when its span mode
    is not ``multi``.

    ``route="auto"`` takes the fused route for every scene it accepts and
    the wavefront route otherwise; ``route="wavefront"`` takes the wavefront
    route for any scene (the reference's SOURCE_TPU_FUSED=0). On the fused
    route ``span`` selects the kernel: ``"multi"`` (one kernel per span) or
    ``"perbounce"`` (one kernel per bounce); the wavefront route runs one
    ``trace_step`` per bounce and with ``cfg.early_exit`` stops once every
    lane is dead (one host sync per bounce).

    ``cfg.compact_schedule`` applies staged stream compaction: between spans
    the batch partitions alive-first and shrinks, so the long tail of
    surviving paths no longer holds the full batch width hostage.

    The fused route keeps its spec, kernel descriptor and scene table on the
    scene between calls; the table is packed again when a scene tensor was
    edited or replaced.
    """
    if route not in ("auto", "wavefront"):
        raise ValueError(f"route must be 'auto' or 'wavefront', not {route!r}")
    _check_rng(rng, u_all, seeds)
    _check_device(scene, state)
    tables = fused.scene_tables(scene, cfg) if route == "auto" else None
    if rng == "kernel" and tables is None:
        raise ValueError(
            "rng='kernel' needs the fused route's whole-span kernel: this "
            "scene (or route='wavefront') takes the wavefront route")
    if rng == "kernel" and span != "multi":
        raise ValueError(
            f"rng='kernel' needs span='multi' (the whole-span kernel), not "
            f"{span!r}")
    if tables is not None:
        fspec, entry = tables
        tab = fused.forward_table(scene, fspec, entry)

        def run_span(st, start, n_steps, u, seed):
            return fused.fused_forward_span(tab, entry["desc"], fspec, st, u,
                                            span=span,
                                            early_exit=cfg.early_exit,
                                            seed=seed, start=start,
                                            n_steps=n_steps)
        n_u = fused.N_UNIFORMS
    else:
        def run_span(st, start, n_steps, u, seed):
            for u_k in u:
                if cfg.early_exit and not bool(st.alive.any()):
                    break
                st = trace_step(scene, cfg, st, u_k, differentiable=False)
            return st
        n_u = _n_uniforms(scene)

    with torch.no_grad():
        return _trace_spans(cfg, state, run_span, generator, u_all, shifts,
                            rng, seeds, n_u)


def trace_rays_diff(scene: CompiledScene, cfg: RayConfig, state: RayState,
                    generator=None, u_all=None, shifts=None, span=None,
                    rng="host", seeds=None):
    """Fixed-iteration differentiable variant of ``trace_rays``: every
    bounce of every span runs (no early exit), and the returned radiance
    carries an autograd graph back to the scene's float tensors (those that
    require a gradient).

    On the fused route it traces the general leaf records
    (``fused.general_spec``: the forward route's world-space fast records
    carry other transform cotangents) through the adjoint kernels and
    ``pack_tabvec``; the table is packed anew on every call, as a node of the
    graph, and the spec and the descriptor are reused. Every other scene
    takes the wavefront route: ``trace_step`` under autograd, in checkpoint
    blocks of ``cfg.remat_block`` bounces (the last block holds the
    remainder; 0 checkpoints nothing), each block recomputed in the
    backward pass from its entry state and its uniforms, so nothing random
    is drawn again. The winners of the analytic-BVH and mesh kernels are
    recomputed as tensor ops there (``intersect_scene(need_grad=True)``), so
    the gradient reaches the leaf tables and each mesh's ``MeshTables``
    tensors (vertices, transforms, normals).

    ``generator``, ``u_all``, ``shifts``, ``span``, ``rng`` and ``seeds`` are
    those of ``trace_rays``; ``span`` ("multi" or "perbounce") selects the
    fused route's kernels and defaults to ``DIFF_SPAN`` under the host RNG.
    ``rng="kernel"`` runs the fused route's whole-span kernels (one
    ``fused_span_fwd`` and one ``fused_span_bwd`` per span, which keeps the
    span's seed, not its uniforms, for the backward); with an explicit
    ``span="perbounce"``, or for a scene on the wavefront route, it raises
    ``ValueError``. With ``cfg.compact_schedule`` the gathers and scatters
    between spans are differentiable, and the radiance of compacted-away
    lanes is already final.
    """
    _check_rng(rng, u_all, seeds)
    if span is None:
        span = "multi" if rng == "kernel" else DIFF_SPAN
    fused._check_span(span)
    if rng == "kernel" and span != "multi":
        raise ValueError(
            f"rng='kernel' needs span='multi' (the whole-span kernels), not "
            f"{span!r}")
    _check_device(scene, state)
    tables = fused.scene_tables(scene, cfg, general=True)
    if tables is None:
        if rng == "kernel":
            raise ValueError(
                "rng='kernel' needs the fused route's whole-span kernels: this "
                "scene takes the wavefront route")

        def run_span(st, start, n_steps, u, seed):
            return _wavefront_span_diff(scene, cfg, st, u)

        return _trace_spans(cfg, state, run_span, generator, u_all, shifts,
                            rng, seeds, _n_uniforms(scene))
    fspec, entry = tables
    tab = fused.pack_tabvec(scene, fspec)

    def run_span(st, start, n_steps, u, seed):
        return fused.fused_span(tab, entry["desc"], fspec, st, u, span=span,
                                seed=seed, start=start, n_steps=n_steps)

    return _trace_spans(cfg, state, run_span, generator, u_all, shifts, rng,
                        seeds, fused.N_UNIFORMS)


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(RayState))


def _wavefront_span_diff(scene, cfg, state, u):
    """Every bounce of a span, ``u`` [n_steps, N, n_uniforms], through
    ``trace_step`` under autograd in checkpoint blocks of
    ``cfg.remat_block`` bounces (the reference's ``jax.checkpoint`` of a
    scan over a block). The state passes a block's boundary as a tuple of
    tensors; the RNG state is not kept, since the uniforms are inputs."""

    def block(us, *fields):
        st = RayState(*fields)
        for u_k in us:
            st = trace_step(scene, cfg, st, u_k, differentiable=True)
        return tuple(getattr(st, f) for f in _STATE_FIELDS)

    fields = tuple(getattr(state, f) for f in _STATE_FIELDS)
    size = int(cfg.remat_block)
    if size <= 0:
        return RayState(*block(u, *fields))
    for i in range(0, u.shape[0], size):
        fields = checkpoint(block, u[i:i + size], *fields,
                            use_reentrant=False, preserve_rng_state=False)
    return RayState(*fields)


# --- the wavefront route ---------------------------------------------------------


# importance sampling (optical/scenegraph/world.pyx:134-253)


def _important_cone(scene: CompiledScene, point):
    """Per-sphere cone geometry from a point: axis[N,I,3], cos_max[N,I]."""
    to_c = scene.imp_centre[None, :, :] - point[:, None, :]
    dist2 = vmath.dot(to_c, to_c)
    dist = torch.sqrt(dist2 + 1e-12)
    axis = to_c / dist[..., None]
    r = scene.imp_radius[None, :]
    inside = dist <= r
    sin2 = torch.clamp((r / dist) ** 2, 0.0, 1.0)
    c2 = 1.0 - sin2
    ok = c2 > 0.0
    cos_max = torch.where(ok, torch.sqrt(torch.where(ok, c2, 1.0)), 0.0)
    # origin inside the sphere -> sample the full sphere (cos_max = -1)
    return axis, torch.where(inside, -1.0, cos_max)


def important_direction_sample(scene: CompiledScene, point, u):
    """Sample a direction toward an important primitive (world.pyx:155-198);
    ``u`` is [N, 3] uniforms."""
    axis, cos_max = _important_cone(scene, point)
    n_imp = scene.imp_cdf.shape[0]
    idx = torch.clamp(torch.searchsorted(scene.imp_cdf, u[:, 0].contiguous()),
                      0, n_imp - 1)
    ax = torch.gather(axis, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]
    cm = torch.gather(cos_max, 1, idx[:, None])[:, 0]
    z = 1.0 - u[:, 1] * (1.0 - cm)
    r = vmath.safe_sqrt(1.0 - z * z)
    phi = _2PI * u[:, 2]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return vmath.from_frame(local, *vmath.make_frame(ax))


def important_direction_pdf(scene: CompiledScene, point, direction):
    """Mixture pdf over all important spheres (world.pyx:203-253)."""
    axis, cos_max = _important_cone(scene, point)
    c = vmath.dot(axis, direction[:, None, :])
    solid = 2.0 * _PI * (1.0 - cos_max)
    pdf_i = torch.where(c >= cos_max, 1.0 / torch.clamp(solid, min=1e-12), 0.0)
    return torch.sum(scene.imp_weight[None, :] * pdf_i, dim=-1)


# material helpers


def _conductor_fresnel(ci, n, k):
    """Spectral Fresnel reflectivity of a conducting interface
    (conductor.pyx:77-149); ci [N,1] |cos|, n/k [N,B]."""
    ci2 = ci * ci
    n2k2 = n * n + k * k
    two_n_ci = 2.0 * n * ci
    rs = (n2k2 - two_n_ci + ci2) / torch.clamp(n2k2 + two_n_ci + ci2, min=1e-30)
    rp = (n2k2 * ci2 - two_n_ci + 1.0) / torch.clamp(
        n2k2 * ci2 + two_n_ci + 1.0, min=1e-30)
    return 0.5 * (rs + rp)


def _ggx_sample(u1, u2, rough):
    """A GGX half-vector in the +z frame, alpha = roughness
    (conductor.pyx:229-236)."""
    a2 = rough * rough
    phi = 2.0 * _PI * u2
    ct2 = torch.clamp((1.0 - u1) / torch.clamp(1.0 + (a2 - 1.0) * u1, min=1e-12),
                      0.0, 1.0)
    ct = torch.sqrt(ct2 + 1e-12)
    st = torch.sqrt(torch.clamp(1.0 - ct2, 1e-12, 1.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def _ggx_d(ct_h, rough):
    """GGX normal distribution, alpha = roughness (conductor.pyx:288-296)."""
    a2 = rough * rough
    d = ct_h * ct_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(_PI * d * d, min=1e-12)


def _smith_g1(ct, rough):
    """Smith G1, alpha = roughness (conductor.pyx:302-306)."""
    a2 = rough * rough
    return 2.0 * ct / torch.clamp(ct + torch.sqrt(a2 + (1.0 - a2) * ct * ct),
                                  min=1e-12)


def _hemisphere_cosine(u1, u2):
    z = vmath.safe_sqrt(u1)
    r = vmath.safe_sqrt(1.0 - u1)
    phi = _2PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _surface_interaction(scene: CompiledScene, cfg: RayConfig,
                         state: RayState, rec: HitRecord, u):
    """Every material's surface response for the batch, the user BSDFs and
    the modifiers included: (new_origin, new_direction, throughput_mul[N,B],
    emission[N,B], continues[N], counts_depth[N])."""
    N = state.origin.shape[0]
    B = state.throughput.shape[1]
    dtype = state.origin.dtype
    dev = state.origin.device

    mat_id = vmath.select_rows(scene.entity_material,
                               torch.clamp(rec.entity, min=0))
    # mix modifiers (Blend/Add): reroll the material id before the gathers.
    # The remaps are sorted ascending, so nested mixes resolve in one sweep;
    # an Add lane carries its one-sample weight
    lane_weight = torch.ones((N,), dtype=dtype, device=dev)
    for mix_id, id_a, id_b, add_weight in scene.mix_remaps:
        pick_b = u[:, 7] < scene.mat_params[mix_id, 0]
        is_mix = mat_id == mix_id
        mat_id = torch.where(
            is_mix, torch.where(pick_b, id_b, id_a).to(mat_id.dtype), mat_id)
        if add_weight != 1.0:
            lane_weight = torch.where(is_mix, lane_weight * add_weight,
                                      lane_weight)
    mat_types = vmath.select_rows(
        torch.as_tensor(scene.mat_types, dtype=torch.int32, device=dev), mat_id)
    # the built-in dispatch reads spectral slots 0-1 only; the others ride
    # along for the user BSDFs
    n_slots = scene.mat_spectra.shape[1] if scene.custom_materials else 2
    spectra = vmath.select_rows(scene.mat_spectra[:, :n_slots], mat_id)
    params = vmath.select_rows(scene.mat_params, mat_id)
    scalars = vmath.select_rows(scene.mat_scalars, mat_id)

    d = state.direction
    n = rec.normal
    cos_in = -vmath.dot(d, n)  # > 0 when hitting the front face
    # shading normal faces the incident ray (ContinuousBSDF normal flip)
    n_sh = torch.where(cos_in[:, None] >= 0.0, n, -n)

    # Roughen: perturb the shading normal before the dispatch
    # (roughen.pyx:46-120), a lerp toward a cosine-hemisphere sample. Of four
    # tries the first that keeps the incident ray on the same side is taken
    # (the reference retries up to 50 times); where none is, the normal stays
    # unperturbed. cos_in stays geometric: the dielectric's entering and
    # exiting logic needs the true normal
    if scene.has_roughen:
        roughen = params[:, ROUGHEN_SLOT]
        t_r, b_r, n_r = vmath.make_frame(n_sh)
        chosen = n_sh
        found = torch.zeros(N, dtype=torch.bool, device=dev)
        for a in range(4):
            pert = vmath.from_frame(
                _hemisphere_cosine(u[:, 8 + 2 * a], u[:, 9 + 2 * a]),
                t_r, b_r, n_r)
            n_pert = vmath.normalise(vmath.lerp(n_sh, pert, roughen[:, None]))
            valid = ((vmath.dot(n_pert, n_sh) > 1e-4)
                     & (vmath.dot(d, n_pert) < 0.0))
            chosen = torch.where((valid & ~found)[:, None], n_pert, chosen)
            found = found | valid
        keep = found & (roughen > 0.0)
        n_sh = torch.where(keep[:, None], chosen, n_sh)
    abs_cos_in = torch.abs(cos_in)
    t_f, b_f, n_f = vmath.make_frame(n_sh)

    # reflection/transmission launch origins relative to the incident side
    front = cos_in >= 0.0
    refl_origin = torch.where(front[:, None], rec.outside_point,
                              rec.inside_point)
    trans_origin = torch.where(front[:, None], rec.inside_point,
                               rec.outside_point)

    new_origin = refl_origin
    new_direction = d
    thr_mul = torch.zeros((N, B), dtype=dtype, device=dev)
    emission = torch.zeros((N, B), dtype=dtype, device=dev)
    continues = torch.zeros(N, dtype=torch.bool, device=dev)
    counts_depth = torch.ones(N, dtype=torch.bool, device=dev)
    present = set(scene.mat_types)
    use_mis = cfg.importance_sampling and scene.has_importance
    w_imp = cfg.important_path_weight

    if MAT_EMITTER in present:
        m = mat_types == MAT_EMITTER
        emission = torch.where(m[:, None], spectra[:, 0, :], emission)
    if MAT_EMITTER_ANISO in present:
        m = mat_types == MAT_EMITTER_ANISO
        factor = torch.clamp(torch.abs(cos_in), min=1e-9) ** params[:, 0]
        emission = torch.where(m[:, None], spectra[:, 0, :] * factor[:, None],
                               emission)
    if MAT_CHECKERBOARD in present:
        m = mat_types == MAT_CHECKERBOARD
        width = torch.clamp(params[:, 0], min=1e-12)
        # checker parity in the ENTITY's local space (checkerboard.pyx:39)
        w2l = vmath.select_rows(scene.entity_w2l, torch.clamp(rec.entity, min=0))
        p_loc = vmath.transform_point(w2l, rec.point)
        cells = torch.floor(p_loc / width[:, None]).to(torch.int32)
        parity = (cells[:, 0] + cells[:, 1] + cells[:, 2]) % 2 == 0
        emis = torch.where(parity[:, None], spectra[:, 0, :], spectra[:, 1, :])
        emission = torch.where(m[:, None], emis, emission)
    if MAT_LIGHT in present:  # debug Light (debug.pyx:41)
        m = mat_types == MAT_LIGHT
        fac = torch.clamp(-vmath.dot(params[:, 0:3], n_sh), min=0.0)
        emission = torch.where(m[:, None], spectra[:, 0, :] * fac[:, None],
                               emission)
    if MAT_PERFECT_REFLECT in present:  # debug mirror (debug.pyx:82)
        m = mat_types == MAT_PERFECT_REFLECT
        thr_mul = torch.where(m[:, None], 1.0, thr_mul)
        new_direction = torch.where(m[:, None], vmath.reflect(d, n_sh),
                                    new_direction)
        new_origin = torch.where(m[:, None], refl_origin, new_origin)
        continues = continues | m
    if MAT_NULL in present:  # pass through, depth exempt (material.pyx:118-160)
        m = mat_types == MAT_NULL
        continues = continues | m
        counts_depth = torch.where(m, False, counts_depth)
        new_origin = torch.where(m[:, None], trans_origin, new_origin)
        thr_mul = torch.where(m[:, None], 1.0, thr_mul)
    if MAT_LAMBERT in present:  # one-sample MIS (lambert.pyx:92-106)
        m = mat_types == MAT_LAMBERT
        dir_bsdf = vmath.from_frame(_hemisphere_cosine(u[:, 1], u[:, 2]),
                                    t_f, b_f, n_f)
        if use_mis:
            pick_light = u[:, 0] < w_imp
            dir_light = important_direction_sample(scene, rec.point, u[:, 3:6])
            out_dir = torch.where(pick_light[:, None], dir_light, dir_bsdf)
            pdf_light = important_direction_pdf(scene, rec.point, out_dir)
            cos_out = vmath.dot(out_dir, n_sh)
            pdf_bsdf = torch.clamp(cos_out, min=0.0) / _PI
            pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
        else:
            out_dir = dir_bsdf
            cos_out = vmath.dot(out_dir, n_sh)
            pdf_bsdf = torch.clamp(cos_out, min=0.0) / _PI
            pdf = pdf_bsdf
        ok = m & (pdf > 1e-9) & (cos_out > 0.0)
        w_l = torch.where(ok, pdf_bsdf / torch.clamp(pdf, min=1e-12), 0.0)
        thr_mul = torch.where(m[:, None], spectra[:, 0, :] * w_l[:, None],
                              thr_mul)
        new_direction = torch.where(m[:, None], out_dir, new_direction)
        new_origin = torch.where(m[:, None], refl_origin, new_origin)
        continues = continues | ok
    if MAT_CONDUCTOR in present:  # mirror + spectral Fresnel
        m = mat_types == MAT_CONDUCTOR
        f = _conductor_fresnel(abs_cos_in[:, None], spectra[:, 0, :],
                               spectra[:, 1, :])
        thr_mul = torch.where(m[:, None], f, thr_mul)
        new_direction = torch.where(m[:, None], vmath.reflect(d, n_sh),
                                    new_direction)
        new_origin = torch.where(m[:, None], refl_origin, new_origin)
        continues = continues | m
    if MAT_ROUGH_CONDUCTOR in present:  # GGX + Smith + Fresnel, one-sample MIS
        m = mat_types == MAT_ROUGH_CONDUCTOR
        rough = torch.clamp(params[:, 0], 1e-3, 1.0)
        h_bsdf = vmath.from_frame(_ggx_sample(u[:, 1], u[:, 2], rough),
                                  t_f, b_f, n_f)
        wi = -d
        wo_bsdf = vmath.reflect(d, h_bsdf)
        if use_mis:
            pick_light = u[:, 0] < w_imp
            dir_light = important_direction_sample(scene, rec.point, u[:, 3:6])
            wo = torch.where(pick_light[:, None], dir_light, wo_bsdf)
        else:
            wo = wo_bsdf
        h_raw = wi + wo
        h_len = torch.sqrt(torch.clamp(vmath.dot(h_raw, h_raw), min=1e-24))
        h = h_raw / h_len[:, None]
        ct_i = torch.clamp(vmath.dot(wi, n_sh), min=1e-6)
        ct_o = vmath.dot(wo, n_sh)
        ct_h = vmath.dot(h, n_sh)
        o_dot_h = vmath.dot(wo, h)
        d_ggx = _ggx_d(ct_h, rough)
        pdf_bsdf = 0.25 * d_ggx * torch.abs(
            ct_h / torch.where(torch.abs(o_dot_h) > 1e-9, o_dot_h, 1e-9))
        if use_mis:
            pdf_light = important_direction_pdf(scene, rec.point, wo)
            pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
        else:
            pdf = pdf_bsdf
        ok = m & (ct_o > 1e-6) & (pdf > 1e-9)
        f = _conductor_fresnel(torch.abs(o_dot_h)[:, None], spectra[:, 0, :],
                               spectra[:, 1, :])
        g = _smith_g1(ct_i, rough) * _smith_g1(torch.clamp(ct_o, min=1e-6),
                                               rough)
        w_spec = torch.where(
            ok, d_ggx * g / (4.0 * ct_i * torch.clamp(pdf, min=1e-12)), 0.0)
        thr_mul = torch.where(m[:, None], f * w_spec[:, None], thr_mul)
        new_direction = torch.where(m[:, None], wo, new_direction)
        new_origin = torch.where(m[:, None], refl_origin, new_origin)
        continues = continues | ok
    if MAT_DIELECTRIC in present:  # Snell + Fresnel path roulette
        m = mat_types == MAT_DIELECTRIC
        # indices sanitised on other lanes (their scalars are zero)
        n_int = torch.where(m, torch.clamp(scalars[:, 0], min=1e-3), 1.5)
        n_ext = torch.where(m, torch.clamp(scalars[:, 1], min=1e-3), 1.0)
        transmission_only = params[:, 0] > 0.5
        c1 = cos_in  # n is the true outward normal: c1 > 0 entering
        entering = c1 >= 0.0
        n1 = torch.where(entering, n_ext, n_int)
        n2 = torch.where(entering, n_int, n_ext)
        gamma = n1 / n2
        c2s = 1.0 - gamma * gamma * (1.0 - c1 * c1)
        tir = c2s <= 0.0
        sq = torch.where(~tir, torch.sqrt(torch.where(~tir, c2s, 1.0)), 0.0)
        temp_t = torch.where(entering, gamma * c1 - sq, gamma * c1 + sq)
        trans_dir = vmath.normalise(gamma[:, None] * d + temp_t[:, None] * n)
        refl_dir = vmath.reflect(d, n)
        c2 = -vmath.dot(n, trans_dir)
        den1 = n1 * c1 + n2 * c2
        den2 = n1 * c2 + n2 * c1
        r1 = (n1 * c1 - n2 * c2) / torch.where(torch.abs(den1) > 1e-12, den1,
                                               1e-12)
        r2 = (n1 * c2 - n2 * c1) / torch.where(torch.abs(den2) > 1e-12, den2,
                                               1e-12)
        reflectivity = 0.5 * (r1 * r1 + r2 * r2)
        transmit = transmission_only | (u[:, 0] < (1.0 - reflectivity))
        transmit = torch.where(tir, False, transmit)
        dead_tir = tir & transmission_only
        out_dir = torch.where(transmit[:, None], trans_dir, refl_dir)
        origin_sel = torch.where(transmit[:, None], trans_origin, refl_origin)
        ok = m & ~dead_tir
        thr_mul = torch.where(m[:, None], torch.where(ok[:, None], 1.0, 0.0),
                              thr_mul)
        new_direction = torch.where(m[:, None], out_dir, new_direction)
        new_origin = torch.where(m[:, None], origin_sel, new_origin)
        continues = continues | ok
    if scene.custom_materials:
        # user BSDFs (material.pyx:205-390), in the shading frame
        lam = scene.wavelengths.to(dtype)
        w_in = vmath.to_frame(-d, t_f, b_f, n_f)  # away from the surface
        back_face = ~front  # the reference's exiting/back_face flag
        for cid, mat_obj in scene.custom_materials:
            m = mat_id == cid
            # other materials' rows ride the masked lanes: a user singularity
            # there (a division by a zero parameter) would turn the masked
            # branch's cotangent into NaN through torch.where
            spectra_s = torch.where(m[:, None, None], spectra, 1.0)
            params_s = torch.where(m[:, None], params, 1.0)
            if mat_obj.MAT_TYPE == MAT_DISCRETE_BSDF:
                wo_local, weight, transmitted = mat_obj.evaluate_shading(
                    w_in, u[:, 1:3], lam, spectra_s, params_s, back_face)
                wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                ok = m & (torch.amax(weight, dim=-1) > 0.0)
                thr_mul = torch.where(m[:, None], weight, thr_mul)
                new_direction = torch.where(m[:, None], wo, new_direction)
                new_origin = torch.where(
                    m[:, None],
                    torch.where(transmitted[:, None], trans_origin,
                                refl_origin),
                    new_origin)
                continues = continues | ok
            else:  # ContinuousBSDF: one-sample MIS (material.pyx:327-352)
                wo_bsdf_local = mat_obj.sample(w_in, u[:, 1], u[:, 2],
                                               spectra_s, params_s, back_face)
                if use_mis:
                    pick_light = u[:, 0] < w_imp
                    dir_light = important_direction_sample(scene, rec.point,
                                                           u[:, 3:6])
                    wo_local = torch.where(
                        pick_light[:, None],
                        vmath.to_frame(dir_light, t_f, b_f, n_f),
                        wo_bsdf_local)
                    wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                    pdf_light = important_direction_pdf(scene, rec.point, wo)
                    pdf_bsdf = mat_obj.pdf(w_in, wo_local, spectra_s,
                                           params_s, back_face)
                    pdf = w_imp * pdf_light + (1.0 - w_imp) * pdf_bsdf
                else:
                    wo_local = wo_bsdf_local
                    wo = vmath.from_frame(wo_local, t_f, b_f, n_f)
                    pdf = mat_obj.pdf(w_in, wo_local, spectra_s, params_s,
                                      back_face)
                cos_out = wo_local[:, 2]
                f = mat_obj.bsdf(w_in, wo_local, lam, spectra_s, params_s,
                                 back_face)
                # a transmitted lane (cos_out < 0) relaunches on the far
                # side (material.pyx:286-361); its weight takes |cos_out|
                ok = m & (pdf > 1e-9) & (torch.abs(cos_out) > 1e-9)
                w_c = torch.where(
                    ok, torch.abs(cos_out) / torch.clamp(pdf, min=1e-12), 0.0)
                thr_mul = torch.where(m[:, None], f * w_c[:, None], thr_mul)
                new_direction = torch.where(m[:, None], wo, new_direction)
                new_origin = torch.where(
                    m[:, None],
                    torch.where(cos_out[:, None] < 0.0, trans_origin,
                                refl_origin),
                    new_origin)
                continues = continues | ok
    # absorbers fall through: continues stays False, thr_mul 0
    if scene.mix_remaps:
        # an Add's one-sample weight applies to the whole response
        thr_mul = thr_mul * lane_weight[:, None]
        emission = emission * lane_weight[:, None]
    return new_origin, new_direction, thr_mul, emission, continues, counts_depth


def _static_leaf_type(scene: CompiledScene, g):
    """Analytic type of a STATIC leaf index from the type slices."""
    for type_id, start, stop in scene.type_slices:
        if start <= g < stop:
            return type_id
    raise IndexError(f"leaf {g} outside type slices")


def _leaf_inside(scene, g, point):
    p_loc = vmath.transform_point(scene.leaf_w2l[g][None], point)
    return _a.CONTAINS_FNS[_static_leaf_type(scene, g)](
        p_loc, scene.leaf_params[g][None])


def _entity_inside(scene: CompiledScene, e, point):
    """Containment of ONE entity at point[N,3], testing only its own
    leaves."""
    for ce, leaf_ids, program in scene.csg_entities:
        if ce == e:
            cols = [_leaf_inside(scene, g, point) for g in leaf_ids]
            return _program_to_closure(program)(torch.stack(cols, dim=-1))
    g = scene.simple_leaf_of_entity[e]
    if g >= 0:
        return _leaf_inside(scene, g, point)
    for me, slot in scene.mesh_entities:
        if me == e:
            return mesh_contains(scene.meshes[slot], point)
    return torch.zeros(point.shape[:-1], dtype=torch.bool, device=point.device)


def _volume_interaction(scene: CompiledScene, state: RayState,
                        rec: HitRecord):
    """Volume responses along the traversed segment (optical/ray.pyx:
    422-455), containment tested at the segment midpoint: Beer-Lambert
    attenuation (dielectric.pyx:313-328), homogeneous emission and the
    inhomogeneous emitters' trapezoid march. Returns (throughput,
    emission)."""
    if not scene.volume_entities:
        return state.throughput, torch.zeros_like(state.radiance)
    t_seg = torch.where(rec.hit, rec.t, 0.0)
    midpoint = state.origin + 0.5 * t_seg[:, None] * state.direction
    throughput = state.throughput
    emission = torch.zeros_like(state.radiance)
    for e, mat_idx, kind, mat_obj, _leaf, _slot, intervals in (
            scene.volume_entities):
        m = _entity_inside(scene, e, midpoint) & rec.hit
        spec = scene.mat_spectra[mat_idx]
        if kind == VOL_BEER:
            base = spec[1][None, :]
            ok = base > 1e-9
            att = torch.where(ok, torch.where(ok, base, 1.0) ** t_seg[:, None],
                              0.0)
            throughput = torch.where(m[:, None], throughput * att, throughput)
        elif kind == VOL_HOMOGENEOUS:
            emission = emission + torch.where(
                m[:, None], spec[0][None, :] * t_seg[:, None], 0.0)
        elif kind == VOL_INHOMOGENEOUS:
            emission = emission + torch.where(
                m[:, None],
                _inhomogeneous_emission(scene, e, mat_obj, intervals, state,
                                        t_seg),
                0.0)
    return throughput, emission


def _inhomogeneous_emission(scene: CompiledScene, e, mat_obj, intervals,
                            state: RayState, t_seg):
    """The emission closure of an inhomogeneous volume integrated along each
    segment by the trapezoid rule in the entity's local frame
    (emitter/inhomogeneous.pyx:108-177): ``intervals + 1`` equally spaced
    samples, both ends included (the reference adjusts its step to absorb
    the remainder the same way, :139); ``intervals`` is static, derived by
    ``compile_scene`` from the reference's step rule at the chord's upper
    bound. A ``VolumeTransform`` adds its frame. Returns f32[N, B]."""
    inner = mat_obj  # unwrap delegating modifiers to the emitter
    while not hasattr(inner, "integrator") and hasattr(inner, "material"):
        inner = inner.material
    w2l = scene.entity_w2l[e]
    S = intervals + 1
    ts = torch.arange(S, dtype=t_seg.dtype, device=t_seg.device) / intervals
    pts = (state.origin[:, None, :]
           + (ts[None, :] * t_seg[:, None])[..., None]
           * state.direction[:, None, :])  # [N, S, 3]
    p_loc = vmath.transform_point(w2l[None, None], pts)
    d_loc = vmath.transform_vector(w2l[None], state.direction)
    frame = getattr(mat_obj, "volume_frame_matrix", None)
    if frame is not None:
        fm = torch.as_tensor(frame(), dtype=p_loc.dtype, device=p_loc.device)
        p_loc = vmath.transform_point(fm[None, None], p_loc)
        d_loc = vmath.transform_vector(fm[None], d_loc)
    # the integration measure is the local-frame length (it differs from
    # t_seg under a scaling transform)
    d_norm = torch.sqrt(torch.clamp(vmath.dot(d_loc, d_loc), min=1e-24))
    local_len = t_seg * d_norm
    d_unit = d_loc / d_norm[:, None]
    lam = scene.wavelengths.to(t_seg.dtype)
    dens = inner.emission_function(p_loc, d_unit[:, None, :], lam)  # [N,S,B]
    w_trap = torch.ones(S, dtype=dens.dtype, device=dens.device)
    w_trap[0] = 0.5
    w_trap[-1] = 0.5
    return (local_len / intervals)[:, None] * torch.sum(
        dens * w_trap[None, :, None], dim=1)


def trace_step(scene: CompiledScene, cfg: RayConfig, state: RayState, u,
               differentiable=True):
    """One wavefront bounce (the reference's ``trace_step``): roulette,
    ``intersect_scene``, the volume stage, the surface stage. ``u`` is this
    bounce's [N, n_uniforms] draws. ``differentiable=False`` lets the
    intersection consume the BVH kernel's whole winner record. Returns the
    next RayState, its spectral state rounded to the state's dtype."""
    # Russian roulette (optical/ray.pyx:380-388)
    roulette_active = state.alive & (state.depth >= cfg.extinction_min_depth)
    killed = roulette_active & (u[:, 6] < cfg.extinction_prob)
    survive_scale = torch.where(roulette_active & ~killed,
                                1.0 / (1.0 - cfg.extinction_prob), 1.0)
    alive = state.alive & ~killed & (state.depth < cfg.max_depth)
    throughput = state.throughput * survive_scale[:, None]

    # dead lanes park far outside every bounding volume: they fail the BVH's
    # root slab test at once, and every update below is gated on
    # ``alive & rec.hit``
    park = torch.full((1, 3), 3.0e7, dtype=state.origin.dtype,
                      device=state.origin.device)
    origin_q = torch.where(alive[:, None], state.origin, park)
    rec = intersect_scene(scene, origin_q, state.direction,
                          need_grad=differentiable)
    if cfg.max_distance != float("inf"):
        # hits beyond the ray's terminating distance are misses
        rec = dataclasses.replace(rec, hit=rec.hit & (rec.t <= cfg.max_distance))

    # volume emission is weighted by the segment-start throughput;
    # Beer-Lambert attenuation applies to what arrives from beyond
    thr_start = throughput
    throughput, vol_emission = _volume_interaction(
        scene, dataclasses.replace(state, throughput=throughput, alive=alive),
        rec)
    radiance = state.radiance + torch.where(alive[:, None],
                                            thr_start * vol_emission, 0.0)

    new_origin, new_dir, thr_mul, emission, continues, counts_depth = (
        _surface_interaction(scene, cfg, state, rec, u))
    active = alive & rec.hit
    radiance = radiance + torch.where(active[:, None], throughput * emission,
                                      0.0)
    throughput = torch.where(active[:, None], throughput * thr_mul, throughput)
    alive_next = active & continues & (torch.amax(throughput, dim=-1) > 0.0)
    sdt = state.throughput.dtype
    return RayState(
        origin=torch.where(active[:, None], new_origin, state.origin),
        direction=torch.where(active[:, None], new_dir, state.direction),
        throughput=throughput.to(sdt),
        radiance=radiance.to(sdt),
        alive=alive_next,
        depth=state.depth + (active & counts_depth).to(state.depth.dtype),
        segments=state.segments + torch.sum(alive, dtype=torch.int32),
        overflow=state.overflow,
    )


def alive_profile(scene: CompiledScene, cfg: RayConfig, state: RayState,
                  generator=None, u_all=None):
    """Per-bounce alive-lane counts, i32[cfg.max_iters]: the telemetry a
    compaction schedule is chosen from. Runs ``trace_step`` for every one of
    ``max_iters`` bounces (no early exit, no compaction) and counts the
    lanes alive as each bounce starts; the counts stay on the device until
    the caller reads them.

    The bounce uniforms come from ``generator``, one [N, n_uniforms] draw a
    bounce, or from ``u_all(start, 1, n_lanes)`` as in ``trace_rays``."""
    _check_device(scene, state)
    n_u = _n_uniforms(scene)
    n = state.origin.shape[0]
    counts = []
    st = state
    with torch.no_grad():
        for i in range(cfg.max_iters):
            counts.append(torch.sum(st.alive, dtype=torch.int32))
            if u_all is not None:
                u = u_all(i, 1, n)[0]
            else:
                u = torch.rand((n, n_u), generator=generator,
                               dtype=torch.float32, device=st.origin.device)
            st = trace_step(scene, cfg, st, u, differentiable=False)
    return torch.stack(counts)


def schedule_from_profile(counts, n_lanes, headroom=4, max_divisor=16,
                          min_stage_steps=2):
    """A ``compact_schedule`` derived from measured per-bounce alive counts.

    Conservative by construction: a stage halves the CURRENT batch only once
    the measured alive fraction at that depth is below 1/(headroom *
    cumulative divisor), so with headroom 4 a later tile must be 4x more
    alive than the measured one to overflow. Returns ((steps, divisor), ...)
    with per-stage (relative) divisors."""
    fracs = [c / max(1, n_lanes) for c in counts]
    schedule = []
    cum_div = 1
    steps_in_stage = 0
    for f in fracs:
        steps_in_stage += 1
        next_div = cum_div * 2
        if (
            steps_in_stage >= min_stage_steps
            and cum_div < max_divisor
            and f * headroom * next_div <= 1.0
        ):
            schedule.append((steps_in_stage, 2))
            cum_div = next_div
            steps_in_stage = 0
    return tuple(schedule)


def trace_rays_logged(scene: CompiledScene, cfg: RayConfig, state: RayState,
                      generator=None, u_all=None):
    """Path-logging variant (reference LoggingRay, optical/loggingray.pyx:45):
    ``cfg.max_iters`` bounces (no early exit, no compaction) that record, per
    bounce, the intersection record of every ray -- hit point, entity and
    material id, world normal, exiting flag, path throughput at the segment
    start and the segment length (the reference stores per-vertex
    Intersection objects, loggingray.pyx:45-202). Each bounce calls
    ``intersect_scene`` for the log and then ``trace_step``, as the
    reference does, so a scene with the leaf BVH launches the analytic-BVH
    kernel twice a bounce.

    The bounce uniforms come from ``generator``, one [N, n_uniforms] draw a
    bounce, or from ``u_all(i, 1, n_lanes)`` as in ``alive_profile``.
    Returns (final_state, log), the log a dict of [max_iters, N, ...]
    tensors left on the state's device. ``reconstruct_trajectories`` turns
    it into per-ray vertex lists on the host."""
    _check_device(scene, state)
    n_u = _n_uniforms(scene)
    n = state.origin.shape[0]
    entries = []
    st = state
    with torch.no_grad():
        for i in range(cfg.max_iters):
            rec = intersect_scene(scene, st.origin, st.direction,
                                  need_grad=False)
            if u_all is not None:
                u = u_all(i, 1, n)[0]
            else:
                u = torch.rand((n, n_u), generator=generator,
                               dtype=torch.float32, device=st.origin.device)
            nxt = trace_step(scene, cfg, st, u, differentiable=False)
            valid = st.alive & rec.hit
            mat_id = vmath.select_rows(scene.entity_material,
                                       torch.clamp(rec.entity, min=0))
            entries.append({
                "origin": st.origin,
                "hit_point": rec.point,
                "entity": torch.where(valid, rec.entity, -1),
                "material": torch.where(valid, mat_id, -1),
                "normal": rec.normal,
                "exiting": valid & rec.exiting,
                "throughput": st.throughput,
                "alive": st.alive,
                "t": torch.where(rec.hit, rec.t, _INF),
            })
            st = nxt
    log = {k: torch.stack([e[k] for e in entries]) for k in entries[0]}
    return st, log


def reconstruct_trajectories(log):
    """Host helper: turn a ``trace_rays_logged`` SoA log into per-ray
    trajectories (the reference's LoggingRay.path_vertices list of
    Intersection objects, loggingray.pyx:45-202). The log's tensors come
    to the host once each.

    Returns a list of N trajectories; each is a list of per-vertex dicts
    with keys origin/hit_point/entity/material/normal/exiting/throughput/
    alive/t, truncated at the first dead bounce."""
    arrays = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in log.items()}
    alive = arrays["alive"]  # [D, N]
    D, N = alive.shape
    out = []
    for n in range(N):
        path = []
        for i in range(D):
            if not alive[i, n]:
                break
            if not np.isfinite(arrays["t"][i, n]):
                break
            path.append({k: arrays[k][i, n] for k in arrays})
        out.append(path)
    return out
