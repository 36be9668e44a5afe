"""Wavefront path tracer: ray state, configuration and the forward loop.

Replacement for the reference's recursive estimator (optical/ray.pyx:338-455
``trace``; material dispatch per material.pyx). The recursion becomes an
iterative loop over bounce depth with a ray-state SoA; Russian roulette,
one-sample MIS (material.pyx:327-352), the dielectric path roulette
(dielectric.pyx:248-302) and volume responses (Beer-Lambert
dielectric.pyx:313-328, homogeneous emitters) all preserve the reference's
exact estimator so images converge to the same answer.

``trace_rays`` runs the fused route (tracer/fused.py): every span of bounces
goes through the hand-written kernels on the card, or through their plain
PyTorch version for CPU tensors. A scene the fused route does not take
raises ``NotImplementedError``: the per-stage wavefront route
(intersect -> volume -> material dispatch as separate tensor programs) and
the differentiable ``trace_rays_diff`` are not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..compiler.scene import CompiledScene
from . import fused

__all__ = ["RayConfig", "RayState", "init_rays", "trace_rays"]


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
    radiance_full = radiance_full.clone()
    radiance_full[lane_ids] = st.radiance
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


def trace_rays(scene: CompiledScene, cfg: RayConfig, state: RayState,
               generator=None, u_all=None, shifts=None, span="multi"):
    """Trace to termination. Returns the final RayState.

    ``generator`` is the ``torch.Generator`` (on the state's device) the
    bounce uniforms and compaction rotations are drawn from, one
    ``[n_steps, N, 10]`` draw per span. ``u_all`` instead supplies them: a
    callable ``u_all(start, n_steps, n_lanes)`` returning that tensor (parity
    tests inject the reference's stream this way); ``shifts`` likewise is a
    callable ``shifts(bounces_done, alive_count)`` returning the rotation of
    the compaction stage after that many bounces.

    ``span`` selects the kernel route: ``"multi"`` (one kernel per span) or
    ``"perbounce"`` (one kernel per bounce).

    ``cfg.compact_schedule`` applies staged stream compaction: between spans
    the batch partitions alive-first and shrinks, so the long tail of
    surviving paths no longer holds the full batch width hostage.
    """
    fspec = fused.fused_spec(scene, cfg)
    if fspec is None:
        raise NotImplementedError(
            "this scene is outside the fused route (it needs all-analytic "
            "simple entities, built-in materials and Beer/homogeneous "
            "volumes); the per-stage wavefront route is not part of this "
            "package yet")
    dev = state.origin.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    tab = fused.pack_tabvec(scene, fspec)
    desc = torch.as_tensor(fused.spec_descriptor(fspec), device=dev)

    def run_range(st, start, end):
        nsteps = end - start
        n = st.origin.shape[0]
        if u_all is not None:
            u = u_all(start, nsteps, n)
        else:
            u = torch.rand((nsteps, n, fused.N_UNIFORMS), generator=generator,
                           dtype=torch.float32, device=dev)
        return fused.fused_forward_span(tab, desc, fspec, st, u, span=span,
                                        early_exit=cfg.early_exit)

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
    radiance_full[lane_ids] = st.radiance
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
