"""The span kernels' in-kernel RNG (``rng="kernel"``) and the profiling
kernels of source_tpu_torch, on the CPU.

* ``philox_uniforms`` / ``philox4x32``, the plain version of the kernels'
  Philox4x32-10: Random123's known answers, a lane's stream independent of
  how the batch is cut and of the span's start, its range and first two
  moments, distinct streams for distinct seeds, lanes and bounces.
* The kernel-RNG route on the CPU is the host route on a fixed stream:
  ``trace_rays(rng="kernel", seeds=s)`` and ``render_loss_and_grads`` likewise
  are exactly equal to the host route fed ``philox_uniforms`` of the same
  seeds, with and without compaction. The furnace is exactly 1.0 under it,
  its mean radiance agrees with the host stream's within 4 standard errors,
  and the routes it does not exist on raise ``ValueError``.
* One slice-level parity test against the JAX package: the port's Philox
  stream for one span, as a numpy array, goes through the reference's
  ``fused_forward_span`` (its Pallas span kernel in interpret mode, as
  tests/test_fused.py runs it) and through the port's
  ``trace_rays(rng="kernel")``. Tolerance as tests/test_torch_trace.py:
  segments, alive and depth equal, radiance within rtol 1e-3 / atol 1e-4 on
  all but 0.5 % of lanes.
* The plain versions of the profiling kernels: ``bounce_replay_plain``
  against ``bounce_fwd_plain`` on the lanes that took part, and
  ``bounce_io_plain`` as the identity.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from source_tpu.tracer.pallas_fused import (
    fused_forward_span as jax_fused_forward_span, fused_spec as jax_fused_spec,
)
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig, init_rays as jax_init_rays,
)

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.tracer import fused

from test_torch_common import B, CFG, to_jax

N = 256


def _seeds(start):
    return torch.tensor([0x1234567, -987 - start], dtype=torch.int32)


def _host_stream(start, n_steps, n_lanes):
    """The kernel RNG's stream as the host route's ``u_all``."""
    return fused.philox_uniforms(_seeds(start), n_lanes, start,
                                 n_steps).permute(0, 2, 1)


@pytest.fixture(scope="module")
def cornell():
    return T.compile_scene(scenes.cornell_box(glass=True),
                           T.SpectralConfig(375.0, 740.0, B), device="cpu")


# --- the generator -----------------------------------------------------------------


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    got = " ".join(f"{int(w):08x}" for w in fused.philox4x32(ctr, key))
    assert got == want


def test_stream_independent_of_partition():
    """A lane's uniforms depend on its index and the absolute bounce alone:
    the batch drawn at once equals its two halves drawn apart, and a span
    that starts later draws the later bounces of a span that starts at 0."""
    seed = torch.tensor([5, -6], dtype=torch.int32)
    whole = fused.philox_uniforms(seed, 1000, 0, 8)
    assert whole.shape == (8, fused.N_UNIFORMS, 1000)
    assert whole.dtype == torch.float32
    halves = torch.cat([fused.philox_uniforms(seed, 400, 0, 8),
                        fused.philox_uniforms(seed, 600, 0, 8, first_lane=400)],
                       dim=2)
    assert torch.equal(whole, halves)
    assert torch.equal(whole[3:7], fused.philox_uniforms(seed, 1000, 3, 4))


def test_stream_range_and_moments():
    """10^6 draws lie in [0, 1) on the 2^-24 grid, with the mean and second
    moment of a uniform within 5 standard errors."""
    u = fused.philox_uniforms(torch.tensor([11, 12], dtype=torch.int32),
                              100_000, 0, 1).double().flatten()
    assert u.numel() == 10 ** 6
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))
    se = 1e-3  # 1 / sqrt(10^6)
    assert abs(float(u.mean()) - 0.5) < 5 * se * (1 / 12) ** 0.5
    assert abs(float((u * u).mean()) - 1 / 3) < 5 * se * (4 / 45) ** 0.5


def test_streams_are_distinct():
    """Other seeds, lanes and bounces draw other numbers: no two of these
    streams share more than chance coincidences on the 2^-24 grid, and they
    are uncorrelated."""
    a = fused.philox_uniforms(torch.tensor([1, 2], dtype=torch.int32), 512, 0, 4)
    b = fused.philox_uniforms(torch.tensor([1, 3], dtype=torch.int32), 512, 0, 4)
    c = fused.philox_uniforms(torch.tensor([2, 2], dtype=torch.int32), 512, 0, 4)
    pairs = [(a, b), (a, c), (b, c),
             (a[:, :, :256], a[:, :, 256:]),   # lanes
             (a[:2], a[2:])]                    # bounces
    for x, y in pairs:
        x, y = x.flatten().double(), y.flatten().double()
        assert float((x == y).double().mean()) < 1e-3
        assert abs(float(torch.corrcoef(torch.stack([x, y]))[0, 1])) < 0.05
    # within a draw the ten uniforms of a lane are not copies of each other
    assert float((a[:, :1] == a[:, 1:]).double().mean()) < 1e-3


# --- the kernel-RNG route ------------------------------------------------------


@pytest.mark.parametrize("schedule", [(), ((3, 2), (2, 2))],
                         ids=["plain", "compacted"])
def test_kernel_rng_is_host_route_on_its_stream(cornell, schedule):
    """On the CPU the kernel-RNG route draws ``philox_uniforms`` and runs the
    plain span: exactly the host route fed the same stream, forward and
    through the training step (whole-span route), with compaction too."""
    cfg = T.RayConfig(**dict(CFG, compact_schedule=schedule))
    o, d = scenes.scatter_rays(N, seed=3)
    gen = lambda: torch.Generator().manual_seed(4)  # compaction rotations
    k = T.render_batch(cornell, cfg, o, d, gen(), rng="kernel", seeds=_seeds,
                       device="cpu")
    h = T.render_batch(cornell, cfg, o, d, gen(), u_all=_host_stream,
                       device="cpu")
    for f in ("radiance", "alive", "depth", "segments", "overflow"):
        assert torch.equal(getattr(k, f), getattr(h, f)), f
    assert float(k.radiance.float().sum()) > 0.0
    target = torch.zeros((N // 2, B))
    lk, gk = T.render_loss_and_grads(cornell, cfg, o[: N // 2], d[: N // 2],
                                     target, gen(), device="cpu",
                                     rng="kernel", seeds=_seeds)
    lh, gh = T.render_loss_and_grads(cornell, cfg, o[: N // 2], d[: N // 2],
                                     target, gen(), device="cpu",
                                     u_all=_host_stream, span="multi")
    assert float(lk) == float(lh) and float(lk) > 0.0
    for f in gk:
        assert torch.equal(gk[f], gh[f]), f


def test_kernel_rng_furnace_exact():
    """Inside a unit emitter every ray returns exactly 1.0 in every bin with
    the kernel's own stream."""
    scene = T.compile_scene(scenes.furnace(), T.SpectralConfig(375.0, 740.0, B),
                            device="cpu")
    d = np.random.RandomState(0).normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = T.render_batch(scene, T.RayConfig(max_iters=4),
                        np.zeros((512, 3), np.float32), d,
                        torch.Generator().manual_seed(1), rng="kernel",
                        device="cpu")
    assert torch.equal(st.radiance, torch.ones(512, B))
    assert int(st.segments) == 512 and not bool(st.alive.any())


def test_kernel_rng_mean_matches_host(cornell):
    """The kernel's stream and the host's give the same estimator: mean
    radiance within 4 standard errors, and a generator seed reproduces."""
    o, d = scenes.scatter_rays(2048, seed=5)
    cfg = T.RayConfig(**dict(CFG, max_depth=8, max_iters=12))
    runs = {rng: [T.render_batch(cornell, cfg, o, d,
                                 torch.Generator().manual_seed(s), rng=rng,
                                 device="cpu").radiance.mean(1)
                  for s in (21, 21)] for rng in ("kernel", "host")}
    assert torch.equal(*runs["kernel"])
    a, b = runs["kernel"][0], runs["host"][0]
    se = float(torch.sqrt(a.var() / a.numel() + b.var() / b.numel()))
    diff = float((a.mean() - b.mean()).abs())
    print(f"kernel/host mean radiance differ by {diff:.4g}, standard error {se:.4g}")
    assert diff <= 4.0 * se and not torch.equal(a, b)


def test_kernel_rng_raises_off_the_whole_span_kernel(cornell):
    """The kernel RNG exists on the fused route's whole-span kernels only:
    elsewhere it raises instead of falling back to host uniforms."""
    o, d = scenes.scatter_rays(16, seed=1)
    cfg = T.RayConfig(**CFG)
    target = torch.zeros((16, B))
    with pytest.raises(ValueError, match="span='multi'"):
        T.render_batch(cornell, cfg, o, d, rng="kernel", span="perbounce",
                       device="cpu")
    with pytest.raises(ValueError, match="span='multi'"):
        T.render_loss_and_grads(cornell, cfg, o, d, target, rng="kernel",
                                span="perbounce", device="cpu")
    with pytest.raises(ValueError, match="wavefront route"):
        T.render_batch(cornell, cfg, o, d, rng="kernel", route="wavefront",
                       device="cpu")
    csg = T.compile_scene(scenes.csg_world(), T.SpectralConfig(375.0, 740.0, B),
                          device="cpu")
    with pytest.raises(ValueError, match="wavefront route"):
        T.render_batch(csg, cfg, o, d, rng="kernel", device="cpu")
    with pytest.raises(ValueError, match="wavefront route"):
        T.render_loss_and_grads(csg, cfg, o, d, target, rng="kernel",
                                device="cpu")
    with pytest.raises(ValueError, match="u_all"):
        T.render_batch(cornell, cfg, o, d, rng="kernel", u_all=_host_stream,
                       device="cpu")
    with pytest.raises(ValueError, match="rng"):
        T.render_batch(cornell, cfg, o, d, rng="device", device="cpu")


def test_kernel_rng_span_matches_jax_fused_span(cornell):
    """Slice-level parity: one span of the port's Philox stream through the
    reference's fused_forward_span (Pallas span kernel, interpret mode) and
    through the port's trace_rays(rng="kernel")."""
    n, steps = 256, 6
    cfg = dict(CFG, max_iters=steps)
    o, d = scenes.scatter_rays(n, seed=7)
    seed = torch.tensor([77, 88], dtype=torch.int32)
    u = fused.philox_uniforms(seed, n, 0, steps).permute(0, 2, 1).numpy()
    js = to_jax(cornell)
    jcfg = JaxRayConfig(**cfg)
    ref = jax_fused_forward_span(
        js, jax_fused_spec(js, jcfg),
        jax_init_rays(jnp.asarray(o), jnp.asarray(d), B), jnp.asarray(u))
    got = T.render_batch(cornell, T.RayConfig(**cfg), o, d, rng="kernel",
                         seeds=lambda start: seed, device="cpu")
    assert int(got.segments) == int(ref.segments)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    a = np.asarray(ref.radiance, np.float32)
    b = got.radiance.numpy()
    assert np.isfinite(b).all() and b.shape == a.shape
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(axis=1)
    print(f"{int(bad.sum())} of {n} lanes beyond tolerance, "
          f"max abs {np.abs(a - b).max():.3g}")
    assert bad.mean() <= 0.005 and float(b.sum()) > 0.0


# --- the profiling kernels' plain versions ------------------------------------------


def test_replay_and_io_plain_versions(cornell):
    """``fused_bounce_replay``'s plain version, given the bitfield
    ``fused_bounce_fwd``'s returned, ends where the forward bounce ends on
    every lane that took part (and keeps the others' state); the I/O
    kernel's plain version is the identity with a zero bitfield. On CPU
    tensors the wrappers take these plain versions."""
    spec, entry = fused.scene_tables(cornell, T.RayConfig(**CFG))
    tab = fused.forward_table(cornell, spec, entry)
    o, d = scenes.scatter_rays(N, seed=9)
    st = fused.pack_state(T.init_rays(torch.as_tensor(o), torch.as_tensor(d), B))
    u_all = fused.philox_uniforms(torch.tensor([3, 4], dtype=torch.int32), N, 0, 4)
    for u in u_all:
        new, bits = fused.bounce_fwd_plain(spec, tab, st, u)
        rep = fused.fused_bounce_replay(spec, tab, entry["desc"], st, u, bits)
        took_part = bits != 0
        assert bool(took_part.any())
        for k in fused._STATE_KEYS:
            torch.testing.assert_close(rep[k][:, took_part],
                                       new[k][:, took_part],
                                       rtol=1e-6, atol=1e-7)
        dead = ~(st["aux"][0] > 0.5)
        for k in ("o", "d", "rad"):
            assert torch.equal(rep[k][:, dead], st[k][:, dead])
        io, io_bits = fused.fused_bounce_io(spec, tab, entry["desc"], st, u)
        assert all(torch.equal(io[k], st[k]) for k in fused._STATE_KEYS)
        assert not bool(io_bits.any())
        st = new
