"""The forward path as a whole: ``render_batch``/``trace_rays`` of source_tpu_torch
against source_tpu's fused route, plus the checks the port stands on alone.

The JAX side runs with SOURCE_TPU_FUSED=1: its Pallas kernels in interpret
mode on the CPU, as tests/test_fused.py runs them. The port runs the plain
PyTorch version of its kernels (CPU tensors). Both trace the SAME compiled
scene (carried across with ``scene_from_numpy``), the same rays, and the same
random numbers: the reference's per-span uniforms
``uniform(fold_in(key, 0x7A000 + start), (n_steps, N, 10))`` and its
compaction rotation are injected into the port.

Tolerance: segments, alive and depth equal; radiance within rtol 1e-3 /
atol 1e-4 (what tests/test_fused.py allows between the Pallas kernel and the
XLA route) on the lanes whose history agrees; at most 0.5 % of lanes may
have taken another branch (XLA contracts FMAs, PyTorch does not).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world
import source_tpu as S
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig, init_rays as jax_init_rays,
    trace_rays as jax_trace_rays,
)

import source_tpu_torch as T
from source_tpu_torch import scenes

from test_torch_common import B, CFG, carry_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # name: (rays, compact_schedule, spectral_dtype)
    "plain_f32": (256, (), "float32"),
    "compacted_bf16": (384, ((3, 2), (2, 2)), "bfloat16"),
}


@pytest.fixture(scope="module")
def cornell_pair():
    js = S.compile_scene(build_world(glass=True), S.SpectralConfig(375.0, 740.0, B))
    return js, carry_scene(js)


@pytest.fixture(scope="module")
def traces(cornell_pair):
    """Both packages' final states for every case: one interpret-mode Pallas
    trace per case on the JAX side."""
    js, ts = cornell_pair
    out = {}
    prev = os.environ.get("SOURCE_TPU_FUSED")
    os.environ["SOURCE_TPU_FUSED"] = "1"
    try:
        for name, (n, schedule, sdt) in CASES.items():
            cfg = dict(CFG, compact_schedule=schedule, early_exit=True,
                       spectral_dtype=sdt)
            o, d = scenes.scatter_rays(n, seed=3)
            key = jax.random.PRNGKey(7)
            ref = jax_trace_rays(
                js, JaxRayConfig(**cfg),
                jax_init_rays(jnp.asarray(o), jnp.asarray(d), B,
                              spectral_dtype=sdt), key)

            def u_all(start, n_steps, n_lanes, key=key):
                u = jax.random.uniform(
                    jax.random.fold_in(key, 0x7A000 + start),
                    (n_steps, n_lanes, 10), jnp.float32)
                return torch.from_numpy(np.array(u))

            def shifts(done, alive_count, key=key):
                return int(jax.random.randint(
                    jax.random.fold_in(key, 1_000_000 + done), (), 0,
                    max(alive_count, 1)))

            got = {span: T.render_batch(ts, T.RayConfig(**cfg), o, d,
                                        u_all=u_all, shifts=shifts, span=span,
                                        device="cpu")
                   for span in ("multi", "perbounce")}
            out[name] = (ref, got)
    finally:
        if prev is None:
            os.environ.pop("SOURCE_TPU_FUSED", None)
        else:
            os.environ["SOURCE_TPU_FUSED"] = prev
    return out


@pytest.mark.parametrize("span", ["multi", "perbounce"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_matches_jax_fused_route(traces, case, span):
    ref, got = traces[case]
    got = got[span]
    assert int(got.segments) == int(ref.segments)
    assert int(got.overflow) == int(ref.overflow)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    assert got.radiance.dtype == getattr(torch, CASES[case][2])
    a = np.asarray(ref.radiance.astype(jnp.float32))
    b = got.radiance.float().numpy()
    assert np.isfinite(b).all() and b.shape == a.shape
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(axis=1)
    print(f"{case}/{span}: {int(bad.sum())} of {len(bad)} lanes beyond tolerance, "
          f"max abs {np.abs(a - b).max():.3g}")
    assert bad.mean() <= 0.005
    assert float(b.sum()) > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_span_and_perbounce_routes_are_identical(traces, case):
    """One kernel per span or one per bounce: the same function."""
    _, got = traces[case]
    for f in ("radiance", "origin", "direction", "throughput", "alive", "depth"):
        assert torch.equal(getattr(got["multi"], f), getattr(got["perbounce"], f))
    assert int(got["multi"].segments) == int(got["perbounce"].segments)


@pytest.mark.parametrize("span", ["multi", "perbounce"])
def test_furnace_exact(span):
    """Inside a unit emitter every ray returns exactly 1.0 in every bin, with
    the port's own random stream."""
    scene = T.compile_scene(scenes.furnace(), T.SpectralConfig(375.0, 740.0, B),
                            device="cpu")
    d = np.random.RandomState(0).normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = T.render_batch(scene, T.RayConfig(max_iters=4),
                        np.zeros((512, 3), np.float32), d,
                        torch.Generator().manual_seed(1), span=span,
                        device="cpu")
    assert torch.equal(st.radiance, torch.ones(512, B))
    assert int(st.segments) == 512 and not bool(st.alive.any())


def test_own_stream_statistics(cornell_pair):
    """The port's own generator: MIS on and off agree in mean radiance within
    Monte-Carlo noise (4 standard errors), and a seed reproduces."""
    _, ts = cornell_pair
    o, d = scenes.scatter_rays(4096, seed=5)
    means = {}
    for mis in (True, False):
        cfg = T.RayConfig(**dict(CFG, importance_sampling=mis, max_depth=8,
                                 max_iters=12))
        runs = [T.render_batch(ts, cfg, o, d, torch.Generator().manual_seed(s),
                               device="cpu").radiance.mean(1) for s in (11, 11, 12)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        means[mis] = runs[0]
    se = float(torch.sqrt(means[True].var() / 4096 + means[False].var() / 4096))
    diff = float((means[True].mean() - means[False].mean()).abs())
    print(f"MIS on/off mean radiance differ by {diff:.4g}, standard error {se:.4g}")
    assert diff <= 4.0 * se
    # MIS reaches the small light more often
    assert int((means[True] > 0).sum()) > int((means[False] > 0).sum())


def test_compaction_overflow_is_unbiased(cornell_pair):
    """A schedule that drops alive lanes reweights the survivors: the mean
    stays within noise of the uncompacted trace."""
    _, ts = cornell_pair
    o, d = scenes.scatter_rays(8192, seed=6)
    base = dict(CFG, max_depth=8, max_iters=12)
    full = T.render_batch(ts, T.RayConfig(**base), o, d,
                          torch.Generator().manual_seed(2), device="cpu")
    comp = T.render_batch(
        ts, T.RayConfig(**dict(base, compact_schedule=((2, 4), (3, 2)))), o, d,
        torch.Generator().manual_seed(2), device="cpu")
    assert int(comp.overflow) > 0 and int(full.overflow) == 0
    a, b = full.radiance.mean(1), comp.radiance.mean(1)
    se = float(torch.sqrt(a.var() / a.numel() + b.var() / b.numel()))
    assert float((a.mean() - b.mean()).abs()) <= 4.0 * se


_IMPORT_CHECK = """
import importlib.util, sys
import source_tpu_torch
from source_tpu_torch.tracer import fused
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "source_tpu", "triton")]
assert not bad, bad
assert not fused._libraries  # nothing was built or loaded by importing
print("clean")
"""


def test_imports_without_jax():
    """``source_tpu_torch`` and ``chip_smoke.py`` load in a fresh interpreter
    without pulling in jax, source_tpu or triton, and build nothing."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
