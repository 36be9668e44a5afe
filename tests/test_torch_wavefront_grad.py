"""The differentiable wavefront route of source_tpu_torch against source_tpu,
on the CPU.

``render_loss_and_grads`` of the port (``trace_rays_diff``: ``trace_step``
under autograd in checkpoint blocks of ``cfg.remat_block`` bounces, the
kernels' plain versions on CPU tensors) against the reference's
``jax.value_and_grad`` of the same loss over the same scene pytree
(``render_batch(differentiable=True)``: a scan of ``trace_step``,
SOURCE_TPU_FUSED=0, SOURCE_TPU_LEAF_BVH=0), on numpy-seeded camera rays, the
reference's uniforms through ``u_all`` and its compaction rotations through
``shifts``, target 0:

  * the CSG demo: 16x16 rays of its camera, 5 bins, max_iters 6, one
    compaction stage ((4, 4));
  * ``scenes.mesh_world(small=True)``: 16x16 rays of the mesh demo's camera,
    5 bins, max_iters 5, no compaction, the port's compile carried to JAX by
    ``to_jax`` (the JAX compile of the dispersive glass costs seconds).

Each reference is compiled by ``jax_compiled``, at
``xla_backend_optimization_level=0`` (at the default level XLA zeroes the
normal of some CSG glass hits, ROADMAP.md queue 3), with the reference's
``remat_block=0``: at level 0 its ``jax.checkpoint`` of a block returns NaN
in ``leaf_w2l``, ``leaf_params`` and ``mat_scalars`` on both scenes (and in
six more fields on the mesh demo) where the same function without the
checkpoint is finite (queue 3). The port runs at its default remat_block 1.

Compared: the loss (rtol 1e-5) and every gradient field, ``TABLE_FIELDS`` and
each mesh's ``vertices``, ``w2l``, ``vertex_normals`` and ``face_normals``,
within 1e-3 of the field's largest reference entry (the fields agree to a
few 1e-6; XLA's FMA contraction of the mesh VJP needs no more).

Lanes: a lane whose choices differ between the packages in some bounce ends
with another radiance, so the comparison masks the lanes whose forward
radiance differs (rtol 1e-4, atol 1e-6), at most 0.5 % of them, the same
lanes on both sides: their target becomes the side's own radiance, so they
add nothing to the loss or to the gradient.

Port-only: remat_block 0 and 3 against 1 (loss rtol 1e-6, gradients 1e-5 of
the largest entry); a central difference in the largest-gradient emission
entry of ``mat_spectra``, where radiance is linear and the loss quadratic
(rtol 1e-3); Euler's identity (sum(value * gradient) over the emission rows
is 2 loss, to 1e-4); the plain analytic-BVH and mesh winners run twice a
bounce in a checkpointed step (forward and recompute) and once at
remat_block 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.optical.material.base import (
    MAT_CHECKERBOARD, MAT_EMITTER,
)
from source_tpu_torch.parallel.engine import MESH_FIELDS
from source_tpu_torch.tracer import fused
from source_tpu_torch.tracer import intersect as TI
from source_tpu_torch.tracer import meshtrace as TM

from test_torch_common import B, euler_ratio, masked_grad_pair, to_jax

MAX_MASKED = 0.005
FIELD_TOL = 1e-3
KEY = 23
CASES = {
    "csg": dict(
        world=scenes.csg_world,
        camera=dict(width=16, height=16, fov=75.0, position=(0.0, 0.0, -4.0)),
        cfg=dict(max_depth=24, extinction_prob=0.01, extinction_min_depth=3,
                 importance_sampling=True, important_path_weight=0.25,
                 max_iters=6, compact_schedule=((4, 4),))),
    "mesh": dict(
        world=lambda: scenes.mesh_world(small=True),
        camera=dict(scenes.MESH_CAMERA, width=16, height=16),
        cfg=dict(max_depth=12, extinction_prob=0.01, extinction_min_depth=3,
                 importance_sampling=True, important_path_weight=0.25,
                 max_iters=5)),
}


class _Calls:
    """Counts the plain winners' calls: the analytic-BVH winner in
    ``intersect_scene`` and the mesh walk in ``mesh_intersect``."""

    def __init__(self, monkeypatch):
        self.n = {"bvh": 0, "mesh": 0}
        for module, name, key in ((TI, "analytic_bvh_winner", "bvh"),
                                  (TM, "_nearest", "mesh")):
            real = getattr(module, name)

            def counted(*a, _real=real, _key=key, **kw):
                self.n[_key] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(module, name, counted)


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's scene, configuration, rays and streams, and the
    step of both packages on the masked target (``masked_grad_pair``)."""
    out = {}
    for name, c in CASES.items():
        ts = T.compile_scene(c["world"](), T.SpectralConfig(375.0, 740.0, B),
                             device="cpu")
        o, d = scenes.camera_rays(**c["camera"])
        pair = masked_grad_pair(ts, to_jax(ts), c["cfg"], o, d,
                                jax.random.PRNGKey(KEY), B)
        out[name] = dict(pair, ts=ts, cfg=T.RayConfig(**c["cfg"]), o=o, d=d)
        print(f"{name}: {pair['masked']} of {len(o)} lanes masked")
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(runs, name):
    r = runs[name]
    assert r["masked"] <= MAX_MASKED * len(r["o"])
    ref_loss, (loss, grads) = r["ref"][0], r["got"]
    assert np.isfinite(ref_loss) and ref_loss > 0.0
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert not loss.requires_grad
    assert set(grads) == set(fused.TABLE_FIELDS) | (
        {"meshes"} if r["ts"].meshes else set())


def _compare(name, field, a, b, shape):
    a = np.asarray(a, np.float64)
    b = b.double().numpy()
    assert a.shape == b.shape == tuple(shape), field
    assert np.isfinite(a).all() and np.isfinite(b).all(), field
    scale = max(np.abs(a).max(), 1e-6)
    print(f"{name}/{field}: largest |ref| {np.abs(a).max():.4g}, largest "
          f"deviation {np.abs(a - b).max() / scale:.3g} of it")
    np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=FIELD_TOL,
                               err_msg=field)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_matches_jax(runs, name):
    r = runs[name]
    ts, g_j, g_p = r["ts"], r["ref"][1], r["got"][1]
    for f in fused.TABLE_FIELDS:
        a = np.asarray(getattr(g_j, f))
        assert np.isfinite(a).all(), f  # assert_allclose takes NaN for equal
        _compare(name, f, a, g_p[f], getattr(ts, f).shape)
    for f in ("leaf_w2l", "leaf_params", "mat_spectra"):
        assert bool((g_p[f] != 0).any()), f


def test_mesh_gradients_match_jax(runs):
    r = runs["mesh"]
    ts, g_j, g_p = r["ts"], r["ref"][1], r["got"][1]
    assert len(g_p["meshes"]) == len(ts.meshes) == 2
    for slot, (jm, pm) in enumerate(zip(g_j.meshes, g_p["meshes"])):
        assert set(pm) == set(MESH_FIELDS)
        for f in MESH_FIELDS:
            _compare(f"mesh{slot}", f, getattr(jm, f), pm[f],
                     getattr(ts.meshes[slot], f).shape)
        # smoothed meshes: the shading normal reads the vertex normals only
        assert bool((pm["vertices"] != 0).any())
        assert bool((pm["w2l"] != 0).any())
        assert not bool((pm["face_normals"] != 0).any())


@pytest.mark.parametrize("name", list(CASES))
def test_euler_identity_and_remat_blocks(runs, name, monkeypatch):
    """Euler's identity on the emission rows (target 0, no lane masked), and
    the same step with every bounce saved (remat_block 0) and in blocks of 3
    against the per-bounce checkpoint; the plain winners run twice a bounce
    in a checkpointed step (forward and recompute) and once at remat_block
    0: the analytic-BVH winner once a bounce in ``intersect_scene``, the mesh
    walk once per mesh there and once per closed volume mesh (the
    containment probe)."""
    r = runs[name]
    ts, cfg, o, d = r["ts"], r["cfg"], r["o"], r["d"]
    zero = np.zeros((len(o), B), np.float32)
    it = cfg.max_iters
    k7 = len(ts.meshes) + sum(1 for v in ts.volume_entities
                              if v[5] >= 0 and ts.meshes[v[5]].closed)
    got = {}
    for rb in (1, 0, 3):
        calls = _Calls(monkeypatch)
        got[rb] = T.render_loss_and_grads(
            ts, dataclasses.replace(cfg, remat_block=rb), o, d, zero,
            u_all=r["u_all"], shifts=r["shifts"], device="cpu")
        passes = 1 if rb == 0 else 2
        assert calls.n == {"bvh": passes * it, "mesh": passes * k7 * it}, rb
        monkeypatch.undo()
    assert abs(euler_ratio(ts, *got[1]) - 1.0) <= 1e-4
    for rb in (0, 3):
        np.testing.assert_allclose(float(got[rb][0]), float(got[1][0]),
                                   rtol=1e-6)
        for f in fused.TABLE_FIELDS:
            a, b = got[1][1][f], got[rb][1][f]
            scale = max(float(a.abs().max()), 1e-6)
            assert float((a - b).abs().max()) <= 1e-5 * scale, (rb, f)
        for pa, pb in zip(got[1][1].get("meshes", ()),
                          got[rb][1].get("meshes", ())):
            for f in MESH_FIELDS:
                scale = max(float(pa[f].abs().max()), 1e-6)
                assert float((pa[f] - pb[f]).abs().max()) <= 1e-5 * scale


def test_central_difference_in_an_emission_entry(runs):
    """Radiance is linear in an emission entry, so the loss is quadratic in
    it and the central difference is the derivative."""
    r = runs["csg"]
    ts, cfg, o, d = r["ts"], r["cfg"], r["o"], r["d"]
    zero = np.zeros((len(o), B), np.float32)
    loss, grads = T.render_loss_and_grads(ts, cfg, o, d, zero, u_all=r["u_all"],
                                          shifts=r["shifts"], device="cpu")
    rows = [m for m, t in enumerate(ts.mat_types)
            if t in (MAT_EMITTER, MAT_CHECKERBOARD)]
    g = grads["mat_spectra"][rows, 0]
    i, b = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    m = rows[i]
    h = 0.05 * float(ts.mat_spectra[m, 0, b])

    def loss_at(delta):
        spectra = ts.mat_spectra.clone()
        spectra[m, 0, b] += delta
        s = dataclasses.replace(ts, mat_spectra=spectra)
        rad = T.render_batch(s, cfg, o, d, u_all=r["u_all"],
                             shifts=r["shifts"], differentiable=True,
                             device="cpu").radiance
        return float(torch.mean(rad.double() ** 2))

    fd = (loss_at(h) - loss_at(-h)) / (2.0 * h)
    print(f"csg: d loss / d mat_spectra[{m}, 0, {b}] {float(g[i, b])}, "
          f"central difference {fd}")
    assert abs(float(g[i, b])) > 0.0
    np.testing.assert_allclose(float(g[i, b]), fd, rtol=1e-3)


def test_route_arguments_and_scene_left_alone(runs):
    r = runs["csg"]
    ts, cfg, o, d = r["ts"], r["cfg"], r["o"], r["d"]
    assert fused.scene_tables(ts, cfg, general=True) is None
    assert not any(getattr(ts, f).requires_grad for f in fused.TABLE_FIELDS)
    for m in runs["mesh"]["ts"].meshes:
        assert not any(getattr(m, f).requires_grad for f in MESH_FIELDS)
    with pytest.raises(ValueError, match="wavefront"):
        T.render_batch(ts, cfg, o, d, rng="kernel", differentiable=True,
                       device="cpu")
    with pytest.raises(ValueError, match="span"):
        T.render_batch(ts, cfg, o, d, span="both", differentiable=True,
                       device="cpu")
