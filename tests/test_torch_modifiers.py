"""The modifiers, user BSDFs and inhomogeneous volumes of source_tpu_torch on
the wavefront route, against source_tpu on the CPU and against the
reference's own analytic checks.

``modifier_world`` (source_tpu_torch/scenes.py: a Blend of two Lamberts, an
Add of two emitters, a Roughen around a conductor, the user ContinuousBSDF
``UserLambert`` and DiscreteBSDF ``UserMirror``, the inhomogeneous emitter
``glow`` inside a VolumeTransform, a Lambert room and a light) is built by
each package from its own classes: the JAX one below holds the reference's
``_UserLambert``/``_UserMirror`` of tests/test_custom_bsdf.py and a jnp copy
of ``glow``. The port's compile equals the reference's table for table; the
traces then run the reference's arrays on both sides, carried across by
``scene_from_numpy(materials=)`` with the port's own material objects for
the user BSDF and volume rows.

  * ``trace_step`` four bounces, each from the reference's state, on the
    same 16 uniform columns (Roughen reads 8-15): continuous state within
    rtol 1e-5 / atol 1e-6 on the lanes whose choices agree, at most 0.5 %
    of lanes otherwise (the limits of tests/test_torch_wavefront.py, test e).
    The reference is compiled with LLVM's optimisation off.
  * The reference's analytic checks, in the port alone: tests/test_modifiers.py
    (Blend and Add of emitters, the inhomogeneous emitter's constant and
    linear profiles, VolumeTransform's offset frame), tests/test_custom_bsdf.py
    (user Lambert and user mirror against the built-ins, rtol 1e-5 on the
    same uniforms) and tests/test_roughen_estimator.py (low roughness is
    specular), at their tolerances.
  * The training step on a small ``modifier_world`` (16x16 rays, 5 bins, 4
    bounces) against the reference's ``jax.value_and_grad``, through
    ``masked_grad_pair`` as in tests/test_torch_wavefront_grad.py: loss rtol
    1e-5, each field within 1e-3 of its largest reference entry, at most
    0.5 % of lanes masked.
  * Routing: such scenes take the wavefront route; ``trace_rays`` draws 16
    uniforms a bounce under Roughen, 10 otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import source_tpu as S
import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.bridge import ARRAY_FIELDS, STATIC_FIELDS
from source_tpu_torch.core import Point3D, translate
from source_tpu_torch.optical import ConstantSF
from source_tpu_torch.optical.material import (
    Add, Blend, InhomogeneousVolumeEmitter, Lambert, NumericalIntegrator,
    PerfectReflectingSurface, Roughen, UniformSurfaceEmitter, VolumeTransform,
)
from source_tpu_torch.primitive import Box, Sphere
from source_tpu_torch.tracer import fused
from source_tpu_torch.tracer.wavefront import _n_uniforms, trace_step

from test_torch_common import (
    B, carry_scene, masked_grad_pair, trace_step_parity,
)

MAX_FLIP = 0.005
CAMERA = dict(fov=75.0, position=(0.0, 0.0, -4.0))
CFG = dict(max_depth=24, extinction_prob=0.01, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25, max_iters=4)


def _jax_glow(p_local, d_local, wavelengths):
    r2 = (p_local * p_local).sum(-1)
    rho = 3.0 * jnp.exp(-2.0 * r2) * (
        1.0 + 0.5 * jnp.sin(3.0 * p_local[..., 2]))
    return rho[..., None] * (wavelengths / 550.0)


def _jax_modifier_world():
    """``scenes.modifier_world`` with the reference's classes."""
    from source_tpu.optical import ConstantSF as JC, InterpolatedSF as JI
    from source_tpu.optical import material as JM
    from source_tpu.primitive import Box as JBox, Sphere as JSphere
    from test_custom_bsdf import _UserLambert, _UserMirror
    P = S.Point3D
    world = S.World()
    JBox(P(-6, -4, -6), P(6, 4, 7), parent=world, material=JM.Lambert(JC(0.5)))
    JBox(P(-2, 3.6, 0), P(2, 3.8, 4), parent=world,
         material=JM.UniformSurfaceEmitter(JI([400, 700], [2.0, 3.0])))
    JSphere(0.9, parent=world, transform=S.translate(-2.4, 1.3, 2.5),
            material=JM.Blend(JM.Lambert(JC(0.8)),
                              JM.Lambert(JI([400, 700], [0.1, 0.7])), 0.3))
    JSphere(0.9, parent=world, transform=S.translate(0.0, 1.3, 2.5),
            material=JM.Add(
                JM.UniformSurfaceEmitter(JC(0.5)),
                JM.UniformSurfaceEmitter(JI([400, 700], [1.0, 0.2]))))
    JBox(P(-0.8, -0.8, -0.8), P(0.8, 0.8, 0.8), parent=world,
         transform=S.translate(2.4, 1.3, 2.5) * S.rotate(30, 20, 0),
         material=JM.Roughen(JM.Conductor(JC(0.9), JC(6.0)), 0.3))
    JSphere(0.9, parent=world, transform=S.translate(-2.4, -1.3, 2.5),
            material=_UserLambert(0.6))
    JBox(P(-0.8, -0.8, -0.8), P(0.8, 0.8, 0.8), parent=world,
         transform=S.translate(0.0, -1.3, 2.5) * S.rotate(-25, 15, 0),
         material=_UserMirror())
    JSphere(0.9, parent=world, transform=S.translate(2.4, -1.3, 2.5),
            material=JM.VolumeTransform(
                JM.InhomogeneousVolumeEmitter(
                    _jax_glow,
                    JM.NumericalIntegrator(step=0.1, max_samples=16)),
                S.translate(0.0, 0.0, 0.3)))
    return world


@pytest.fixture(scope="module")
def worlds():
    """(JAX scene, the port's own compile, the JAX arrays carried to the
    port with the port's material objects)."""
    spectral = (375.0, 740.0, B)
    js = S.compile_scene(_jax_modifier_world(), S.SpectralConfig(*spectral))
    own = T.compile_scene(scenes.modifier_world(), T.SpectralConfig(*spectral),
                          device="cpu")
    materials = dict(own.custom_materials)
    materials.update({r[1]: r[3] for r in own.volume_entities})
    return js, own, carry_scene(js, materials=materials)


def _objects_dropped(scene, field):
    v = getattr(scene, field)
    if field == "volume_entities":
        v = tuple(r[:3] + r[4:] for r in v)
    elif field == "custom_materials":
        v = tuple(i for i, _ in v)
    return v


def test_compile_matches_jax(worlds):
    js, own, carried = worlds
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(own, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f in STATIC_FIELDS:
        assert _objects_dropped(own, f) == _objects_dropped(js, f), f
        assert _objects_dropped(carried, f) == _objects_dropped(js, f), f
    assert own.has_roughen and own.mix_remaps == ((2, 3, 4, 1.0), (5, 6, 7, 2.0))
    assert [type(m).__name__ for _, m in carried.custom_materials] == [
        "UserLambert", "UserMirror"]
    (vol,) = carried.volume_entities
    assert type(vol[3]).__name__ == "VolumeTransform" and vol[6] == 15
    assert fused.scene_tables(own, T.RayConfig(**CFG)) is None
    assert _n_uniforms(own) == 16


def test_carrying_needs_the_ports_objects(worlds):
    js = worlds[0]
    with pytest.raises(KeyError, match="materials"):
        carry_scene(js)


def _rays(n_side):
    return scenes.camera_rays(n_side, n_side, **CAMERA)


def test_trace_step_matches_jax(worlds):
    """Four bounces, each from the reference's state, on the same uniforms;
    every material of the scene is hit in the first."""
    js, _, ts = worlds
    o, d = _rays(32)
    first = T.tracer.intersect.intersect_scene(
        ts, torch.from_numpy(o), torch.from_numpy(d), need_grad=False)
    assert set(first.entity.tolist()) == set(range(ts.n_entities))
    u_all = np.random.RandomState(5).random_sample((4, len(o), 16)).astype(
        np.float32)
    differ, st = trace_step_parity(js, ts, dict(CFG, max_iters=8), o, d, u_all)
    print(f"trace_step: {int(differ.sum())} of {len(o)} lanes decide otherwise "
          "in some bounce")
    assert float(np.asarray(st.radiance).sum()) > 0.0


def test_training_step_matches_jax(worlds):
    js, _, ts = worlds
    o, d = _rays(16)
    r = masked_grad_pair(ts, js, CFG, o, d, jax.random.PRNGKey(7), B)
    print(f"modifier_world: {r['masked']} of {len(o)} lanes masked")
    assert r["masked"] <= MAX_FLIP * len(o)
    ref_loss, g_j = r["ref"]
    loss, g_p = r["got"]
    assert np.isfinite(ref_loss) and ref_loss > 0.0
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    for f in fused.TABLE_FIELDS:
        a = np.asarray(getattr(g_j, f), np.float64)
        b = g_p[f].double().numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all(), f
        scale = max(np.abs(a).max(), 1e-6)
        print(f"modifier_world/{f}: largest |ref| {np.abs(a).max():.4g}, "
              f"largest deviation {np.abs(a - b).max() / scale:.3g} of it")
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=1e-3,
                                   err_msg=f)
    # the inhomogeneous volume's frame and the surfaces' geometry
    for f in ("entity_w2l", "leaf_w2l", "mat_spectra"):
        assert bool((g_p[f] != 0).any()), f


# --- the reference's analytic checks, in the port ----------------------------


def _cfg(**kw):
    return T.RayConfig(**dict(dict(max_depth=6, extinction_prob=0.0, max_iters=8,
                                   importance_sampling=False), **kw))


def _sphere_rays(n, seed=0):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


def _render(world, o, d, cfg=None, seed=1, bins=4, **kw):
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, bins),
                            device="cpu")
    return T.render_batch(scene, cfg or _cfg(), o, d,
                          torch.Generator().manual_seed(seed), device="cpu",
                          **kw).radiance.numpy()


def test_blend_and_add_of_emitters():
    """Blend: every sample exactly 1 or 3, the mean 2; Add: every doubled
    sample exactly 1 + 1."""
    w = T.World()
    Sphere(5.0, parent=w, material=Blend(UniformSurfaceEmitter(ConstantSF(1.0)),
                                         UniformSurfaceEmitter(ConstantSF(3.0)),
                                         0.5))
    r = _render(w, *_sphere_rays(4096))
    assert set(np.round(np.unique(r), 4)).issubset({1.0, 3.0})
    assert abs(r.mean() - 2.0) < 0.1
    w = T.World()
    Sphere(5.0, parent=w, material=Add(UniformSurfaceEmitter(ConstantSF(1.0)),
                                       UniformSurfaceEmitter(ConstantSF(1.0))))
    assert np.allclose(_render(w, *_sphere_rays(256)), 2.0, atol=1e-4)


def _profile(p_local, d_local, wavelengths):
    rho = torch.clamp(p_local[..., 2], min=0.0)
    return rho[..., None].expand(rho.shape + (wavelengths.shape[0],))


def test_inhomogeneous_emitter_analytic():
    """A constant density in a sphere seen from its centre is density x
    radius; rho(z) = max(0, z) in a unit sphere integrates to 1/2 along +z
    and to 0 along -z; VolumeTransform by (0, 0, -0.5) makes the -z ray see
    max(0, 0.5 - s) over [0, 1], 1/8."""
    def constant(p_local, d_local, wavelengths):
        return torch.ones(p_local.shape[:-1] + (wavelengths.shape[0],))

    w = T.World()
    Sphere(2.0, parent=w, material=InhomogeneousVolumeEmitter(
        constant, NumericalIntegrator(max_samples=8)))
    assert np.allclose(_render(w, *_sphere_rays(64)), 2.0, atol=1e-3)
    o = np.zeros((2, 3), np.float32)
    d = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    w = T.World()
    Sphere(1.0, parent=w, material=InhomogeneousVolumeEmitter(
        _profile, NumericalIntegrator(max_samples=64)))
    r = _render(w, o, d)
    assert np.allclose(r[0], 0.5, atol=5e-3)
    assert np.allclose(r[1], 0.0, atol=1e-5)
    w = T.World()
    Sphere(1.0, parent=w, material=VolumeTransform(
        InhomogeneousVolumeEmitter(_profile,
                                   NumericalIntegrator(max_samples=64)),
        translate(0.0, 0.0, -0.5)))
    assert np.allclose(_render(w, o[1:], d[1:]), 0.125, atol=5e-3)


def _floor_scene(material):
    """An emitting ceiling over a floor of ``material``
    (tests/test_custom_bsdf.py)."""
    w = T.World()
    Box(Point3D(-2, 1.0, -2), Point3D(2, 1.2, 2), parent=w,
        material=UniformSurfaceEmitter(ConstantSF(2.0)))
    Box(Point3D(-2, -1.2, -2), Point3D(2, -1.0, 2), parent=w, material=material)
    return w


@pytest.mark.parametrize("user,builtin", [
    (lambda: scenes.UserLambert(0.5), lambda: Lambert(ConstantSF(0.5))),
    (scenes.UserMirror, PerfectReflectingSurface),
], ids=["lambert", "mirror"])
def test_user_bsdf_matches_builtin(user, builtin):
    """The same estimator on the same uniforms, MIS on: the user material
    traces as the built-in does."""
    rng = np.random.RandomState(3)
    o = np.stack([rng.uniform(-1, 1, 2048), np.zeros(2048),
                  rng.uniform(-1, 1, 2048)], 1).astype(np.float32)
    d = np.stack([rng.uniform(-0.5, 0.5, 2048), -np.ones(2048),
                  rng.uniform(-0.5, 0.5, 2048)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = T.RayConfig(max_depth=6, extinction_prob=0.05, max_iters=8)
    u = torch.rand((8, 2048, 10), generator=torch.Generator().manual_seed(4))

    def same_u(start, n_steps, n_lanes):
        return u[start:start + n_steps, :n_lanes]

    ours = _render(_floor_scene(user()), o, d, cfg, u_all=same_u)
    ref = _render(_floor_scene(builtin()), o, d, cfg, u_all=same_u)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    assert ours.max() > 0.0


def test_roughen_low_roughness_is_specular():
    """One bounce off a roughened mirror plane at 45 degrees: at roughness
    0.02 the mean outgoing direction is the mirror direction to 0.02; every
    lane draws 16 uniforms."""
    w = T.World()
    Box(Point3D(-100.0, -100.0, 1.0), Point3D(100.0, 100.0, 2.0), parent=w,
        material=Roughen(PerfectReflectingSurface(), 0.02))
    scene = T.compile_scene(w, T.SpectralConfig(375.0, 740.0, 2), device="cpu")
    n = 1 << 15
    th = np.pi / 4
    d = torch.tensor([np.sin(th), 0.0, np.cos(th)], dtype=torch.float32).expand(
        n, 3).contiguous()
    st = T.init_rays(torch.zeros((n, 3)), d, scene.bins)
    u = torch.rand((n, _n_uniforms(scene)),
                   generator=torch.Generator().manual_seed(5))
    nxt = trace_step(scene, _cfg(max_depth=4, max_iters=4), st, u)
    out = nxt.direction[nxt.alive].numpy()
    specular = np.asarray([np.sin(th), 0.0, -np.cos(th)])
    assert len(out) == n
    assert np.linalg.norm(out.mean(axis=0) - specular) < 0.02
    assert not np.allclose(out, specular, atol=1e-4)  # the normal moved


def test_forward_route_draws_sixteen_uniforms_under_roughen(worlds):
    """``trace_rays`` draws the uniforms itself: 16 a bounce under Roughen
    (with 10, the Roughen tries would index past them); the scene renders
    finite, every first-hit material's lanes receiving radiance."""
    _, own, _ = worlds
    o, d = _rays(32)
    st = T.render_batch(own, T.RayConfig(**dict(CFG, max_iters=8)), o, d,
                        torch.Generator().manual_seed(2), device="cpu")
    rad = st.radiance.numpy()
    assert np.isfinite(rad).all()
    first = T.tracer.intersect.intersect_scene(
        own, torch.from_numpy(o), torch.from_numpy(d), need_grad=False).entity
    for e in range(own.n_entities):
        assert rad[first.numpy() == e].mean() > 0.0, e
