"""Host front end of source_tpu_torch against source_tpu.

The port's scenegraph -> ``compile_scene`` -> ``fused_spec`` ->
``pack_tabvec`` chain must produce the same tables as the JAX package's on
the same scene: the glass Cornell box and the "zoo" scene (every other
built-in material, all six solids). Everything runs on the CPU.

Tolerance: array fields rtol 1e-6 (atol 1e-6 on the spectra). The port
resamples spectral curves in float64 numpy where the JAX package does it in
float32 jnp, so baked spectra differ in the last float32 digit; every other
field comes from the same float64 host arithmetic and is bit-equal.
"""

import numpy as np
import pytest
import torch

from demos.cornell_box import build_world
import source_tpu as S
from source_tpu.tracer import pallas_fused as PF
from source_tpu.tracer.wavefront import RayConfig as JaxRayConfig

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.bridge import ARRAY_FIELDS, STATIC_FIELDS, scene_from_numpy
from source_tpu_torch.tracer import fused

from test_torch_common import B, CFG, carry_scene, jax_zoo

SPECTRAL = (375.0, 740.0, B)


@pytest.fixture(scope="module")
def pairs():
    """(JAX scene, port scene) per scene name, each compiled by its own
    package from its own scenegraph classes."""
    return {
        "cornell": (
            S.compile_scene(build_world(glass=True), S.SpectralConfig(*SPECTRAL)),
            T.compile_scene(scenes.cornell_box(glass=True),
                            T.SpectralConfig(*SPECTRAL), device="cpu")),
        "zoo": (
            jax_zoo(),
            T.compile_scene(scenes.zoo(), T.SpectralConfig(*SPECTRAL),
                            device="cpu")),
    }


def _static(scene, name):
    v = getattr(scene, name)
    if name == "volume_entities":  # drop the material object
        v = tuple(r[:3] + r[4:] for r in v)
    return v


@pytest.mark.parametrize("field", ARRAY_FIELDS)
def test_cornell_array_field(pairs, field):
    js, ts = pairs["cornell"]
    a, b = np.asarray(getattr(js, field)), getattr(ts, field).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("field", STATIC_FIELDS)
def test_cornell_static_field(pairs, field):
    js, ts = pairs["cornell"]
    assert _static(js, field) == _static(ts, field)


def test_zoo_scene_fields(pairs):
    js, ts = pairs["zoo"]
    for field in ARRAY_FIELDS:
        np.testing.assert_allclose(
            getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
            rtol=1e-6, atol=1e-6, err_msg=field)
    for field in STATIC_FIELDS:
        assert _static(js, field) == _static(ts, field), field


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_fused_spec_and_table(pairs, name):
    js, ts = pairs[name]
    jspec = PF.fused_spec(js, JaxRayConfig(**CFG))
    tspec = fused.fused_spec(ts, T.RayConfig(**CFG))
    assert jspec is not None and tspec is not None
    assert jspec.__dict__ == tspec.__dict__
    assert PF.tab_size(jspec) == fused.tab_size(tspec)
    jtab = np.asarray(PF.pack_tabvec(js, jspec))
    ttab = fused.pack_tabvec(ts, tspec).numpy()
    np.testing.assert_allclose(ttab, jtab, rtol=1e-6, atol=1e-6)
    # the geometry part (leaf records, fast records through inv(w2l)) is exact
    n_geo = 20 * len(tspec.leaves)
    np.testing.assert_array_equal(ttab[:n_geo], jtab[:n_geo])


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_scene_from_numpy_round_trip(pairs, name):
    """A JAX-compiled scene carried across as numpy equals it field by field
    and gives the same spec and table as the port's own compile."""
    js, ts = pairs[name]
    carried = carry_scene(js)
    for field in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(carried, field).numpy(),
                                      np.asarray(getattr(js, field)))
    for field in STATIC_FIELDS:
        assert _static(carried, field) == _static(js, field)
    cfg = T.RayConfig(**CFG)
    assert fused.fused_spec(carried, cfg) == fused.fused_spec(ts, cfg)
    np.testing.assert_array_equal(
        fused.pack_tabvec(carried, fused.fused_spec(carried, cfg)).numpy(),
        np.asarray(PF.pack_tabvec(js, PF.fused_spec(js, JaxRayConfig(**CFG)))))


def test_scene_from_numpy_missing_field(pairs):
    js, _ = pairs["cornell"]
    arrays = {k: np.asarray(getattr(js, k)) for k in ARRAY_FIELDS[1:]}
    with pytest.raises(KeyError, match="leaf_w2l"):
        scene_from_numpy(arrays, {}, device="cpu")


def test_spec_descriptor_layout(pairs):
    """The int32 descriptor the CUDA kernels read mirrors the spec."""
    _, ts = pairs["zoo"]
    spec = fused.fused_spec(ts, T.RayConfig(**CFG))
    desc = fused.spec_descriptor(spec)
    L = len(spec.leaves)
    assert desc.dtype == np.int32
    assert desc[0] == L and desc[1] == len(spec.volumes) and desc[2] == spec.n_imp
    assert desc[7] == fused.tab_size(spec)
    assert len(desc) == (fused.DESC_HEADER + fused.DESC_LEAF_WORDS * L
                         + fused.DESC_VOL_WORDS * len(spec.volumes))
    flags = int(desc[3])
    assert flags & fused.F_USE_MIS and flags & fused.F_NEEDS_MIS
    assert flags & fused.F_HAS_CHECKER and not flags & fused.F_HAS_DIELECTRIC
    assert not flags & fused.F_MAX_DISTANCE
    for g, (tid, e, m, kind) in enumerate(spec.leaves):
        row = desc[fused.DESC_HEADER + 5 * g: fused.DESC_HEADER + 5 * g + 5]
        assert tuple(row[:4]) == (tid, m, spec.mat_types[m], kind)
        if e in spec.check_entities:
            assert row[4] == fused._off_check(spec, e)
        else:
            assert row[4] == -1


def test_unported_parts_raise():
    """What the port does not cover yet says so instead of going wrong: a
    user BSDF that lacks the contract's methods raises, naming what is
    missing. The direct queries, which raised here before they were ported,
    answer (tests/test_torch_query.py holds them to the reference). CSG,
    meshes and the modifier paths compile and trace on the wavefront route,
    forward and differentiable (a mesh scene among the cases)."""
    import dataclasses
    from source_tpu_torch.core import Ray
    world = scenes.furnace()
    ix = world.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1)), device="cpu")
    assert ix.exiting and ix.primitive is world.primitives[0]
    assert world.primitives[0].contains(T.Point3D(0, 0, 0), device="cpu")
    from source_tpu_torch.optical.material import Light, Lambert
    from source_tpu_torch.optical.material.base import ContinuousBSDF
    with pytest.raises(NotImplementedError):
        Light(T.Vector3D(0, 0, 1))

    class Custom(ContinuousBSDF):
        pass

    w = T.World()
    from source_tpu_torch.primitive import Sphere
    Sphere(1.0, parent=w, material=Custom())
    scene = T.compile_scene(w, T.SpectralConfig(*SPECTRAL), device="cpu")
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    for differentiable in (False, True):
        with pytest.raises(NotImplementedError, match="must implement sample"):
            T.render_batch(scene, T.RayConfig(), o, d,
                           differentiable=differentiable, device="cpu")
    ok = T.compile_scene(scenes.furnace(), T.SpectralConfig(*SPECTRAL),
                         device="cpu")
    st = T.render_batch(ok, T.RayConfig(max_iters=2), o, d, differentiable=True,
                        device="cpu")
    assert torch.equal(st.radiance, torch.ones(4, B))
    # the wavefront route carries what it refused before: a Roughen of
    # roughness 0 and a mix whose both children are the emitter leave the
    # furnace exact
    for change in (dict(has_roughen=True), dict(mix_remaps=((0, 0, 0, 1.0),))):
        st = T.render_batch(dataclasses.replace(ok, **change),
                            T.RayConfig(max_iters=2), o, d, route="wavefront",
                            device="cpu")
        assert torch.equal(st.radiance, torch.ones(4, B)), change
    # meshes compile and trace, forward and differentiable; the direct
    # primitive queries on a mesh answer with a MeshIntersection
    from source_tpu_torch.primitive import Mesh, MeshIntersection
    mesh_world = T.World()
    mesh = Mesh(*scenes.cube_mesh(), closed=True, parent=mesh_world,
                material=Lambert())
    ix = mesh.hit(Ray(T.Point3D(0.1, 0.2, -5), T.Vector3D(0, 0, 1)),
                  device="cpu")
    assert isinstance(ix, MeshIntersection) and ix.primitive is mesh
    assert ix.triangle >= 0 and not ix.exiting
    ms = T.compile_scene(mesh_world, T.SpectralConfig(*SPECTRAL), device="cpu")
    st = T.render_batch(ms, T.RayConfig(max_iters=2), o, d, differentiable=True,
                        device="cpu")
    assert bool(torch.isfinite(st.radiance).all())
    # CSG now compiles, and traces on the wavefront route
    from source_tpu_torch.primitive import Intersect
    csg = T.World()
    Intersect(Sphere(1.0), Sphere(1.0, transform=T.translate(0.5, 0, 0)),
              parent=csg, material=Lambert())
    cs = T.compile_scene(csg, T.SpectralConfig(*SPECTRAL), device="cpu")
    assert len(cs.csg_entities) == 1 and cs.simple_leaf_of_entity == (-1,)
    st = T.render_batch(cs, T.RayConfig(max_iters=2), o, d, device="cpu")
    # from inside the lens every ray scatters off its inner wall twice
    assert bool(torch.isfinite(st.radiance).all()) and int(st.segments) == 8
    assert Lambert().MAT_TYPE == 1


def test_default_device_is_the_card():
    """Entry points default to CUDA and raise without a card; they never
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compile_scene(scenes.furnace(), T.SpectralConfig(*SPECTRAL))
    scene = T.compile_scene(scenes.furnace(), T.SpectralConfig(*SPECTRAL),
                            device="cpu")
    o = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.render_batch(scene, T.RayConfig(), o, o + 1.0)
