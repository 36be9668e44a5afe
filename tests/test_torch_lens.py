"""The port's lenses and optical library against source_tpu's, on the CPU.

The port runs on CPU tensors, its kernels through their plain versions; the
reference traces at SOURCE_TPU_LEAF_BVH=0 (its streaming route) and
SOURCE_TPU_FUSED=0.

  (a) the five spherical lenses: the reference's validation; containment
      on a grid; ``intersect_scene`` on a fan of rays through a world
      holding all five (the port through the analytic-BVH winner, both with
      and without the differentiable recompute, and through ``World.hit``
      one ray at a time) within 1e-5 of the reference's; the paraxial
      focal length of tests/test_lens.py; ``EncapsulatedPrimitive``'s
      delegation;
  (b) each of the 18 measured metals and its rough form, the ten named
      colours and ``BlackBody`` resampled as the scene compiler resamples
      them, against the reference's ``interp.sample_bins`` on the
      reference's own tables, evaluated in float64 numpy (the port resamples
      in float64 numpy; the reference's spectral functions hand it float32
      jnp arrays, which lose up to ~1e-5 to cancellation in the cumulative
      integral of a long measured table): within 1e-6;
  (c) every table of ``compile_scene`` of the two lens demos
      (``scenes.cooke_triplet_world``, ``scenes.metal_lens_world``) against
      the reference's compile of the demos' own worlds: rtol 1e-6, atol
      1e-6 on the spectra, static structure equal;
  (d) an 8x8 pixel, 2 spp observation of the metal lens demo through its
      ``TargetedCCDArray`` with the reference's streams injected, the
      reference handed its own compile of (c): frames within
      tests/test_torch_observers.py's tolerances, its atol taken relative
      to the frame's largest entry (the CCD reads power, ~1e-7 a pixel).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world as jax_cornell_world
from demos.observers.cornell_box_cooke_triplet import build_camera as jax_cooke
from demos.observers.metal_with_lens import build_world as jax_metal_world
import source_tpu as S
from source_tpu.core.math import interp as JI
from source_tpu.optical import library as JL
from source_tpu.optical import observer as JO
from source_tpu.optical.material import Lambert as JLambert
from source_tpu.optical.observer import base as JOB
from source_tpu.primitive import lens as JLens
from source_tpu.tracer.intersect import (
    entity_contains as jax_entity_contains, intersect_scene as jax_intersect,
)

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.bridge import ARRAY_FIELDS, STATIC_FIELDS
from source_tpu_torch.core import Ray
from source_tpu_torch.optical import ConstantSF
from source_tpu_torch.optical import library as TL
from source_tpu_torch.optical import observer as TO
from source_tpu_torch.optical.material import Dielectric, Lambert
from source_tpu_torch.primitive import EncapsulatedPrimitive, Sphere
from source_tpu_torch.primitive import lens as TLens
from source_tpu_torch.tracer.intersect import entity_contains, intersect_scene

from test_torch_common import B, env
from test_torch_observers import ref_streams

TOL = 1e-5
REF_ENV = dict(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0")
SPECTRAL = (375.0, 740.0, B)

# (class name, arguments) of tests/test_lens.py's five lenses, and arguments
# each must refuse (spherical.pyx validation)
LENSES = {
    "BiConvex": ((0.02, 0.006, 0.05, 0.05), [(0.02, 0.001, 0.05, 0.05),
                                             (0.02, 0.006, 0.005, 0.05)]),
    "BiConcave": ((0.02, 0.003, 0.05, 0.05), [(0.0, 0.003, 0.05, 0.05),
                                              (0.02, 0.003, 0.05, 0.009)]),
    "PlanoConvex": ((0.02, 0.005, 0.05), [(0.02, 0.0005, 0.05),
                                          (0.02, -0.005, 0.05)]),
    "PlanoConcave": ((0.02, 0.003, 0.05), [(0.02, 0.003, 0.008),
                                           (-0.02, 0.003, 0.05)]),
    "Meniscus": ((0.02, 0.004, 0.05, 0.1), [(0.02, 0.0001, 0.05, 0.1),
                                            (0.02, 0.004, 0.05, 0.0)]),
}
NAMES = list(LENSES)
PITCH = 0.04  # the lenses stand side by side along x, this far apart


def _lens_world(pkg, lens_mod, lambert):
    w = pkg.World()
    for i, name in enumerate(NAMES):
        getattr(lens_mod, name)(*LENSES[name][0], parent=w,
                                transform=pkg.translate(PITCH * i, 0, 0),
                                material=lambert())
    return w


def _fan():
    """Per lens 28 rays: 20 from in front across its aperture, some tilted,
    and 8 from points inside its body, aimed every way."""
    rng = np.random.default_rng(3)
    o, d = [], []
    for i, name in enumerate(NAMES):
        x0 = PITCH * i
        mid = 0.5 * LENSES[name][0][1]
        xs = np.linspace(-0.0125, 0.0125, 20)
        o.append(np.c_[x0 + xs, rng.uniform(-0.004, 0.004, 20),
                       np.full(20, -0.05)])
        d.append(np.c_[rng.uniform(-0.1, 0.1, (20, 2)), np.ones(20)])
        o.append(np.c_[x0 + rng.uniform(-0.003, 0.003, 8),
                       rng.uniform(-0.003, 0.003, 8), np.full(8, mid)])
        d.append(rng.normal(size=(8, 3)))
    o, d = np.concatenate(o), np.concatenate(d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


N_FAN = 28
GRID = np.stack(np.meshgrid(np.linspace(-0.012, 0.012, 7), [0.0, 0.005],
                            np.linspace(-0.002, 0.008, 6), indexing="ij"),
                -1).reshape(-1, 3)


@pytest.fixture(scope="module")
def five():
    o, d = _fan()
    with env(**REF_ENV):
        js = S.compile_scene(_lens_world(S, JLens, JLambert),
                             S.SpectralConfig(*SPECTRAL))
        # compiled once: op by op the reference takes seconds longer
        jrec = jax.jit(lambda o, d: jax_intersect(js, o, d))(
            jnp.asarray(o), jnp.asarray(d))
        pts = np.concatenate([GRID + [PITCH * i, 0, 0]
                              for i in range(len(NAMES))]).astype(np.float32)
        jin = np.asarray(jax.jit(lambda p: jax_entity_contains(js, p))(
            jnp.asarray(pts)))
    tworld = _lens_world(T, TLens, Lambert)
    ts = T.compile_scene(tworld, T.SpectralConfig(*SPECTRAL), device="cpu")
    assert ts.leaf_bvh is not None and len(ts.kernel_csg_entities) == len(NAMES)
    recs = {need_grad: intersect_scene(ts, torch.from_numpy(o),
                                       torch.from_numpy(d), need_grad=need_grad)
            for need_grad in (True, False)}
    hits = [tworld.hit(Ray(T.Point3D(*a), T.Vector3D(*b)), device="cpu")
            for a, b in zip(o.astype(np.float64), d.astype(np.float64))]
    return dict(
        o=o, jrec={k: np.asarray(getattr(jrec, k)) for k in
                   ("hit", "t", "entity", "normal", "exiting", "point")},
        trecs={g: {k: getattr(r, k).numpy() for k in
                   ("hit", "t", "entity", "normal", "exiting", "point")}
               for g, r in recs.items()},
        hits=hits, prims=tworld.primitives, jin=jin,
        tin=entity_contains(ts, torch.from_numpy(pts)).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_lens_validation(name):
    args, bad = LENSES[name]
    lens = getattr(TLens, name)(*args)
    ref = getattr(JLens, name)(*args)
    for attr in ("diameter", "center_thickness", "edge_thickness"):
        assert getattr(lens, attr) == getattr(ref, attr)
    for b in bad:
        with pytest.raises(ValueError):
            getattr(JLens, name)(*b)
        with pytest.raises(ValueError):
            getattr(TLens, name)(*b)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("need_grad", [True, False])
def test_lens_intersect_matches_reference(five, name, need_grad):
    i = NAMES.index(name)
    lanes = slice(N_FAN * i, N_FAN * (i + 1))
    ref = {k: v[lanes] for k, v in five["jrec"].items()}
    got = {k: v[lanes] for k, v in five["trecs"][need_grad].items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    assert ref["hit"].sum() >= N_FAN // 2
    h = ref["hit"]
    np.testing.assert_array_equal(got["entity"][h], ref["entity"][h])
    np.testing.assert_array_equal(got["exiting"][h], ref["exiting"][h])
    assert ref["exiting"][h].any() and not ref["exiting"][h].all()
    for k in ("t", "normal", "point"):
        np.testing.assert_allclose(got[k][h], ref[k][h], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_lens_world_hit_matches_reference(five, name):
    """World.hit one ray at a time (the BVH winner's record, no recompute)
    against the reference's batch: the world-space hit point, distance,
    exiting flag and primitive."""
    i = NAMES.index(name)
    ref = five["jrec"]
    for n in range(N_FAN * i, N_FAN * (i + 1)):
        ix = five["hits"][n]
        assert (ix is not None) == bool(ref["hit"][n])
        if ix is None:
            continue
        assert five["prims"].index(ix.primitive) == ref["entity"][n] == i
        assert ix.exiting == bool(ref["exiting"][n])
        np.testing.assert_allclose(ix.ray_distance, ref["t"][n], rtol=TOL,
                                   atol=TOL)
        p = ix.hit_point.transform(ix.primitive_to_world)
        np.testing.assert_allclose([p.x, p.y, p.z], ref["point"][n],
                                   rtol=TOL, atol=TOL)
        nw = ix.normal.transform(ix.world_to_primitive)  # back to world
        np.testing.assert_allclose(np.asarray([nw.x, nw.y, nw.z]) /
                                   math.hypot(nw.x, nw.y, nw.z),
                                   ref["normal"][n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_lens_contains_matches_reference(five, name):
    i = NAMES.index(name)
    rows = slice(len(GRID) * i, len(GRID) * (i + 1))
    got, ref = five["tin"][rows], five["jin"][rows]
    np.testing.assert_array_equal(got, ref)
    assert got[:, i].any() and not got[:, i].all()
    # tests/test_lens.py's points: on the axis inside, below, beside
    args = LENSES[name][0]
    lens = getattr(TLens, name)(*args, material=Lambert())
    w = T.World()
    lens.parent = w
    mid = 0.5 * lens.center_thickness
    assert lens.contains(T.Point3D(0, 0, mid), device="cpu")
    assert not lens.contains(T.Point3D(0, 0, -1), device="cpu")
    assert not lens.contains(T.Point3D(0.015, 0, mid), device="cpu")


def test_biconvex_focal_length():
    """tests/test_lens.py::test_biconvex_focal_length in the port: paraxial
    rays through an f=51mm biconvex lens (n=1.5, R=50mm, d=6mm) cross the
    axis at the lensmaker back focal distance."""
    n_glass, R, d_thick = 1.5, 0.05, 0.006
    w = T.World()
    TLens.BiConvex(0.02, d_thick, R, R, parent=w,
                   material=Dielectric(ConstantSF(n_glass), ConstantSF(1.0),
                                       transmission_only=True))
    scene = T.compile_scene(w, T.SpectralConfig(375.0, 740.0, 4), device="cpu")
    cfg = T.RayConfig(max_depth=8, extinction_prob=0.0, max_iters=8,
                      importance_sampling=False)
    hs = np.asarray([0.002, 0.003, -0.0025])
    o = torch.tensor([[h, 0.0, -0.05] for h in hs], dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    final = T.trace_rays(scene, cfg, T.init_rays(o, d, scene.bins),
                         torch.Generator().manual_seed(0))
    oo, dd = final.origin.numpy(), final.direction.numpy()
    z_cross = oo[:, 2] + (-oo[:, 0] / dd[:, 0]) * dd[:, 2]
    f = 1.0 / ((n_glass - 1) * (2.0 / R - (n_glass - 1) * d_thick
                                / (n_glass * R * R)))
    bfd = f * (1.0 - (n_glass - 1) * d_thick / (n_glass * R))
    assert np.allclose(z_cross, d_thick + bfd, atol=0.002), z_cross


def test_encapsulated_primitive_delegates():
    inner = Sphere(radius=0.5)
    wrapped = EncapsulatedPrimitive(inner, material=Lambert(),
                                    transform=T.translate(0, 0, 0.25))
    w = T.World()
    wrapped.parent = w
    scene = T.compile_scene(w, T.SpectralConfig(*SPECTRAL), device="cpu")
    rec = intersect_scene(scene, torch.tensor([[0.0, 0.0, -2.0]]),
                          torch.tensor([[0.0, 0.0, 1.0]]))
    assert abs(float(rec.t[0]) - 1.75) < 1e-4
    m = wrapped.to_root()
    assert wrapped.n_csg_leaves() == 1
    assert wrapped.csg_program(3) == inner.csg_program(3)
    (tid, l2w, params), = wrapped.csg_leaves(m)
    np.testing.assert_array_equal(l2w.to_array(np.float64),
                                  (m * inner.transform).to_array(np.float64))
    np.testing.assert_allclose(wrapped.bounding_box()[0], [-0.5, -0.5, -0.25],
                               atol=1e-4)
    inst = wrapped.instance()
    assert inst.primitive is inner and inst.material is wrapped.material
    with pytest.raises(ValueError):
        EncapsulatedPrimitive(wrapped)  # already in a scenegraph
    ix = wrapped.hit(Ray(T.Point3D(0, 0, -2), T.Vector3D(0, 0, 1)),
                     device="cpu")
    assert ix.primitive is wrapped and abs(ix.ray_distance - 1.75) < 1e-4


# --- (b) the library ------------------------------------------------------------------

METALS = [n for n in TL.metal.__all__ if n != "metal_nk"]


def _ref_f64(sf, lo, hi, bins):
    """The reference's resampling of an InterpolatedSF in float64."""
    return JI.sample_bins(np.asarray(sf.wavelengths, np.float64),
                          np.asarray(sf.samples, np.float64), lo, hi, bins)


@pytest.mark.parametrize("name", METALS)
def test_metal_spectra_match_reference(name):
    args = (0.2,) if name.startswith("Rough") else ()
    got, ref = getattr(TL, name)(*args), getattr(JL, name)(*args)
    assert type(got).__name__ == type(ref).__name__
    for g, r in ((got.index, ref.index), (got.extinction, ref.extinction)):
        np.testing.assert_array_equal(g.wavelengths, r.wavelengths)
        np.testing.assert_array_equal(g.samples, r.samples)
    for bins in (5, 20):
        rows = got.compile_spectra(375.0, 740.0, bins)
        want = np.stack([_ref_f64(ref.index, 375.0, 740.0, bins),
                         _ref_f64(ref.extinction, 375.0, 740.0, bins)])
        np.testing.assert_allclose(rows[:2], want, rtol=1e-6, atol=1e-6)
        assert not rows[2:].any()  # the material table's unused slots
    np.testing.assert_array_equal(got.compile_params(),
                                  np.asarray(ref.compile_params()))


COLOURS = ["purple", "blue", "light_blue", "cyan", "green", "yellow",
           "orange", "red_orange", "red", "maroon"]


@pytest.mark.parametrize("name", COLOURS + ["BlackBody"])
def test_library_spectra_match_reference(name):
    if name == "BlackBody":
        got, ref = TL.BlackBody(5800.0, 2.0), JL.BlackBody(5800.0, 2.0)
        for bad in ((0.0,), (5800.0, 0.0)):
            with pytest.raises(ValueError):
                TL.BlackBody(*bad)
    else:
        got, ref = getattr(TL, name), getattr(JL, name)
    for lo, hi, bins in ((375.0, 740.0, 15), (400.0, 700.0, 64)):
        want = (np.asarray(ref.sample(lo, hi, bins)) if name == "BlackBody"
                else _ref_f64(ref, lo, hi, bins))
        np.testing.assert_allclose(got.sample(lo, hi, bins), want,
                                   rtol=1e-6, atol=1e-6)


def test_library_exports():
    assert TL.Cobolt is TL.Cobalt and TL.RoughCobolt is TL.RoughCobalt
    assert len(METALS) == 2 * 18 + 2
    assert set(TL.__all__) == set(JL.__all__)
    w, n, k = TL.metal_nk("gold")
    assert len(w) == len(n) == len(k) > 10


# --- (c) the lens demos compiled ------------------------------------------------------


def _jax_cooke():
    w = jax_cornell_world(glass=True)
    jax_cooke(w)
    return w


@pytest.fixture(scope="module")
def demo_pairs():
    """(reference compile, port compile) of both lens demos at B bins."""
    return {
        "cooke": (S.compile_scene(_jax_cooke(), S.SpectralConfig(*SPECTRAL)),
                  T.compile_scene(scenes.cooke_triplet_world()[0],
                                  T.SpectralConfig(*SPECTRAL), device="cpu")),
        "metal": (S.compile_scene(jax_metal_world()[0],
                                  S.SpectralConfig(*SPECTRAL)),
                  T.compile_scene(scenes.metal_lens_world()[0],
                                  T.SpectralConfig(*SPECTRAL), device="cpu")),
    }


def _static(scene, name):
    v = getattr(scene, name)
    if name == "volume_entities":  # drop the material object
        v = tuple(r[:3] + r[4:] for r in v)
    return v


@pytest.mark.parametrize("demo", ["cooke", "metal"])
def test_lens_demo_tables_match_reference(demo_pairs, demo):
    js, ts = demo_pairs[demo]
    for field in ARRAY_FIELDS:
        a, b = np.asarray(getattr(js, field)), getattr(ts, field).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=field)
    for field in STATIC_FIELDS:
        assert _static(js, field) == _static(ts, field), field
    assert js.leaf_bvh is not None and ts.leaf_bvh is not None
    # the port's tables add the item boxes its kernel tests first
    assert js.leaf_bvh.keys() <= ts.leaf_bvh.keys()
    for k, v in js.leaf_bvh.items():
        np.testing.assert_allclose(ts.leaf_bvh[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # every lens body and barrel is one kernel-resolved BVH item
    assert len(ts.kernel_csg_entities) == len(ts.csg_entities) >= 2


# --- (d) an observation of the metal lens demo ----------------------------------------

OBS_SEED = 13


def _metal_camera(O, pkg_world, **kw):
    world, camera, aperture = pkg_world
    rgb = O.RGBPipeline2D()
    ccd = O.TargetedCCDArray(targets=[aperture], parent=camera,
                             pipelines=[rgb], pixels=(8, 8), **kw)
    ccd.pixel_samples = 2
    ccd.spectral_bins = B
    ccd.ray_max_depth = 6
    ccd.max_wavefront_iters = 6
    ccd.tile_size = 32
    ccd.samples_per_task = 2
    ccd.quiet = True
    return ccd, rgb


def _pixels_apart(a, b, rtol=1e-4, atol=1e-6):
    """Pixels apart beyond rtol, and atol of the reference frame's largest
    entry: a CCD's pixels read power, ~1e-7 here, where the observers'
    atol 1e-6 (on radiance of order 1) would pass anything."""
    a = np.asarray(a).reshape(64, -1)
    b = np.asarray(b).reshape(64, -1)
    assert np.isfinite(a).all() and np.abs(b).max() > 0
    return int((~np.isclose(a, b, rtol=rtol,
                            atol=atol * np.abs(b).max()).all(-1)).sum())


def test_metal_lens_observation_matches_reference(demo_pairs, monkeypatch):
    js = demo_pairs["metal"][0]

    def compiled(world, config):
        assert (config.min_wavelength, config.max_wavelength,
                config.bins) == SPECTRAL
        return js

    monkeypatch.setattr(JOB, "compile_scene", compiled)
    jcam, jrgb = _metal_camera(JO, jax_metal_world())
    with env(**REF_ENV):
        jcam.observe(seed=OBS_SEED)
    tcam, trgb = _metal_camera(TO, scenes.metal_lens_world(), device="cpu")
    tcam.observe(seed=OBS_SEED, **ref_streams(OBS_SEED))
    fj, ft = jrgb.xyz_frame, trgb.xyz_frame
    assert (ft.samples == 2).all() and (fj.samples == 2).all()
    assert _pixels_apart(ft.mean, fj.mean) <= 1
    assert _pixels_apart(ft.variance, fj.variance, rtol=1e-3) <= 1
    assert ft.mean.mean() > 0
    assert abs(tcam._stats_rays - jcam._stats_rays) <= jcam._stats_rays / 64
