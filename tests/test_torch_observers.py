"""The port's observers and pipelines against source_tpu's, on the CPU.

The port runs the plain PyTorch versions of its kernels (``device="cpu"``);
inputs are made with numpy from fixed seeds and handed to both packages.
The reference's ``observe()`` is compiled three times in this module, all
module-scoped: once for the two-tile, two-chunk observation and twice for
its two spectral slices with compaction.

  (a) the samplers of core/math/random.py and the camera generators of
      cameras.py on the same uniforms: equal to f32 rounding (rtol 1e-6,
      atol 1e-7; 2e-6 after a transcendental);
  (b) ``resample_ciexyz``, ``spectra_to_ciexyz``, ``ciexyz_to_srgb``,
      ``srgb_to_ciexyz`` and the transfer functions: rtol 1e-5 / atol 1e-7
      (``ciexyz_to_srgb`` atol 1e-6: cancellation near 0, times 12.92);
  (c) each pipeline's ``project`` on the same spectra: rtol 1e-5 / atol
      1e-7; its ``update`` on the same statistics: frame mean, variance and
      ``errors()`` rtol 1e-12 (both fold in float64);
  (d) ``schedule_from_profile`` on given counts: equal; ``alive_profile``
      on the same state and uniforms: equal counts;
  (e) the whole ``observe()`` of the Cornell box without glass (8x8
      pixels, 4 spp, 5 bins, 6 bounces, tiles of 32 pixels, chunks of 2
      samples) with the reference's streams injected, the reference at
      SOURCE_TPU_FUSED=0, SOURCE_TPU_LEAF_BVH=0: the RGB, spectral and
      PixelProcessor frames and the variances per pixel within rtol 1e-4 /
      atol 1e-6 on all but FLIP_SHARE of the pixels (the port's rule of at
      most 0.5 % of lanes flipping a decision, one pixel at these sizes);
      traced segments within the same share. Again with spectral_rays=2
      and compact_schedule=((2, 2),).
  (f) a FibreOptic's rays and a PowerPipeline0D's fold against the
      reference's on the same uniforms and statistics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world as jax_cornell_world
import source_tpu as S
from source_tpu.core.math import random as JR
from source_tpu.optical import colour as JC
from source_tpu.optical import observer as JO
from source_tpu.optical.observer import cameras as JCAM
from source_tpu.tracer import wavefront as JW

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.core.math import random as TR
from source_tpu_torch.optical import colour as TC
from source_tpu_torch.optical import observer as TO
from source_tpu_torch.optical.observer import cameras as TCAM
from source_tpu_torch.optical.observer.base import SCHEDULE_SITE
from source_tpu_torch.tracer import wavefront as TW

from test_torch_common import env, to_jax, uniform_streams

SEED = 20
N_U = 10  # bounce uniforms of the Cornell box (no Roughen)
# pixels allowed to differ in the observe() parity: 0.5 % of the lanes
# flipping a decision, at least one (256 lanes a slice here)
FLIP_SHARE = 1 / 64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def close(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(_n(a), _n(b), rtol=rtol, atol=atol)


# --- (a) samplers and cameras -----------------------------------------------------

RNG = np.random.default_rng(7)
U = RNG.random((6, 512)).astype(np.float32)

_SAMPLERS = {
    "vector_sphere": lambda m, u: m.vector_sphere(u[0], u[1]),
    "vector_hemisphere_uniform":
        lambda m, u: m.vector_hemisphere_uniform(u[0], u[1]),
    "vector_hemisphere_cosine":
        lambda m, u: m.vector_hemisphere_cosine(u[0], u[1]),
    "vector_cone_uniform": lambda m, u: m.vector_cone_uniform(u[0], u[1], 0.8),
    "vector_cone_uniform_per_lane":
        lambda m, u: m.vector_cone_uniform(u[0], u[1], u[2] - 0.5),
    "vector_cone_cosine": lambda m, u: m.vector_cone_cosine(u[0], u[1], 0.6),
    "point_disk": lambda m, u: m.point_disk(u[0], u[1], 0.3),
    "point_square": lambda m, u: m.point_square(u[0], u[1], 2.0),
    "point_rectangle": lambda m, u: m.point_rectangle(u[0], u[1], 2.0, 0.5),
    "point_triangle": lambda m, u: m.point_triangle(
        u[0], u[1], u[2:5].T, u[3:6].T * 2.0, u[np.array([4, 0, 1])].T - 1.0),
    "pdf_hemisphere_uniform":
        lambda m, u: m.pdf_hemisphere_uniform(m.vector_sphere(u[0], u[1])),
    "pdf_hemisphere_cosine":
        lambda m, u: m.pdf_hemisphere_cosine(m.vector_sphere(u[0], u[1])),
    "pdf_cone_uniform":
        lambda m, u: m.pdf_cone_uniform(m.vector_sphere(u[0], u[1]), 0.7),
}


@pytest.mark.parametrize("name", list(_SAMPLERS))
def test_sampler_matches_jax(name):
    ref = _SAMPLERS[name](JR, jnp.asarray(U))
    got = _SAMPLERS[name](TR, _t(U))
    close(got, ref, rtol=2e-6, atol=2e-7)


def test_random_draws_take_a_generator():
    g = torch.Generator().manual_seed(3)
    a = TR.uniform(g, (4, 5))
    g.manual_seed(3)
    assert torch.equal(a, TR.uniform(g, (4, 5)))
    assert a.dtype == torch.float32 and ((a >= 0) & (a < 1)).all()
    assert TR.probability(g, 1.0, (8,)).all()
    assert TR.normal(g, 2.0, 0.0, (3,)).eq(2.0).all()


PX = RNG.integers(0, 48, (64, 1))
PY = RNG.integers(0, 32, (64, 1))
UC = RNG.random((64, 3, 4)).astype(np.float32)

_CAMERAS = {
    "pinhole": lambda m, px, py, u: m.pinhole_rays(
        px, py, u[..., 0], u[..., 1], 48, 32, 45.0),
    "pinhole_wide": lambda m, px, py, u: m.pinhole_rays(
        px, py, u[..., 0], u[..., 1], 48, 32, 120.0),
    "orthographic": lambda m, px, py, u: m.orthographic_rays(
        px, py, u[..., 0], u[..., 1], 48, 32, 2.0),
    "ccd": lambda m, px, py, u: m.ccd_rays(px, py, u, 48, 32, 0.035),
}


@pytest.mark.parametrize("name", list(_CAMERAS))
def test_camera_rays_match_jax(name):
    ref = _CAMERAS[name](JCAM, jnp.asarray(PX), jnp.asarray(PY), jnp.asarray(UC))
    got = _CAMERAS[name](TCAM, _t(PX), _t(PY), _t(UC))
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape
        close(g, r, rtol=2e-6, atol=2e-7)
    assert TCAM.pinhole_geometry(48, 32, 45.0) == JCAM.pinhole_geometry(48, 32, 45.0)


def test_vector_camera_rays_match_jax():
    rng = np.random.default_rng(12)
    o = rng.random((48, 32, 3)).astype(np.float32)
    d = rng.random((48, 32, 3)).astype(np.float32)
    ref = JCAM.vector_camera_rays(jnp.asarray(PX[:, 0]), jnp.asarray(PY[:, 0]),
                                  jnp.asarray(o), jnp.asarray(d))
    got = TCAM.vector_camera_rays(_t(PX[:, 0]), _t(PY[:, 0]), _t(o), _t(d))
    for r, g in zip(ref, got):
        close(g, r, rtol=0, atol=0)


# --- (b) colour -----------------------------------------------------------------


@pytest.mark.parametrize("grid", [(375.0, 740.0, 15), (400.0, 700.0, 4),
                                  (375.0, 740.0, 1)])
def test_resample_ciexyz_matches_jax(grid):
    close(TC.resample_ciexyz(*grid), JC.resample_ciexyz(*grid),
          rtol=1e-5, atol=1e-7)
    for t, j in ((TC.ciexyz_x, JC.ciexyz_x), (TC.ciexyz_y, JC.ciexyz_y),
                 (TC.ciexyz_z, JC.ciexyz_z)):
        close(t.sample(*grid), j.sample(*grid), rtol=1e-5, atol=1e-7)


def test_colour_conversions_match_jax():
    rng = np.random.default_rng(11)
    xyz = rng.uniform(0.0, 1.5, (2000, 3)).astype(np.float32)
    # a linear sRGB value near 0 is a three-term f32 sum that cancels, and
    # the transfer's slope there is 12.92: atol 1e-6 for the encoded value
    close(TC.ciexyz_to_srgb(xyz), JC.ciexyz_to_srgb(jnp.asarray(xyz)),
          rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    close(TC.srgb_to_ciexyz(rgb), JC.srgb_to_ciexyz(jnp.asarray(rgb)),
          rtol=1e-5, atol=1e-7)
    v = np.concatenate([np.linspace(0.0, 1.0, 300), [0.0031308, 0.04045]]
                       ).astype(np.float32)
    close(TC.srgb_transfer_function(v),
          JC.srgb_transfer_function(jnp.asarray(v)), rtol=1e-5, atol=1e-7)
    close(TC.srgb_transfer_function_inverse(v),
          JC.srgb_transfer_function_inverse(jnp.asarray(v)), rtol=1e-5,
          atol=1e-7)
    assert np.allclose(TC.ciexyz_to_srgb(0.3, 0.4, 0.2),
                       JC.ciexyz_to_srgb(0.3, 0.4, 0.2), rtol=1e-5)
    assert np.allclose(TC.ciexyy_to_ciexyz(0.3, 0.4, 0.5),
                       JC.ciexyy_to_ciexyz(0.3, 0.4, 0.5))
    assert np.allclose(TC.ciexyz_to_ciexyy(0.3, 0.4, 0.5),
                       JC.ciexyz_to_ciexyy(0.3, 0.4, 0.5))
    spectra = rng.uniform(0.0, 2.0, (7, 15)).astype(np.float32)
    close(TC.spectra_to_ciexyz(spectra, TC.resample_ciexyz(375.0, 740.0, 15),
                               24.333),
          JC.spectra_to_ciexyz(jnp.asarray(spectra),
                               JC.resample_ciexyz(375.0, 740.0, 15), 24.333),
          rtol=1e-5, atol=1e-7)


# --- (c) pipelines -----------------------------------------------------------------

_FILTERS = (S.optical.InterpolatedSF([375, 740], [1.0, 0.2]),
            S.optical.ConstantSF(0.5),
            S.optical.InterpolatedSF([375, 740], [0.1, 0.9]))


def _port_sf(sf):
    if isinstance(sf, S.optical.ConstantSF):
        return T.optical.ConstantSF(sf.value)
    return T.optical.InterpolatedSF(np.asarray(sf.wavelengths),
                                    np.asarray(sf.samples))


_PIPES = {
    "RGBPipeline2D": ((6, 4), lambda m: m.RGBPipeline2D()),
    "BayerPipeline2D": ((6, 4), lambda m: m.BayerPipeline2D(
        *(f if m is JO else _port_sf(f) for f in _FILTERS))),
    "PowerPipeline0D": ((), lambda m: m.PowerPipeline0D()),
    "PowerPipeline1D": ((24,), lambda m: m.PowerPipeline1D()),
    "PowerPipeline2D": ((6, 4), lambda m: m.PowerPipeline2D(
        filter=_FILTERS[0] if m is JO else _port_sf(_FILTERS[0]))),
    "RadiancePipeline0D": ((), lambda m: m.RadiancePipeline0D()),
    "RadiancePipeline2D": ((6, 4), lambda m: m.RadiancePipeline2D()),
    "SpectralPowerPipeline0D": ((), lambda m: m.SpectralPowerPipeline0D()),
    "SpectralPowerPipeline2D": ((6, 4), lambda m: m.SpectralPowerPipeline2D()),
    "SpectralRadiancePipeline1D":
        ((24,), lambda m: m.SpectralRadiancePipeline1D()),
}


def _frame(pipe):
    return pipe.xyz_frame if hasattr(pipe, "xyz_frame") else pipe.frame


@pytest.mark.parametrize("name", list(_PIPES))
def test_pipeline_project_and_update_match_jax(name):
    shape, make = _PIPES[name]
    rng = np.random.default_rng(len(name))
    bins, T_ = 9, 8
    slices_j = JO.base._slice_spectrum(375.0, 740.0, bins, 2)
    slices_t = TO.base._slice_spectrum(375.0, 740.0, bins, 2)
    pj, pt = make(JO), make(TO)
    cfg_j = S.SpectralConfig(375.0, 740.0, bins)
    cfg_t = T.SpectralConfig(375.0, 740.0, bins)
    pj.initialise(shape, cfg_j, slices_j, quiet=True)
    pt.initialise(shape, cfg_t, slices_t, quiet=True)
    n_pix = int(np.prod(shape)) if shape else 1
    px = rng.integers(0, shape[0] if shape else 1, T_)
    py = rng.integers(0, shape[1] if len(shape) > 1 else 1, T_)
    sens = rng.uniform(0.5, 2.0, T_).astype(np.float32)
    total_j = total_t = 0.0
    for sj, st in zip(slices_j, slices_t):
        spectra = rng.uniform(0.0, 3.0, (T_, 5, sj.bins)).astype(np.float32)
        cj = pj.projection_constants(sj)
        ct = pt.projection_constants(st)
        ref = pj.project(jnp.asarray(spectra), cj, jnp.asarray(sens),
                         jnp.asarray(px), jnp.asarray(py))
        got = pt.project(_t(spectra), ct, _t(sens), _t(px), _t(py))
        close(got, ref, rtol=1e-5, atol=1e-7)
        total_j = total_j + np.asarray(ref)
        total_t = total_t + got.numpy()
    # fold two batches of statistics, the second onto the first
    for k in range(2):
        ids = rng.permutation(n_pix)[:min(T_, n_pix)] if shape else np.zeros(1, np.int64)
        C = total_j.shape[-1]
        mean = rng.uniform(0.0, 2.0, (len(ids), C))
        m2 = rng.uniform(0.0, 1.0, (len(ids), C))
        n = np.full(len(ids), 4 + k, np.int64)
        pj.update(ids, mean, m2, n)
        pt.update(ids, mean, m2, n)
    fj, ft = _frame(pj), _frame(pt)
    for f in ("mean", "variance", "samples"):
        np.testing.assert_allclose(np.asarray(getattr(ft, f)),
                                   np.asarray(getattr(fj, f)), rtol=1e-12)
    if hasattr(fj, "errors"):
        np.testing.assert_allclose(ft.errors(), fj.errors(), rtol=1e-12)
    else:
        assert ft.error() == pytest.approx(fj.error(), rel=1e-12)


# --- the suite's worlds ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "prism", "csg", "mis", "mesh"])
def test_suite_worlds_match_the_demos(name):
    """The port's copies of the suite's worlds compile to the tables of the
    demos' ``build_world`` (3 bins: the JAX compile resamples dispersive
    glasses eagerly): every table within rtol 1e-5 / atol 1e-6, the static
    structure and each mesh's geometry equal."""
    from demos import (cornell_box, csg, mesh_render, prism,
                       multiple_importance_sampling as mis)
    from source_tpu_torch.bridge import ARRAY_FIELDS
    make = {"cornell": (lambda: cornell_box.build_world(glass=False),
                        lambda: scenes.cornell_box(glass=False)),
            "prism": (prism.build_world, scenes.prism_world),
            "csg": (csg.build_world, scenes.csg_world),
            "mis": (mis.build_world, scenes.mis_world),
            "mesh": (lambda: mesh_render.build_world(small=True),
                     lambda: scenes.mesh_world(small=True))}[name]
    js = S.compile_scene(make[0](), S.SpectralConfig(375.0, 740.0, 3))
    ts = T.compile_scene(make[1](), T.SpectralConfig(375.0, 740.0, 3),
                         device="cpu")
    for k in ARRAY_FIELDS:
        close(getattr(ts, k), getattr(js, k), rtol=1e-5, atol=1e-6)
    for k in ("n_leaves", "n_entities", "mat_types", "type_slices",
              "csg_entities", "mesh_entities"):
        assert getattr(ts, k) == getattr(js, k), k
    assert len(ts.meshes) == len(js.meshes)
    for tm, jm in zip(ts.meshes, js.meshes):
        close(tm.vertices, jm.vertices, rtol=0, atol=0)


# --- (d) the compaction schedule -----------------------------------------------------


@pytest.mark.parametrize("counts,n", [
    ([256, 200, 120, 60, 30, 12, 6, 2], 256),
    ([1000] * 8, 1000),
    ([4096, 4000, 900, 500, 200, 100, 90, 20, 10, 3, 1, 0, 0, 0], 4096),
    ([64, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], 64),
])
def test_schedule_from_profile_matches_jax(counts, n):
    for kw in ({}, dict(headroom=2, max_divisor=4, min_stage_steps=1)):
        assert (TW.schedule_from_profile(counts, n, **kw)
                == JW.schedule_from_profile(counts, n, **kw))


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box without glass, 5 bins: the port's compile, and the
    same tables as the reference's scene."""
    ts = T.compile_scene(scenes.cornell_box(glass=False),
                         T.SpectralConfig(375.0, 740.0, 5), device="cpu")
    return ts, to_jax(ts)


def test_alive_profile_matches_jax(cornell):
    ts, js = cornell
    rng = np.random.default_rng(2)
    n = 256
    o = np.tile(np.array([[0.0, 0.0, -3.3]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)) * [0.3, 0.3, 0.0] + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cfg = dict(max_depth=5, extinction_prob=0.2, extinction_min_depth=1,
               max_iters=7)
    key = jax.random.PRNGKey(4)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        ref = np.asarray(jax.jit(JW.alive_profile, static_argnums=1)(
            js, JW.RayConfig(**cfg), JW.init_rays(jnp.asarray(o),
                                                  jnp.asarray(d), 5), key))

    def u_all(start, n_steps, n_lanes):
        return _t(np.array(jax.random.uniform(
            jax.random.fold_in(key, start), (n_lanes, N_U))))[None]

    got = TW.alive_profile(ts, T.RayConfig(**cfg),
                           T.init_rays(_t(o), _t(d), 5), u_all=u_all)
    assert got.dtype == torch.int32 and got.shape == (7,)
    assert got.tolist() == ref.tolist()
    assert ref[0] == n and ref[-1] < n


# --- (e) observe() -------------------------------------------------------------------


def ref_streams(seed):
    """The reference observe()'s streams as the port's injected callables:
    camera uniforms uniform(fold_in(fold_in(PRNGKey(seed), tile), chunk *
    8191 + slice)), the trace's under fold_in(that, 7), and the "auto"
    schedule's under fold_in(PRNGKey(seed), 0x5EED)."""
    key = jax.random.PRNGKey(seed)

    def site_key(site):
        if site == SCHEDULE_SITE:
            return jax.random.fold_in(key, 0x5EED)
        tile, chunk, slice_ = site
        return jax.random.fold_in(jax.random.fold_in(key, tile),
                                  chunk * 8191 + slice_)

    def camera_u(site, shape):
        return _t(np.array(jax.random.uniform(site_key(site), shape)))

    def u_all(site, start, n_steps, n_lanes):
        if site == SCHEDULE_SITE:
            return _t(np.array(jax.random.uniform(
                jax.random.fold_in(site_key(site), start), (n_lanes, N_U))))[None]
        return uniform_streams(jax.random.fold_in(site_key(site), 7), N_U)[0](
            start, n_steps, n_lanes)

    def shifts(site, done, alive):
        return uniform_streams(jax.random.fold_in(site_key(site), 7), N_U)[1](
            done, alive)

    return dict(camera_u=camera_u, u_all=u_all, shifts=shifts)


class _SumProcessor:
    """PixelProcessor of both packages (the observers call only
    ``add_samples`` and ``pack_results``): the samples' integrated power."""

    def __init__(self):
        self.total = 0.0
        self.n = 0

    def add_samples(self, min_wavelength, max_wavelength, bins, samples,
                    sensitivity):
        delta = (max_wavelength - min_wavelength) / bins
        self.total += float(samples.sum()) * delta * sensitivity
        self.n += samples.shape[0]

    def pack_results(self):
        return self.total, self.n


def _processor_pipeline(base):
    class CustomPower2D(base):
        name = "CustomPower2D"

        def initialise(self, shape, spectral_config, slices, quiet=False):
            self.frame = np.zeros(int(np.prod(shape)))

        def pixel_processor(self, pixel_id, slice_id):
            return _SumProcessor()

        def update(self, pixel_id, packed, slice_id):
            self.frame[pixel_id] += packed[0]
    return CustomPower2D()


def _configure(cam, spectral_rays, schedule):
    cam.pixel_samples = 4
    cam.spectral_bins = 5
    cam.spectral_rays = spectral_rays
    cam.max_wavefront_iters = 6
    cam.tile_size = 32
    cam.samples_per_task = 2
    cam.compact_schedule = schedule
    cam.quiet = True


_RUNS = {"rgb_spectral": (1, ()), "slices_compaction": (2, ((2, 2),))}


@pytest.fixture(scope="module", params=list(_RUNS))
def observed(request):
    spectral_rays, schedule = _RUNS[request.param]
    out = {}
    jw = jax_cornell_world(glass=False)
    jpipes = [JO.RGBPipeline2D(), JO.SpectralRadiancePipeline2D(),
              _processor_pipeline(JO.Pipeline2D)]
    jcam = JO.PinholeCamera((8, 8), fov=45, parent=jw, pipelines=jpipes,
                            transform=S.translate(0, 0, -3.3))
    _configure(jcam, spectral_rays, schedule)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        jcam.observe(seed=SEED)
    tw = scenes.cornell_box(glass=False)
    tpipes = [TO.RGBPipeline2D(), TO.SpectralRadiancePipeline2D(),
              _processor_pipeline(TO.Pipeline2D)]
    tcam = TO.PinholeCamera((8, 8), fov=45, parent=tw, pipelines=tpipes,
                            transform=T.translate(0, 0, -3.3), device="cpu")
    _configure(tcam, spectral_rays, schedule)
    tcam.observe(seed=SEED, **ref_streams(SEED))
    out.update(jcam=jcam, tcam=tcam, jpipes=jpipes, tpipes=tpipes)
    return out


def _pixels_apart(a, b, rtol=1e-4, atol=1e-6):
    a = np.asarray(a).reshape(64, -1)
    b = np.asarray(b).reshape(64, -1)
    assert np.isfinite(a).all()
    return int((~np.isclose(a, b, rtol=rtol, atol=atol).all(-1)).sum())


@pytest.mark.parametrize("frame", ["rgb", "spectral", "processor"])
def test_observe_frames_match_jax(observed, frame):
    i = ["rgb", "spectral", "processor"].index(frame)
    jp, tp = observed["jpipes"][i], observed["tpipes"][i]
    if frame == "processor":
        assert _pixels_apart(tp.frame, jp.frame) <= FLIP_SHARE * 64
        return
    fj, ft = _frame(jp), _frame(tp)
    assert (ft.samples == 4).all() and (fj.samples == 4).all()
    assert _pixels_apart(ft.mean, fj.mean) <= FLIP_SHARE * 64
    assert _pixels_apart(ft.variance, fj.variance, rtol=1e-3) <= FLIP_SHARE * 64
    assert _pixels_apart(ft.errors(), fj.errors(), rtol=1e-3) <= FLIP_SHARE * 64
    assert ft.mean.mean() > 0


def test_observe_segments_match_jax(observed):
    jcam, tcam = observed["jcam"], observed["tcam"]
    assert abs(tcam._stats_rays - jcam._stats_rays) <= FLIP_SHARE * jcam._stats_rays
    assert tcam.compaction_overflow == jcam.compaction_overflow
    assert tcam.rays_per_second > 0 and tcam.render_time > 0


# --- (f) a 0D observer -------------------------------------------------------------------


def test_fibre_optic_rays_and_power_fold_match_jax():
    jf = JO.FibreOptic(acceptance_angle=10.0, radius=0.002)
    tf = TO.FibreOptic(acceptance_angle=10.0, radius=0.002, device="cpu")
    u = np.random.default_rng(13).random((8, 6, 4)).astype(np.float32)
    z = np.zeros((8, 1), np.int64)
    ref = jf._generate_rays_device(jnp.asarray(z), jnp.asarray(z), jnp.asarray(u))
    got = tf._generate_rays_device(_t(z), _t(z), _t(u))
    for r, g in zip(ref, got):
        close(g, r, rtol=2e-6, atol=2e-7)
    np.testing.assert_array_equal(tf._pixel_sensitivity_array(),
                                  jf._pixel_sensitivity_array())
    pj, pt = JO.PowerPipeline0D(), TO.PowerPipeline0D()
    pj.initialise((), None, [], True)
    pt.initialise((), None, [], True)
    for k in range(3):
        mean = np.array([[0.5 + k]])
        m2 = np.array([[0.25 * k]])
        n = np.array([16 + k])
        pj.update(np.zeros(1, np.int64), mean, m2, n)
        pt.update(np.zeros(1, np.int64), mean, m2, n)
    assert pt.value.mean == pytest.approx(pj.value.mean, rel=1e-14)
    assert pt.value.variance == pytest.approx(pj.value.variance, rel=1e-14)
    assert pt.value.samples == pj.value.samples
    assert pt.value.error() == pytest.approx(pj.value.error(), rel=1e-14)
