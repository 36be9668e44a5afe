"""The port's observers, pipelines and samplers on their own (no JAX), on
the CPU (``device="cpu"``: the plain PyTorch versions of the kernels).

The checks of the reference's test_render_e2e (the observing-sphere
furnace, the Lambert single-bounce energy, the Cornell render, the
adaptive sampler), test_observers2, test_nonimaging, test_samplers (on the
samplers and pdfs of core/math/random.py), test_sample_chunking and
test_pixel_processor, at their sizes or smaller, with their tolerances;
and the package's own: Welford statistics, checkpoints, the PNG writer,
the engines, the suite's worlds, and that the observer package loads no
JAX.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.core.math import random as R
from source_tpu_torch.core.math import statsarray as SA
from source_tpu_torch.core.scenegraph import World
from source_tpu_torch.optical import ConstantSF
from source_tpu_torch.optical.material import (
    Lambert, UniformSurfaceEmitter, UnitySurfaceEmitter,
)
from source_tpu_torch.optical import observer as O
from source_tpu_torch.primitive import Box, MeshData, Sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DLAM = 740.0 - 375.0  # the spectral range a unity emitter integrates to


def _furnace(observer, radius=10.0):
    """``observer`` inside a unity emitter: every ray ends at its first hit,
    so a few bounces of the loop are enough."""
    w = World()
    Sphere(radius=radius, parent=w, material=UnitySurfaceEmitter())
    observer.parent = w
    observer.quiet = True
    observer.ray_extinction_prob = 0.0
    observer.max_wavefront_iters = 4
    return w


# --- test_render_e2e ---------------------------------------------------------------


class _ObservingSphere(O.Observer0D):
    """0D observer launching rays isotropically (demos/accuracy pattern)."""

    _rays_per_sample = 2

    def _generate_rays_device(self, px, py, u):
        d = R.vector_sphere(u[..., 0], u[..., 1])
        return torch.zeros_like(d), d, torch.ones(d.shape[:-1])


def test_observing_sphere_unity_emitter():
    """An observer inside a unity-emitting sphere measures exactly 1
    W/m2/str/nm in every bin."""
    world = World()
    Sphere(5.0, parent=world, material=UnitySurfaceEmitter())
    radiance = O.RadiancePipeline0D()
    spectral = O.SpectralRadiancePipeline0D()
    obs = _ObservingSphere(parent=world, pipelines=[radiance, spectral],
                           device="cpu")
    obs.pixel_samples = 256
    obs.spectral_bins = 8
    obs.max_wavefront_iters = 4  # every ray ends at its first hit
    obs.quiet = True
    obs.observe(seed=42)
    expected = obs.max_wavelength - obs.min_wavelength
    assert radiance.value.mean == pytest.approx(expected, rel=1e-5)
    np.testing.assert_allclose(spectral.frame.mean, 1.0, atol=1e-5)


def test_lambert_single_bounce_energy():
    """A Lambert floor under a uniform emitting sky: L_out = rho * L_in."""
    world = World()
    Sphere(100.0, parent=world, material=UniformSurfaceEmitter(ConstantSF(2.0)))
    Box(T.Point3D(-50, -0.1, -50), T.Point3D(50, 0, 50), parent=world,
        material=Lambert(ConstantSF(0.5)), name="floor")
    pipe = O.PowerPipeline2D(name="power")
    cam = O.PinholeCamera((8, 8), fov=40, parent=world,
                          transform=T.translate(0, 3, 0) * T.rotate(0, -90, 0),
                          pipelines=[pipe], device="cpu")
    cam.pixel_samples = 512
    cam.spectral_bins = 4
    cam.ray_extinction_prob = 0.0
    cam.ray_max_depth = 8
    cam.ray_importance_sampling = False
    cam.max_wavefront_iters = 8
    cam.quiet = True
    cam.observe(seed=7)
    expected = 0.5 * 2.0 * DLAM
    vals = pipe.frame.mean
    assert vals.min() > expected * 0.85
    assert vals.max() < expected * 1.05
    assert vals[4, 4] == pytest.approx(expected, rel=0.05)


def test_cornell_box_render_smoke(tmp_path):
    """Wall colours land on the right sides, frames accumulate across
    passes, and the PNG is written."""
    rgb = O.RGBPipeline2D(name="rgb")
    cam = O.PinholeCamera((16, 16), parent=scenes.cornell_box(glass=False),
                          transform=T.translate(0, 0, -3.3), pipelines=[rgb],
                          device="cpu")
    cam.pixel_samples = 16
    cam.spectral_bins = 12
    cam.max_wavefront_iters = 16
    cam.quiet = True
    cam.observe(seed=3)
    xyz = rgb.xyz_frame.mean
    assert np.isfinite(xyz).all() and xyz.min() >= 0 and xyz.mean() > 0
    first = rgb.xyz_frame.samples.copy()
    cam.observe(seed=4)
    assert (rgb.xyz_frame.samples == 2 * first).all()
    img = rgb.rgb_image()
    left = img[0, 4:12].mean(axis=0)
    right = img[-1, 4:12].mean(axis=0)
    assert left[0] > left[1] * 1.5  # the red wall
    assert right[1] > right[0] * 0.8  # the green wall
    rgb.save(tmp_path / "cornell.png")
    data = (tmp_path / "cornell.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100


@pytest.mark.parametrize("kind", ["rgb", "mono"])
def test_adaptive_sampler_converges(kind):
    """In a zero-variance furnace the adaptive sampler stops issuing tasks
    once min_samples are met: render_complete (test_observers2 and
    test_render_e2e)."""
    if kind == "rgb":
        pipe = O.RGBPipeline2D()
        sampler = O.RGBAdaptiveSampler2D(pipe, min_samples=32, cutoff=0.1,
                                         fraction=0.5)
        cam = O.PinholeCamera((8, 8), pipelines=[pipe], frame_sampler=sampler,
                              device="cpu")
    else:
        pipe = O.PowerPipeline2D(accumulate=True)
        sampler = O.MonoAdaptiveSampler2D(pipe, fraction=0.2, ratio=10.0,
                                          min_samples=32, cutoff=0.01)
        cam = O.OrthographicCamera(pixels=(8, 8), width=1.0, pipelines=[pipe],
                                   frame_sampler=sampler, device="cpu")
    _furnace(cam)
    cam.pixel_samples = 16 if kind == "mono" else 64
    cam.spectral_bins = 4
    passes = 0
    while not cam.render_complete and passes < 10:
        cam.observe(seed=passes)
        passes += 1
    assert cam.render_complete
    frame = pipe.xyz_frame if kind == "rgb" else pipe.frame
    assert frame.samples.min() >= 32
    if kind == "mono":  # unit weights: no noise at all
        assert np.allclose(frame.variance, 0.0, atol=1e-12)


# --- test_observers2 ---------------------------------------------------------------


def test_spectral_rays_slicing_consistent():
    """spectral_rays > 1 traces slices whose zero-filled projections sum to
    the full spectrum."""
    p1 = O.SpectralRadiancePipeline0D(accumulate=False)
    s1 = O.SightLine(pipelines=[p1], device="cpu")
    _furnace(s1)
    s1.pixel_samples = 8
    s1.spectral_bins = 12
    s1.spectral_rays = 3
    s1.observe(seed=1)
    assert p1.frame.mean.shape == (12,)
    assert np.allclose(p1.frame.mean, 1.0, atol=1e-5)


def test_accumulation_reduces_error():
    pipe = O.PowerPipeline2D(accumulate=True)
    cam = O.OrthographicCamera(pixels=(4, 4), width=1.0, pipelines=[pipe],
                               device="cpu")
    _furnace(cam)
    cam.ray_extinction_prob = 0.1  # roulette adds variance
    cam.pixel_samples = 8
    cam.observe(seed=1)
    n1 = pipe.frame.samples.copy()
    e1 = pipe.frame.errors().mean()
    cam.observe(seed=2)
    assert (pipe.frame.samples == 2 * n1).all()
    assert pipe.frame.errors().mean() <= e1 * 1.5


def test_observe_needs_a_world_and_a_card():
    cam = O.PinholeCamera((4, 4), device="cpu")
    with pytest.raises(RuntimeError, match="World"):
        cam.observe()
    if not torch.cuda.is_available():
        cam = O.PinholeCamera((4, 4))  # device="cuda", the default
        _furnace(cam)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cam.observe(seed=1)


def test_validated_properties():
    cam = O.PinholeCamera((4, 4), device="cpu")
    for attr, bad in (("spectral_bins", 0), ("spectral_rays", 99),
                      ("min_wavelength", -1), ("max_wavelength", 1.0),
                      ("ray_extinction_prob", 2.0), ("ray_max_depth", -1),
                      ("ray_important_path_weight", 1.5), ("fov", 180.0),
                      ("sensitivity", 0.0)):
        with pytest.raises(ValueError):
            setattr(cam, attr, bad)


def test_zero_d_observer_pads_to_eight_tasks():
    """A 0D observer's one task is traced in a tile of 8, not tile_size."""
    pipe = O.PowerPipeline0D()
    pix = O.Pixel(pipelines=[pipe], device="cpu")
    _furnace(pix)
    pix.pixel_samples = 3
    pix.max_wavefront_iters = 2
    pix.observe(seed=1)
    assert pipe.value.samples == 3
    # 8 padded tasks x 3 samples, one segment each before the emitter ends them
    assert pix._stats_rays == 8 * 3


# --- test_nonimaging ---------------------------------------------------------------


def test_pixel_power_closed_form():
    pipe = O.PowerPipeline0D(accumulate=False)
    pix = O.Pixel(x_width=0.01, y_width=0.01, pipelines=[pipe], device="cpu")
    _furnace(pix)
    pix.pixel_samples = 200
    pix.observe(seed=1)
    expected = 1e-4 * np.pi * DLAM
    assert abs(pipe.value.mean - expected) / expected < 1e-3


def test_sightline_radiance():
    pipe = O.RadiancePipeline0D(accumulate=False)
    sl = O.SightLine(pipelines=[pipe], device="cpu")
    _furnace(sl)
    sl.pixel_samples = 16
    sl.observe(seed=1)
    assert abs(pipe.value.mean - DLAM) / DLAM < 1e-5


def test_fibreoptic_power_closed_form():
    pipe = O.PowerPipeline0D(accumulate=False)
    fo = O.FibreOptic(acceptance_angle=10.0, radius=0.001, pipelines=[pipe],
                      device="cpu")
    _furnace(fo)
    fo.pixel_samples = 1000
    fo.observe(seed=2)
    area = np.pi * 0.001 ** 2
    expected = area * np.pi * np.sin(np.deg2rad(10.0)) ** 2 * DLAM
    assert abs(pipe.value.mean - expected) / expected < 5e-3


def test_targeted_pixel_unbiased_in_furnace():
    w = World()
    Sphere(radius=10.0, parent=w, material=UnitySurfaceEmitter())
    target = Sphere(radius=0.5, parent=w, material=UnitySurfaceEmitter(),
                    transform=T.translate(0.0, 0.0, 3.0))
    pipe = O.PowerPipeline0D(accumulate=False)
    tp = O.TargetedPixel(target, targeted_path_prob=0.5, pipelines=[pipe],
                         parent=w, device="cpu")
    tp.quiet = True
    tp.pixel_samples = 8000
    tp.ray_extinction_prob = 0.0
    tp.max_wavefront_iters = 4
    tp.observe(seed=3)
    expected = 1e-4 * np.pi * DLAM
    assert abs(pipe.value.mean - expected) / expected < 0.05


def _cube_mesh_data():
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                 np.float32) * 0.05
    t = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [2, 3, 7], [2, 7, 6], [0, 4, 7], [0, 7, 3],
                  [1, 2, 6], [1, 6, 5]], np.int32)
    return MeshData(v, t, smoothing=False, closed=True)


def test_mesh_pixel_power():
    pipe = O.PowerPipeline0D(accumulate=False)
    mp = O.MeshPixel(_cube_mesh_data(), pipelines=[pipe], device="cpu")
    _furnace(mp)
    mp.pixel_samples = 1000
    mp.observe(seed=4)
    expected = 6 * 0.1 ** 2 * np.pi * DLAM
    assert abs(pipe.value.mean - expected) / expected < 5e-3


def test_mesh_camera_per_triangle():
    pipe = O.PowerPipeline1D(accumulate=False)
    mc = O.MeshCamera(_cube_mesh_data(), pipelines=[pipe], device="cpu")
    _furnace(mc)
    mc.pixel_samples = 100
    mc.observe(seed=5)
    expected = 0.5 * 0.1 ** 2 * np.pi * DLAM
    assert pipe.frame.mean.shape == (12,)
    assert np.allclose(pipe.frame.mean, expected, rtol=1e-3)


def test_opencv_camera_renders():
    pipe = O.PowerPipeline2D(accumulate=False)
    cm = [[100.0, 0.0, 8.0], [0.0, 100.0, 8.0], [0.0, 0.0, 1.0]]
    cam = O.OpenCVCamera(cm, [0.05, 0.01, 0.0, 0.0, 0.0], pixels=(16, 16),
                         pipelines=[pipe], device="cpu")
    _furnace(cam)
    cam.pixel_samples = 8
    cam.observe(seed=6)
    assert np.isfinite(pipe.frame.mean).all() and (pipe.frame.mean > 0).all()


def test_targeted_ccd_renders():
    w = World()
    Sphere(radius=10.0, parent=w, material=UnitySurfaceEmitter())
    target = Sphere(radius=0.5, parent=w, material=UnitySurfaceEmitter())
    pipe = O.PowerPipeline2D(accumulate=False)
    cam = O.TargetedCCDArray([target], pixels=(8, 8), width=0.035,
                             pipelines=[pipe], parent=w, device="cpu")
    cam.quiet = True
    cam.pixel_samples = 64
    cam.ray_extinction_prob = 0.0
    cam.max_wavefront_iters = 4
    cam.observe(seed=7)
    vals = pipe.frame.mean
    assert np.isfinite(vals).all() and (vals > 0).all()
    expected = np.pi * (0.035 / 8) ** 2 * DLAM
    assert abs(vals.mean() - expected) / expected < 0.05


def test_ccd_array_power():
    pipe = O.PowerPipeline2D(accumulate=False)
    cam = O.CCDArray(pixels=(4, 3), width=0.01, pipelines=[pipe],
                     device="cpu")
    _furnace(cam)
    cam.pixel_samples = 4
    cam.observe(seed=8)
    expected = np.pi * (0.01 / 4) ** 2 * DLAM
    np.testing.assert_allclose(pipe.frame.mean, expected, rtol=1e-5)


def test_vector_camera_furnace():
    """Per-pixel calibrated rays broadcast over the sample axis."""
    nx, ny = 4, 3
    dirs = np.tile(np.array([0.0, 0.0, 1.0]), (nx, ny, 1))
    pipe = O.RadiancePipeline2D(accumulate=False)
    cam = O.VectorCamera(np.zeros((nx, ny, 3)), dirs, pipelines=[pipe],
                         device="cpu")
    _furnace(cam)
    cam.pixel_samples = 5
    cam.observe(seed=7)
    assert pipe.frame.mean.shape == (nx, ny)
    assert np.allclose(pipe.frame.mean, DLAM, rtol=1e-4)


def test_bayer_pipeline_mosaic():
    """RGGB: (even, even) reads the red filter, (odd, odd) the blue, the
    rest the green (unit-weight orthographic rays in a unity furnace)."""
    filters = (ConstantSF(1.0), ConstantSF(0.5), ConstantSF(0.25))
    pipe = O.BayerPipeline2D(*filters, accumulate=False)
    cam = O.OrthographicCamera((4, 4), pipelines=[pipe], device="cpu")
    _furnace(cam)
    cam.pixel_samples = 2
    cam.observe(seed=1)
    px, py = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    want = np.where((px % 2 == 0) & (py % 2 == 0), 1.0,
                    np.where((px % 2 == 1) & (py % 2 == 1), 0.25, 0.5))
    np.testing.assert_allclose(pipe.frame.mean, want * DLAM, rtol=1e-5)


# --- test_sample_chunking ------------------------------------------------------------


def _chunked(pixel_samples, samples_per_task):
    power = O.PowerPipeline0D()
    spec = O.SpectralRadiancePipeline0D()
    fibre = O.FibreOptic(acceptance_angle=10.0, radius=0.001,
                         pipelines=[power, spec], device="cpu")
    _furnace(fibre)
    fibre.ray_extinction_prob = 0.01
    fibre.pixel_samples = pixel_samples
    fibre.samples_per_task = samples_per_task
    fibre.spectral_bins = 4
    fibre.observe(seed=11)
    return power, spec


def test_chunked_matches_unity_radiator():
    power, spec = _chunked(pixel_samples=1000, samples_per_task=128)
    assert power.value.samples == 1000
    expected = 0.5 * (1.0 + np.cos(np.radians(10.0)))  # E[cos] over the cone
    np.testing.assert_allclose(spec.frame.mean, expected, rtol=2e-3)
    assert power.value.mean > 0.0


def test_chunked_equals_unchunked_statistics():
    p1, s1 = _chunked(pixel_samples=600, samples_per_task=600)
    p2, s2 = _chunked(pixel_samples=600, samples_per_task=100)
    assert p1.value.samples == p2.value.samples == 600
    np.testing.assert_allclose(p1.value.mean, p2.value.mean, rtol=2e-3)
    np.testing.assert_allclose(s1.frame.mean, s2.frame.mean, rtol=2e-3)


# --- test_pixel_processor ------------------------------------------------------------


class _PowerProcessor(O.PixelProcessor):
    """Reference-style processor: the integrated power of each sample."""

    def __init__(self):
        self.values = []

    def add_sample(self, spectrum, sensitivity):
        self.values.append(spectrum.integrate() * sensitivity)

    def pack_results(self):
        v = np.asarray(self.values)
        return float(v.mean()), int(v.size)


class CustomPowerPipeline0D(O.Pipeline0D):
    """A user pipeline on the processor contract only."""

    name = "CustomPower0D"

    def initialise(self, shape, spectral_config, slices, quiet=False):
        self.totals = {}

    def pixel_processor(self, pixel_id, slice_id):
        return _PowerProcessor()

    def update(self, pixel_id, packed, slice_id):
        mean, n = packed
        prev_mean, prev_n = self.totals.get(pixel_id, (0.0, 0))
        self.totals[pixel_id] = (prev_mean + mean, prev_n + n)

    def finalise(self):
        self.value = sum(m for m, _ in self.totals.values())


class CustomMax2D(O.Pipeline2D):
    name = "CustomMax2D"

    def initialise(self, shape, spectral_config, slices, quiet=False):
        self.frame = np.zeros(shape)

    def pixel_processor(self, pixel_id, slice_id):
        return _PowerProcessor()

    def update(self, pixel_id, packed, slice_id):
        self.frame[pixel_id // self.frame.shape[1],
                   pixel_id % self.frame.shape[1]] += packed[0]


@pytest.mark.parametrize("spectral_rays", [1, 3])
def test_custom_processor_pipeline_matches_builtin(spectral_rays):
    """The processor pipeline agrees with the device PowerPipeline0D on the
    same samples; with slices, one processor per slice partitions the
    range."""
    builtin = O.PowerPipeline0D(accumulate=False)
    custom = CustomPowerPipeline0D()
    pix = O.Pixel(x_width=0.01, y_width=0.01, pipelines=[builtin, custom],
                  device="cpu")
    _furnace(pix)
    pix.pixel_samples = 64 if spectral_rays == 1 else 32
    pix.spectral_rays = spectral_rays
    pix.observe(seed=3)
    expected = 1e-4 * np.pi * DLAM
    assert abs(custom.value - expected) / expected < 5e-3
    assert abs(custom.value - builtin.value.mean) / expected < 1e-5


def test_custom_processor_pipeline_2d():
    pipe = CustomMax2D()
    cam = O.PinholeCamera(pixels=(4, 4), pipelines=[pipe], device="cpu")
    _furnace(cam)
    cam.pixel_samples = 8
    cam.observe(seed=5)
    assert np.all(pipe.frame > 0.0)


# --- test_samplers, on the samplers of core/math/random.py ---------------------------


def _uniforms(n, k, seed):
    return torch.rand((k, n), generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float64)


@pytest.mark.parametrize("name", ["sphere", "hemisphere_uniform",
                                  "hemisphere_cosine", "cone_uniform"])
def test_pdf_normalisation_and_self_consistency(name):
    """The pdf integrates to 1 over the sphere (MC with uniform directions),
    and E[1/pdf(X)] over X ~ pdf is the support's solid angle."""
    cos_max = math.cos(math.radians(30.0))
    pdf = {"sphere": lambda d: torch.full(d.shape[:-1], R.pdf_sphere(d)),
           "hemisphere_uniform": R.pdf_hemisphere_uniform,
           "hemisphere_cosine": R.pdf_hemisphere_cosine,
           "cone_uniform": lambda d: R.pdf_cone_uniform(d, cos_max)}[name]
    sample = {"sphere": R.vector_sphere,
              "hemisphere_uniform": R.vector_hemisphere_uniform,
              "hemisphere_cosine": R.vector_hemisphere_cosine,
              "cone_uniform": lambda a, b: R.vector_cone_uniform(a, b, cos_max)}[name]
    u = _uniforms(20000, 2, 1)
    integral = float(pdf(R.vector_sphere(u[0], u[1])).mean()) * 4.0 * math.pi
    assert abs(integral - 1.0) < 0.05
    v = _uniforms(20000, 2, 2)
    d = sample(v[0], v[1])
    assert torch.allclose(d.norm(dim=-1), torch.ones_like(d[:, 0]), atol=1e-6)
    if name != "hemisphere_cosine":  # 1/pdf is unbounded at the horizon
        sa = {"sphere": 4 * math.pi, "hemisphere_uniform": 2 * math.pi,
              "cone_uniform": 2 * math.pi * (1 - cos_max)}[name]
        est = float((1.0 / pdf(d)).mean())
        assert abs(est - sa) / sa < 0.02


def test_cosine_sampler_mean_z():
    u = _uniforms(20000, 2, 3)
    d = R.vector_hemisphere_cosine(u[0], u[1])
    assert abs(float(d[:, 2].mean()) - 2.0 / 3.0) < 0.01


def test_surface_samplers():
    u = _uniforms(5000, 2, 4)
    p = R.point_disk(u[0], u[1], 2.0)
    assert (p[:, :2].norm(dim=1) <= 2.0 + 1e-6).all() and (p[:, 2] == 0).all()
    p = R.point_rectangle(u[0], u[1], 2.0, 1.0)
    assert (p[:, 0].abs() <= 1.0).all() and (p[:, 1].abs() <= 0.5).all()
    v1, v2, v3 = (torch.tensor(v, dtype=torch.float64)
                  for v in ((0, 0, 0), (1, 0, 0), (0, 1, 0)))
    p = R.point_triangle(u[0], u[1], v1, v2, v3)
    assert (p[:, 0] >= -1e-9).all() and (p[:, 1] >= -1e-9).all()
    assert (p[:, 0] + p[:, 1] <= 1 + 1e-9).all()
    assert np.allclose(p.mean(0)[:2].numpy(), [1 / 3, 1 / 3], atol=0.02)


# --- the package's own --------------------------------------------------------------


def test_stats_arrays_fold_like_single_samples():
    """A Welford batch merge equals adding the samples one by one."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 0.5, (40, 3))
    a, b = SA.StatsArray1D(3), SA.StatsArray1D(3)
    for row in x:
        for i in range(3):
            a.add_sample(i, row[i])
    for part in (x[:15], x[15:]):
        b.merge_arrays(part.mean(0), ((part - part.mean(0)) ** 2).sum(0),
                       np.full(3, len(part)))
    np.testing.assert_allclose(b.mean, a.mean, rtol=1e-12)
    np.testing.assert_allclose(b.variance, a.variance, rtol=1e-10)
    np.testing.assert_allclose(a.variance, x.var(0, ddof=1), rtol=1e-10)
    np.testing.assert_allclose(a.errors(), np.sqrt(x.var(0, ddof=1) / 40),
                               rtol=1e-10)
    s = SA.StatsBin()
    s.combine_samples(x[:20, 0].mean(), x[:20, 0].var(ddof=1), 20)
    s.combine_samples(x[20:, 0].mean(), x[20:, 0].var(ddof=1), 20)
    assert s.mean == pytest.approx(a.mean[0]) and s.samples == 40
    assert s.variance == pytest.approx(a.variance[0])
    # the tensor half: fold_samples/combine_stats/stats_error
    t = torch.from_numpy(x[:, 0])
    st = SA.fold_samples(SA.zeros_stats((), torch.float64), t.sum(),
                         (t * t).sum(), 40)
    assert float(st[0]) == pytest.approx(a.mean[0])
    assert float(SA.stats_error(st)) == pytest.approx(a.errors()[0], rel=1e-6)


def test_pipeline_checkpoint_round_trip(tmp_path):
    pipes = [O.RGBPipeline2D(), O.PowerPipeline0D(),
             O.SpectralRadiancePipeline2D()]
    cam = O.PinholeCamera((4, 4), pipelines=pipes[::2], device="cpu")
    _furnace(cam)
    cam.pixel_samples = 2
    cam.spectral_bins = 3
    cam.observe(seed=1)
    pix = O.Pixel(pipelines=[pipes[1]], device="cpu")
    _furnace(pix)
    pix.pixel_samples = 2
    pix.observe(seed=1)
    for k, p in enumerate(pipes):
        path = tmp_path / f"p{k}.npz"
        p.save_state(path)
        q = type(p)()
        q.load_state(path)
        fp, fq = p.frame, q.frame
        np.testing.assert_array_equal(np.asarray(fq.mean), np.asarray(fp.mean))
        np.testing.assert_array_equal(np.asarray(fq.samples),
                                      np.asarray(fp.samples))


def test_colormap_and_engines():
    from source_tpu_torch.optical.observer import colormaps
    rgb = colormaps.apply_colormap(np.linspace(0, 1, 12).reshape(3, 4))
    assert rgb.shape == (3, 4, 3) and (rgb >= 0).all() and (rgb <= 1).all()
    from source_tpu_torch.parallel import RenderEngine, SerialEngine
    out = []
    SerialEngine().run([1, 2, 3], lambda t, k: t * k, out.append, (10,))
    assert out == [10, 20, 30] and SerialEngine().worker_count() == 1
    with pytest.raises(NotImplementedError):
        RenderEngine().worker_count()


def test_observer_runs_its_tiles_through_the_engine():
    """observe() hands its tile loop to ``render_engine`` (a SerialEngine
    when None), with the same frame; an engine over several devices and an
    object that is no engine are refused."""
    from source_tpu_torch.parallel import RenderEngine, SerialEngine

    class Recording(SerialEngine):
        def __init__(self):
            self.tasks = []

        def run(self, tasks, render, update, render_args=(), update_args=()):
            self.tasks = list(tasks)
            super().run(tasks, render, update, render_args, update_args)

    class TwoDevices(RenderEngine):
        def worker_count(self):
            return 2

    frames = []
    for engine in (None, Recording()):
        pipe = O.SpectralRadiancePipeline2D()
        cam = O.PinholeCamera((8, 8), pipelines=[pipe], render_engine=engine,
                              device="cpu")
        _furnace(cam)
        cam.pixel_samples = 2
        cam.spectral_bins = 4
        cam.tile_size = 32
        cam.observe(seed=3)
        frames.append(np.asarray(pipe.frame.mean))
    assert engine.tasks == [0, 1]
    np.testing.assert_array_equal(frames[1], frames[0])
    assert frames[0].shape == (8, 8, 4) and (frames[0] > 0).all()
    with pytest.raises(NotImplementedError):
        cam.render_engine = TwoDevices()
    with pytest.raises(TypeError):
        O.PinholeCamera((4, 4), render_engine=object(), device="cpu")


@pytest.mark.parametrize("world", ["cornell", "prism", "csg", "mis", "mesh"])
def test_suite_worlds_compile(world):
    """The suite's five worlds compile; the Cornell box and the MIS scene
    take the fused route, the other three the wavefront route."""
    from source_tpu_torch.tracer import fused
    make = {"cornell": lambda: scenes.cornell_box(glass=False),
            "prism": scenes.prism_world, "csg": scenes.csg_world,
            "mis": scenes.mis_world,
            "mesh": lambda: scenes.mesh_world(small=True)}[world]
    s = T.compile_scene(make(), T.SpectralConfig(375.0, 740.0, 4),
                        device="cpu")
    fused_route = fused.scene_tables(s, T.RayConfig()) is not None
    assert fused_route == (world in ("cornell", "mis"))
    assert s.leaf_bvh is not None


_IMPORT_CHECK = """
import sys
import source_tpu_torch.optical.observer as O
O.PinholeCamera((4, 4), device="cpu")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "source_tpu" or m.startswith("source_tpu.")]
assert not bad, bad
print("clean")
"""


def test_observer_package_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
