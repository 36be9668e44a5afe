"""Observer framework: spectral slices, pipelines' contract, observer bases.

Counterpart of the reference's optical/observer/base.py (itself a redesign
of raysect/optical/observer/base/{observer,slice,pipeline,processor,
sampler}.pyx). ``observe()`` compiles the scene once per spectral slice,
asks the frame sampler for a pixel task list, pads it into tiles and traces
each tile on the observer's device: camera rays, ``init_rays``,
``trace_rays`` (the fused route for the scenes it takes, the wavefront
route for the rest), then each pipeline's ``project``.

Statistics flow: per tile, every pipeline's per-pixel (sum, sum of squares)
over the samples stays on the device; after the tile loop one pull brings
all tiles' sums to the host, where the pipelines fold them into numpy
float64 StatsArrays with the reference's Welford merge (statsarray.pyx
combine_samples).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...compiler.scene import SpectralConfig, compile_scene, resolve_device
from ...core.math import batch as vmath
from ...core.scenegraph.node import Observer as _SceneObserver
from ...parallel.engine import RenderEngine, SerialEngine
from ...tracer.wavefront import (
    RayConfig, alive_profile, init_rays, schedule_from_profile, trace_rays,
)
from ..spectrum import Spectrum

__all__ = [
    "SpectralSlice",
    "FrameSampler1D",
    "FrameSampler2D",
    "Pipeline",
    "Pipeline0D",
    "Pipeline1D",
    "Pipeline2D",
    "PixelProcessor",
    "ObserverBase",
    "Observer0D",
    "Observer1D",
    "Observer2D",
]

# the stream site of the compaction schedule's profile ("auto"), beside the
# tiles' (tile, sample chunk, slice) sites; see ``ObserverBase.observe``
SCHEDULE_SITE = "schedule"


class SpectralSlice:
    """A contiguous sub-range of the spectral bins (base/slice.pyx:32)."""

    def __init__(self, min_wavelength, max_wavelength, bins, slice_bins, offset):
        self.total_bins = int(bins)
        self.bins = int(slice_bins)
        self.offset = int(offset)
        delta = (max_wavelength - min_wavelength) / bins
        self.min_wavelength = min_wavelength + delta * offset
        self.max_wavelength = min_wavelength + delta * (offset + slice_bins)

    @property
    def config(self):
        return SpectralConfig(self.min_wavelength, self.max_wavelength, self.bins)


class FrameSampler1D:
    """Task generator contract (base/sampler.pyx:32)."""

    def generate_tasks(self, pixels):
        raise NotImplementedError


class FrameSampler2D:
    def generate_tasks(self, pixels):
        raise NotImplementedError


class Pipeline:
    """Pipeline contract (base/pipeline.pyx:37-254).

    Device side: ``project(spectra, consts, sensitivity, px, py)`` maps the
    per-sample spectra f32 [T, S, slice.bins] to channel values [T, S, C];
    ``consts`` is what ``projection_constants(slice_)`` returns for the
    slice (tensors, moved to the observer's device). Host side:
    ``initialise``/``update``/``finalise`` keep the StatsArray frames.
    """

    name = None

    def n_channels(self, total_bins):
        raise NotImplementedError

    def projection_constants(self, slice_: SpectralSlice):
        """The slice's constants that ``project`` reads."""
        return {}

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        raise NotImplementedError

    def initialise(self, shape, spectral_config, slices, quiet=False):
        raise NotImplementedError

    def update(self, pixel_ids, mean, m2, n):
        """Fold a tile's per-pixel channel statistics into the frame:
        pixel_ids int [T] flat pixel indices; mean, m2 [T, C]; n [T]."""
        raise NotImplementedError

    def finalise(self):
        pass


class Pipeline0D(Pipeline):
    """Pipeline of a 0D observer (base/pipeline.pyx:37): one spectrum."""


class Pipeline1D(Pipeline):
    """Pipeline of a 1D observer (base/pipeline.pyx:110): a pixel line."""


class Pipeline2D(Pipeline):
    """Pipeline of a 2D observer (base/pipeline.pyx:183): a pixel grid."""


class PixelProcessor:
    """Per-task sample accumulator contract (base/processor.pyx:61-72).

    The built-in pipelines never make one: their samples fold on the
    device. A pipeline that defines ``pixel_processor(pixel_id, slice_id)
    -> PixelProcessor`` instead of ``project`` is driven on the host: the
    observer pulls the traced per-sample slice spectra, calls
    ``add_samples`` (by default ``add_sample(spectrum, sensitivity)`` per
    sample) and ``pack_results()`` per pixel, and hands the packed result
    to ``pipeline.update(pixel_id, packed, slice_id)`` (the reference loop,
    base/observer.pyx:363-419)."""

    def add_sample(self, spectrum, sensitivity):
        raise NotImplementedError

    def add_samples(self, min_wavelength, max_wavelength, bins, samples,
                    sensitivity):
        """Fold one pixel's whole sample batch [S, bins] (numpy float64).
        Override to vectorise a custom processor; the default makes one
        Spectrum per row for ``add_sample``."""
        for row in samples:
            self.add_sample(
                Spectrum(min_wavelength, max_wavelength, bins, samples=row),
                sensitivity,
            )

    def pack_results(self):
        raise NotImplementedError


def _uses_pixel_processor(pipe):
    """True for pipelines driven through the PixelProcessor API (they define
    ``pixel_processor`` and fold their samples on the host)."""
    return callable(getattr(pipe, "pixel_processor", None))


def _reduce_samples(proj):
    """Per-pixel (sum, sum of squares) over the sample axis of the
    projections [T, S, C], on their device: two [T, C] tensors."""
    return proj.sum(dim=1), (proj * proj).sum(dim=1)


def _slice_spectrum(min_wavelength, max_wavelength, bins, rays):
    """The reference's slicing (base/observer.pyx:311-340)."""
    current = 0.0
    start = 0
    ranges = []
    while start < bins:
        current += bins / rays
        end = round(current)
        ranges.append((start, end))
        start = end
    return [
        SpectralSlice(min_wavelength, max_wavelength, bins, end - start, start)
        for start, end in ranges
    ]


def _on(consts, device):
    """A pipeline's projection constants with every tensor on ``device``."""
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in consts.items()}


class ObserverBase(_SceneObserver):
    """Common observer machinery (base/observer.pyx:70-545).

    Subclasses supply:
      _pixel_shape                      -- pixel dims ((), (n,), (nx, ny))
      _generate_rays_device(px, py, u)  -- camera-local rays [T, S, 3] x2
                                           and weight [T, S]
      _rays_per_sample                  -- uniforms per camera sample
      _pixel_sensitivity_array()        -- per-pixel sensitivity, flat

    ``device`` is where ``observe()`` traces: ``"cuda"`` by default, which
    raises when no card is there (``device="cpu"`` runs the plain PyTorch
    versions of the kernels). ``render_engine`` runs the tile loop: None
    means a ``SerialEngine``; an engine over more than one device raises
    ``NotImplementedError`` (the port has no sharded engine yet).
    """

    def __init__(self, parent=None, transform=None, name=None, pipelines=None,
                 render_engine=None, device="cuda"):
        super().__init__(parent, transform, name)
        self.pipelines = pipelines or []
        self.render_engine = render_engine
        self.device = device

        # spectral configuration (base/observer.pyx:113-122 defaults)
        self._min_wavelength = 375.0
        self._max_wavelength = 740.0
        self._spectral_bins = 15
        self._spectral_rays = 1

        # ray configuration
        self._ray_extinction_prob = 0.01
        self._ray_extinction_min_depth = 3
        self._ray_max_depth = 500
        self._ray_importance_sampling = True
        self._ray_important_path_weight = 0.25
        # storage dtype of the spectral path state between bounces:
        # "float32" or "bfloat16" (RayConfig.spectral_dtype)
        self.ray_spectral_dtype = "float32"

        # sampling configuration
        self.pixel_samples = 100
        self.samples_per_task = 250  # samples per chunk of a tile
        self.tile_size = 4096  # pixels per device batch
        self.quiet = False
        self.render_complete = False

        # bound of the wavefront loop: longer paths are truncated
        self.max_wavefront_iters = 64
        # stream compaction of the wavefront loop:
        #   "auto" (default): measure the per-bounce alive profile on the
        #     first tile of a pass and derive a conservative schedule
        #     (tracer/wavefront.schedule_from_profile), cached per scene;
        #   (): off;
        #   ((steps, divisor), ...): explicit stages.
        # An overflowing stage reweights (unbiased); the overflow count is
        # in the render statistics.
        self.compact_schedule = "auto"

        self._stats_start = None
        self._stats_rays = 0
        # injected (camera_u, u_all, shifts) of the running observe()
        self._streams = (None, None, None)

    # --- validated properties (base/observer.pyx:100-262) -----------------------

    @property
    def render_engine(self):
        return self._render_engine

    @render_engine.setter
    def render_engine(self, value):
        if value is not None:
            if not isinstance(value, RenderEngine):
                raise TypeError("render_engine must be a RenderEngine or None.")
            if value.worker_count() != 1:
                raise NotImplementedError(
                    "Engines over several devices are not part of the port "
                    "yet: use a SerialEngine or None.")
        self._render_engine = value

    @property
    def spectral_bins(self):
        return self._spectral_bins

    @spectral_bins.setter
    def spectral_bins(self, value):
        if value <= 0:
            raise ValueError("The number of spectral bins must be greater than 0.")
        if value < self._spectral_rays:
            raise ValueError("Spectral bins cannot be less than spectral rays.")
        self._spectral_bins = int(value)

    @property
    def spectral_rays(self):
        return self._spectral_rays

    @spectral_rays.setter
    def spectral_rays(self, value):
        if not 0 < value <= self._spectral_bins:
            raise ValueError("Spectral rays must be in (0, spectral_bins].")
        self._spectral_rays = int(value)

    @property
    def min_wavelength(self):
        return self._min_wavelength

    @min_wavelength.setter
    def min_wavelength(self, value):
        if value <= 0 or value >= self._max_wavelength:
            raise ValueError("Minimum wavelength must be positive and below the maximum.")
        self._min_wavelength = float(value)

    @property
    def max_wavelength(self):
        return self._max_wavelength

    @max_wavelength.setter
    def max_wavelength(self, value):
        if value <= self._min_wavelength:
            raise ValueError("Maximum wavelength must be above the minimum.")
        self._max_wavelength = float(value)

    @property
    def ray_extinction_prob(self):
        return self._ray_extinction_prob

    @ray_extinction_prob.setter
    def ray_extinction_prob(self, value):
        if not 0 <= value <= 1:
            raise ValueError("Extinction probability must be in [0, 1].")
        self._ray_extinction_prob = float(value)

    @property
    def ray_extinction_min_depth(self):
        return self._ray_extinction_min_depth

    @ray_extinction_min_depth.setter
    def ray_extinction_min_depth(self, value):
        if value < 0:
            raise ValueError("Minimum extinction depth cannot be negative.")
        self._ray_extinction_min_depth = int(value)

    @property
    def ray_max_depth(self):
        return self._ray_max_depth

    @ray_max_depth.setter
    def ray_max_depth(self, value):
        if value < 0:
            raise ValueError("Maximum depth cannot be negative.")
        self._ray_max_depth = int(value)

    @property
    def ray_importance_sampling(self):
        return self._ray_importance_sampling

    @ray_importance_sampling.setter
    def ray_importance_sampling(self, value):
        self._ray_importance_sampling = bool(value)

    @property
    def ray_important_path_weight(self):
        return self._ray_important_path_weight

    @ray_important_path_weight.setter
    def ray_important_path_weight(self, value):
        if not 0 <= value <= 1:
            raise ValueError("Important path weight must be in [0, 1].")
        self._ray_important_path_weight = float(value)

    # --- subclass hooks ----------------------------------------------------------

    @property
    def _pixel_shape(self):
        raise NotImplementedError

    def _generate_rays_device(self, px, py, u):
        raise NotImplementedError

    _rays_per_sample = 2

    def _pixel_sensitivity_array(self):
        n = int(np.prod(self._pixel_shape)) if self._pixel_shape else 1
        return np.ones(n, dtype=np.float32)

    def _generate_tasks(self):
        raise NotImplementedError

    # --- observe -------------------------------------------------------------------

    def _ray_config(self, schedule=()):
        return RayConfig(
            max_depth=self._ray_max_depth,
            extinction_prob=self._ray_extinction_prob,
            extinction_min_depth=self._ray_extinction_min_depth,
            importance_sampling=self._ray_importance_sampling,
            important_path_weight=self._ray_important_path_weight,
            max_iters=self.max_wavefront_iters,
            compact_schedule=tuple(schedule),
            spectral_dtype=self.ray_spectral_dtype,
        )

    def _camera_rays(self, px, py, u, cam_to_world):
        """World-space rays of the uniforms u [T, S, rays_per_sample]:
        origins, unit directions [T*S, 3] and weights [T*S]."""
        o_loc, d_loc, w = self._generate_rays_device(px[:, None], py[:, None], u)
        o = vmath.transform_point(cam_to_world, o_loc.reshape(-1, 3))
        d = vmath.normalise(
            vmath.transform_vector(cam_to_world, d_loc.reshape(-1, 3)))
        return o, d, w.reshape(-1)

    def _uniforms(self, site, shape, generator, device):
        """The camera uniforms of a stream site: the generator's, or the
        injected ``camera_u(site, shape)``'s."""
        camera_u = self._streams[0]
        if camera_u is None:
            return torch.rand(shape, generator=generator, dtype=torch.float32,
                              device=device)
        return torch.as_tensor(camera_u(site, shape),
                               dtype=torch.float32).to(device)

    def _site_streams(self, site, device):
        """The injected ``u_all``/``shifts`` bound to a stream site (None
        where nothing is injected)."""
        _, u_all, shifts = self._streams
        bound_u = (None if u_all is None else
                   lambda start, n_steps, n_lanes: torch.as_tensor(
                       u_all(site, start, n_steps, n_lanes),
                       dtype=torch.float32).to(device))
        bound_s = (None if shifts is None else
                   lambda done, alive: shifts(site, done, alive))
        return bound_u, bound_s

    def _resolve_compact_schedule(self, scene, cfg0, px, py, cam_to_world,
                                  spp, generator):
        """This pass's ``compact_schedule``. "auto" measures the per-bounce
        alive profile on (a subsample of) the first tile and derives a
        conservative staged schedule, cached on the observer by scene shape
        so later passes reuse it."""
        if self.compact_schedule != "auto":
            return tuple(self.compact_schedule)
        cache_key = (id(self.root), scene.n_entities, scene.n_leaves,
                     cfg0, scene.n_bins)
        cached = getattr(self, "_auto_schedule_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        # subsample lanes: the profile only needs fractions
        T = px.shape[0]
        s_meas = max(1, min(spp, 8192 // T if T < 8192 else 1))
        u = self._uniforms(SCHEDULE_SITE, (T, s_meas, self._rays_per_sample),
                           generator, px.device)
        o, d, w = self._camera_rays(px, py, u, cam_to_world)
        state = init_rays(o, d, scene.bins, weight=w)
        u_all, _ = self._site_streams(SCHEDULE_SITE, px.device)
        counts = alive_profile(scene, cfg0, state, generator, u_all=u_all)
        schedule = schedule_from_profile(counts.tolist(), o.shape[0])
        self._auto_schedule_cache = (cache_key, schedule)
        return schedule

    def observe(self, seed=None, camera_u=None, u_all=None, shifts=None):
        """Render a pass (base/observer.pyx:265-309).

        ``seed`` seeds the one ``torch.Generator`` (on the observer's
        device) that every draw of the pass comes from: camera uniforms,
        bounce uniforms and compaction rotations, in loop order.

        ``camera_u``, ``u_all`` and ``shifts`` inject the streams instead
        (a test hook: parity tests hand in the reference's). Each takes the
        stream's site first: ``(tile, sample chunk, slice)`` for a tile's
        trace, ``SCHEDULE_SITE`` for the "auto" schedule's profile.
        ``camera_u(site, shape)`` returns the camera uniforms [T, S,
        rays_per_sample]; ``u_all(site, start, n_steps, n_lanes)`` and
        ``shifts(site, done, alive_count)`` are ``trace_rays``'s
        (``alive_profile`` takes one bounce at a time from ``u_all``).
        """
        if self.root is None or not hasattr(self.root, "primitives"):
            raise RuntimeError("The observer must be attached to a World scenegraph.")
        world = self.root
        device = resolve_device(self.device)

        slices = _slice_spectrum(
            self._min_wavelength, self._max_wavelength,
            self._spectral_bins, self._spectral_rays,
        )
        scenes = [compile_scene(world, s.config, device=device) for s in slices]

        shape = self._pixel_shape
        self._initialise_pipelines(shape, slices)
        # device pipelines project on the card; PixelProcessor pipelines
        # fold their samples on the host
        self._dev_pipes = [p for p in self.pipelines if not _uses_pixel_processor(p)]
        self._proc_pipes = [p for p in self.pipelines if _uses_pixel_processor(p)]

        tasks = np.asarray(self._generate_tasks(), dtype=np.int64)
        if tasks.size == 0:
            self.render_complete = True
            return
        self.render_complete = False

        self._streams = (camera_u, u_all, shifts)
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed) if seed is not None
                              else np.random.randint(0, 2 ** 31 - 1))
        consts = [[_on(p.projection_constants(s), device) for p in self._dev_pipes]
                  for s in slices]
        try:
            self._initialise_statistics(tasks)
            self._observe_tiles(tasks, slices, scenes, consts, generator,
                                device)
        finally:
            self._streams = (None, None, None)
        self._finalise_pipelines()
        self._finalise_statistics()

    def _observe_tiles(self, tasks, slices, scenes, consts, generator, device):
        cfg0 = self._ray_config(())
        cam_to_world = torch.from_numpy(
            self.to_root().to_array(np.float32)).to(device)
        sensitivity_all = torch.from_numpy(
            self._pixel_sensitivity_array()).to(device)

        T = int(self.tile_size)
        n_tasks = tasks.shape[0]
        n_tiles = (n_tasks + T - 1) // T
        spp = int(self.pixel_samples)

        # sample chunking (base/observer.pyx:629-644 samples_per_task): a
        # large observation streams in fixed-memory chunks of samples
        spt = int(self.samples_per_task or spp)
        spt = max(1, min(spt, spp))
        sample_chunks = [spt] * (spp // spt)
        if spp % spt:
            sample_chunks.append(spp % spt)

        deferred_tiles = []
        deferred_segs = []
        deferred_ovfs = []
        cfg = None  # resolved (with the "auto" schedule) at the first tile

        def render(tile_idx):
            """Trace one tile: its flat ids, valid mask and the device sums
            and sums of squares per pipeline."""
            nonlocal cfg
            chunk = tasks[tile_idx * T:(tile_idx + 1) * T]
            # pad to the next power of two (at least 8), NOT to the tile
            # size: a 0D observer's one task must not become tile_size
            # copies of itself
            t_eff = 8
            while t_eff < chunk.shape[0]:
                t_eff *= 2
            t_eff = min(T, t_eff)
            pad = t_eff - chunk.shape[0]
            valid = np.ones(t_eff, dtype=bool)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                valid[-pad:] = False
            flat_ids = self._task_to_flat(chunk)
            px, py = self._task_to_pixel_coords(chunk)
            sens = sensitivity_all[torch.from_numpy(flat_ids).to(device)]
            pxt = torch.from_numpy(np.asarray(px, np.int64)).to(device)
            pyt = torch.from_numpy(np.asarray(py, np.int64)).to(device)
            if cfg is None:
                schedule = self._resolve_compact_schedule(
                    scenes[0], cfg0, pxt, pyt, cam_to_world, spt, generator)
                cfg = self._ray_config(schedule)

            # per chunk the slices' projections sum into the full channel
            # count, then reduce over the samples on the device; only the
            # [T, C] sums leave it, after the tile loop
            acc_sum = acc_sq = None
            proc_spectra = [[] for _ in slices]
            for c_idx, s_chunk in enumerate(sample_chunks):
                proj_sums = None
                for s_idx, (slice_, scene) in enumerate(zip(slices, scenes)):
                    out = self._render_tile(
                        scene, cfg, slice_, pxt, pyt, sens, cam_to_world,
                        s_chunk, generator, consts[s_idx],
                        (tile_idx, c_idx, s_idx))
                    if self._proc_pipes:
                        projections, spectra, segments, overflow = out
                        proc_spectra[s_idx].append(spectra.cpu().numpy())
                    else:
                        projections, segments, overflow = out
                    deferred_segs.append(segments)
                    deferred_ovfs.append(overflow)
                    # each pipeline projects to its FULL channel count
                    # (spectral pipelines zero-fill outside the slice)
                    if proj_sums is None:
                        proj_sums = list(projections)
                    else:
                        proj_sums = [a + b for a, b in zip(proj_sums, projections)]
                sums = [_reduce_samples(p) for p in proj_sums]
                if acc_sum is None:
                    acc_sum = [s1 for s1, _ in sums]
                    acc_sq = [s2 for _, s2 in sums]
                else:
                    acc_sum = [a + s1 for a, (s1, _) in zip(acc_sum, sums)]
                    acc_sq = [a + s2 for a, (_, s2) in zip(acc_sq, sums)]

            if self._proc_pipes:
                self._fold_processors(slices, proc_spectra, flat_ids, valid,
                                      sens)
            return flat_ids, valid, acc_sum, acc_sq

        def update(tile):
            deferred_tiles.append(tile)
            if not self.quiet:
                print(f"  tile {len(deferred_tiles)}/{n_tiles} dispatched - "
                      f"{time.time() - self._stats_start:0.2f}s", flush=True)

        # the engine keeps the tiles in order: the generator's draws follow
        # the loop
        (self._render_engine or SerialEngine()).run(range(n_tiles), render,
                                                    update)

        # one pull of every tile's device sums, after the loop
        n_pipes = len(self._dev_pipes)
        host_sum = [torch.cat([t[2][i] for t in deferred_tiles]).cpu().numpy()
                    for i in range(n_pipes)]
        host_sq = [torch.cat([t[3][i] for t in deferred_tiles]).cpu().numpy()
                   for i in range(n_pipes)]
        counters = torch.stack([torch.stack(deferred_segs),
                                torch.stack(deferred_ovfs)]).cpu().numpy()
        self._stats_rays += int(np.sum(counters[0], dtype=np.int64))
        self._stats_overflow += int(np.sum(counters[1], dtype=np.int64))
        off = 0
        for tile_idx, (flat_ids, valid, _s, _q) in enumerate(deferred_tiles):
            t_eff = valid.shape[0]
            for pipe, v_sum, v_sq in zip(
                    self._dev_pipes,
                    (h[off:off + t_eff] for h in host_sum),
                    (h[off:off + t_eff] for h in host_sq)):
                v_sum = np.asarray(v_sum, dtype=np.float64)
                v_sq = np.asarray(v_sq, dtype=np.float64)
                mean = v_sum / spp
                m2 = v_sq - spp * mean * mean
                np.maximum(m2, 0.0, out=m2)  # guard f.p. cancellation
                n = np.full(mean.shape[:1], spp, dtype=np.int64)
                pipe.update(flat_ids[valid], mean[valid], m2[valid], n[valid])
            off += t_eff
            self._update_statistics(tile_idx, n_tiles)

    def _fold_processors(self, slices, proc_spectra, flat_ids, valid, sens):
        """PixelProcessor pipelines: one processor per pixel and slice, fed
        the pixel's whole sample set (base/observer.pyx:363-419)."""
        sens_np = sens.cpu().numpy()
        for s_idx, slice_ in enumerate(slices):
            sp = np.concatenate(proc_spectra[s_idx], axis=1).astype(np.float64)
            for pipe in self._proc_pipes:
                for t in range(sp.shape[0]):
                    if not valid[t]:
                        continue
                    proc = pipe.pixel_processor(int(flat_ids[t]), s_idx)
                    proc.add_samples(slice_.min_wavelength,
                                     slice_.max_wavelength, slice_.bins,
                                     sp[t], float(sens_np[t]))
                    pipe.update(int(flat_ids[t]), proc.pack_results(), s_idx)

    # --- one tile of one slice ---------------------------------------------------------

    def _render_tile(self, scene, cfg, slice_, px, py, sensitivity,
                     cam_to_world, spp, generator, consts, site):
        """Trace one pixel tile for one spectral slice: camera rays,
        ``init_rays``, ``trace_rays`` (route "auto"), then each device
        pipeline's ``project``. Returns the per-pipeline per-sample
        projections [T, spp, C], the per-sample slice spectra when a
        PixelProcessor pipeline is attached, and the device counters of
        traced segments and compaction overflow."""
        T = px.shape[0]
        bins = slice_.bins
        u = self._uniforms(site, (T, spp, self._rays_per_sample), generator,
                           px.device)
        o, d, w = self._camera_rays(px, py, u, cam_to_world)
        state = init_rays(o, d, bins, weight=w,
                          spectral_dtype=cfg.spectral_dtype)
        u_all, shifts = self._site_streams(site, px.device)
        final = trace_rays(scene, cfg, state, generator, u_all=u_all,
                           shifts=shifts, route="auto")
        # statistics accumulate in f32 whatever the state's dtype
        spectra = final.radiance.to(torch.float32).reshape(T, spp, bins)
        outs = tuple(pipe.project(spectra, c, sensitivity, px, py)
                     for pipe, c in zip(self._dev_pipes, consts))
        if self._proc_pipes:
            return outs, spectra, final.segments, final.overflow
        return outs, final.segments, final.overflow

    # --- pipeline + statistics plumbing ------------------------------------------------

    def _initialise_pipelines(self, shape, slices):
        spectral_config = SpectralConfig(
            self._min_wavelength, self._max_wavelength, self._spectral_bins
        )
        for pipe in self.pipelines:
            pipe.initialise(shape, spectral_config, slices, quiet=self.quiet)

    def _finalise_pipelines(self):
        for pipe in self.pipelines:
            pipe.finalise()

    def _initialise_statistics(self, tasks):
        self._stats_start = time.time()
        self._stats_rays = 0
        self._stats_overflow = 0
        if not self.quiet:
            print(f"{self.name or type(self).__name__}: observing, "
                  f"{tasks.shape[0]} tasks x {self.pixel_samples} samples "
                  f"x {self._spectral_rays} spectral rays")

    def _update_statistics(self, tile_idx, n_tiles):
        if not self.quiet:
            elapsed = time.time() - self._stats_start
            print(
                f"  tile {tile_idx + 1}/{n_tiles} - {elapsed:0.2f}s "
                f"({1e-3 * self._stats_rays / max(elapsed, 1e-9):0.1f}k rays/s)",
                flush=True,
            )

    def _finalise_statistics(self):
        elapsed = time.time() - self._stats_start
        self.render_time = elapsed
        self.rays_per_second = self._stats_rays / max(elapsed, 1e-9)
        self.compaction_overflow = self._stats_overflow
        if not self.quiet:
            print(
                f"Render complete - time elapsed {elapsed:0.3f}s - "
                f"{1e-3 * self.rays_per_second:0.1f}k rays/s"
            )
            if self._stats_overflow:
                print(
                    f"  note: {self._stats_overflow} alive lanes exceeded a "
                    "compaction stage and were roulette-reweighted (unbiased,"
                    " extra variance) - loosen compact_schedule divisors"
                )

    # --- task helpers ----------------------------------------------------------------

    def _task_to_flat(self, tasks):
        raise NotImplementedError

    def _task_to_pixel_coords(self, tasks):
        raise NotImplementedError


class Observer0D(ObserverBase):
    """Single-sensor observer (base/observer.pyx:547)."""

    @property
    def _pixel_shape(self):
        return ()

    def _generate_tasks(self):
        return np.zeros((1, 1), dtype=np.int64)

    def _task_to_flat(self, tasks):
        return np.zeros(tasks.shape[0], dtype=np.int64)

    def _task_to_pixel_coords(self, tasks):
        z = np.zeros(tasks.shape[0], dtype=np.int64)
        return z, z


class Observer1D(ObserverBase):
    """Line of pixels (base/observer.pyx:717)."""

    def __init__(self, pixels=1, frame_sampler=None, **kwargs):
        super().__init__(**kwargs)
        self.pixels = int(pixels)
        self.frame_sampler = frame_sampler

    @property
    def _pixel_shape(self):
        return (self.pixels,)

    def _generate_tasks(self):
        if self.frame_sampler is not None:
            tasks = self.frame_sampler.generate_tasks((self.pixels,))
            return np.asarray(
                [(t[0] if isinstance(t, tuple) else t,) for t in tasks],
                dtype=np.int64).reshape(-1, 1)
        return np.arange(self.pixels, dtype=np.int64).reshape(-1, 1)

    def _task_to_flat(self, tasks):
        return tasks[:, 0]

    def _task_to_pixel_coords(self, tasks):
        return tasks[:, 0], np.zeros(tasks.shape[0], dtype=np.int64)


class Observer2D(ObserverBase):
    """2D pixel-array observer (base/observer.pyx:896)."""

    def __init__(self, pixels=(64, 64), frame_sampler=None, **kwargs):
        super().__init__(**kwargs)
        self.pixels = tuple(int(v) for v in pixels)
        self.frame_sampler = frame_sampler

    @property
    def _pixel_shape(self):
        return self.pixels

    def _generate_tasks(self):
        if self.frame_sampler is not None:
            tasks = self.frame_sampler.generate_tasks(self.pixels)
            return np.asarray(tasks, dtype=np.int64).reshape(-1, 2)
        nx, ny = self.pixels
        xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        return np.stack([xs.ravel(), ys.ravel()], axis=1)

    def _task_to_flat(self, tasks):
        return tasks[:, 0] * self.pixels[1] + tasks[:, 1]

    def _task_to_pixel_coords(self, tasks):
        return tasks[:, 0], tasks[:, 1]
