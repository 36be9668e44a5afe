"""Traffic ``observe``: progressive ``observe()`` passes of a pinhole camera
with an RGB pipeline, back to back, accumulating into one frame.

A pass renders every pixel at the cell's samples per pixel: tiles of the
observer's ``tile_size`` pixels, one trace of ``tile x samples`` rays
each, with the cell's compaction schedule. The camera and bounce uniforms
of each tile are handed to the port through its stream hooks
(``observe(camera_u=, u_all=)``), drawn on the device from the seed, the
pass and the tile; the compaction rotations come from the pass's own
generator (``observe(seed=)``), in loop order. Each pass ends in the
observer's one pull. ``observe_samples_per_s`` is the camera samples of
every pass over the window.

The check takes the first pass and passes drawn from the seed. For each, the
frame is copied before and after the pass; every pixel must have gained
exactly the pass's samples, and on tiles drawn from the seed the pass's
mean implied by the two frames, and the variance after the fold, are held
to the plain reference's camera, trace, projection and Welford fold of the
same uniforms, from the frame before the pass: the share of pixels with a
channel off (``common.off_pct``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import scene as S
from portbench.reference import tables as rtables
from portbench.reference import trace as rtrace
from portbench.reference.tables import transform_of
from portbench.traffic.common import Traffic, off_pct, sampled


class Observe(Traffic):

    def setup(self):
        import source_tpu_torch as T
        from source_tpu_torch.optical.observer import (
            PinholeCamera, RGBPipeline2D,
        )

        p, cfg = self.p, self.ctx.config
        world = S.build_world(cfg)
        tr = T.translate(0, 0, 0)
        for op, args in p["camera_transform"]:
            tr = tr * getattr(T, op)(*args)
        self.pixels = tuple(p["pixels"])
        cam = PinholeCamera(self.pixels, fov=p["fov"], parent=world,
                            transform=tr, pipelines=[RGBPipeline2D()],
                            device=self.dev)
        sp, r = cfg["spectral"], cfg["ray"]
        cam.min_wavelength = sp["min_wavelength"]
        cam.max_wavelength = sp["max_wavelength"]
        cam.spectral_bins = sp["bins"]
        cam.spectral_rays = 1
        cam.ray_max_depth = r["max_depth"]
        cam.ray_extinction_prob = r["extinction_prob"]
        cam.ray_extinction_min_depth = r["extinction_min_depth"]
        cam.ray_importance_sampling = r["importance_sampling"]
        cam.ray_important_path_weight = r["important_path_weight"]
        cam.ray_spectral_dtype = self.ctx.precision
        cam.pixel_samples = p["spp"]
        cam.samples_per_task = p["samples_per_task"]
        cam.tile_size = p["tile_size"]
        cam.max_wavefront_iters = p["max_iters"]
        cam.compact_schedule = tuple(tuple(s) for s in p["compact_schedule"])
        cam.quiet = True
        self.cam = cam
        self.n_pixels = self.pixels[0] * self.pixels[1]
        self.n_tiles = -(-self.n_pixels // p["tile_size"])
        if p["samples_per_task"] < p["spp"]:
            raise ValueError("one sample chunk a tile is what the check "
                             "follows: samples_per_task >= spp")
        self.check_passes = sampled(self.ctx.seed, p["check_passes"],
                                    p["check_below"], 29)
        self.check_tiles = {i: sampled(self.ctx.seed + i, p["check_tiles"],
                                       self.n_tiles, 31)
                            for i in self.check_passes}
        self.pass_segments = []
        self.frames = {}
        # the warm-up pass, at the cell's shapes, into a frame thrown away
        self.observe(-1)
        cam.pipelines = [RGBPipeline2D()]
        self.rgb = cam.pipelines[0]

    def pass_seed(self, i):
        return (self.ctx.seed * 1_000_003 + i + 7) % (2 ** 31 - 1)

    def observe(self, i):
        st = self.streams

        def camera_u(site, shape):
            return st.rand(shape, i, 1, *site)

        def u_all(site, start, n_steps, n_lanes):
            return st.rand((n_steps, n_lanes, 10), i, 2, *site, start)

        self.cam.observe(seed=self.pass_seed(i), camera_u=camera_u,
                         u_all=u_all)

    def _frame(self):
        f = self.rgb.xyz_frame
        return (f.mean.copy(), f._m2.copy(), f.samples.copy())

    def step(self, i):
        keep = i in self.check_passes
        if keep:
            self.frames[i] = [None if self.rgb.xyz_frame is None
                              else self._frame()]
        self.observe(i)
        self.pass_segments.append(self.cam._stats_rays)
        if keep:
            self.frames[i].append(self._frame())

    def e2e(self, calls, seconds, times):
        self.calls = calls
        samples = calls * self.n_pixels * self.p["spp"]
        return {"observe_samples_per_s": samples / seconds}

    def spans(self):
        from source_tpu_torch.optical.observer import base
        return [(base.ObserverBase, "_observe_tiles", "observe.tile_loop"),
                (base, "compile_scene", "observe.compile_scene"),
                (base, "trace_rays", "observe.trace_rays"),
                (self.rgb, "update", "observe.fold")]

    def counts(self):
        return {"calls": self.calls, "passes": self.calls,
                "segments": float(sum(self.pass_segments)),
                "tiles": self.n_tiles, "tile_rays": self.p["tile_size"]
                * self.p["spp"], "schedule": self.p["compact_schedule"],
                "max_iters": self.p["max_iters"],
                "span_launches": self.calls * self.n_tiles * (
                    1 + len(self.p["compact_schedule"]))}

    def release(self):
        self.cam = None

    # --- the check ---------------------------------------------------------

    def check(self):
        p, cfg = self.p, self.ctx.config
        sp = cfg["spectral"]
        lo, hi = rtables.slice_bounds(sp)
        B = sp["bins"]
        tabs, spec = rtables.compile_config(cfg, device=self.dev,
                                            bounds=(lo, hi))
        cam = np.eye(4)
        cam = cam @ transform_of(p["camera_transform"])
        cam = torch.as_tensor(cam.astype(np.float32)).to(self.dev)
        nx, ny = self.pixels
        xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        tasks = np.stack([xs.ravel(), ys.ravel()], axis=1)
        cie = rtrace.ciexyz_bins(lo, hi, B).to(self.dev)
        delta = torch.tensor((hi - lo) / B, dtype=torch.float32).to(self.dev)
        T, spp = p["tile_size"], p["spp"]
        n_stage = len(p["compact_schedule"])
        pass_off = fold_off = 0.0
        samples_off = 0
        with torch.no_grad():
            tab = rtrace.rb.pack_tabvec(tabs, spec)
            for i in sorted(self.frames):
                before, after = self.frames[i]
                mean_a, m2_a, n_a = after
                if before is None:
                    before = (np.zeros_like(mean_a), np.zeros_like(m2_a),
                              np.zeros_like(n_a))
                mean_b, m2_b, n_b = before
                samples_off += int(np.count_nonzero(n_a != n_b + spp))
                # the pass generator's compaction draws, in loop order
                g = torch.Generator(device=self.dev)
                g.manual_seed(self.pass_seed(i))
                draws = [torch.rand((), generator=g, device=self.dev)
                         for _ in range(self.n_tiles * n_stage)]
                got, ref, got_m2, ref_m2s = [], [], [], []
                for t in self.check_tiles[i]:
                    chunk = tasks[t * T:(t + 1) * T]
                    px = torch.as_tensor(chunk[:, 0]).to(self.dev)
                    py = torch.as_tensor(chunk[:, 1]).to(self.dev)
                    site = (t, 0, 0)
                    u = self.streams.rand((len(chunk), spp, 2), i, 1, *site)
                    o, d, w = rtrace.pinhole_rays(px, py, u, nx, ny,
                                                  p["fov"], cam)
                    stage = iter(draws[t * n_stage:(t + 1) * n_stage])

                    def u_of(start, n_steps, n_lanes, _site=site, _i=i):
                        return self.streams.rand((n_steps, n_lanes, 10), _i,
                                                 2, *_site, start)

                    def shift_of(done, alive, _stage=stage):
                        m = torch.clamp(torch.tensor(
                            alive, dtype=torch.int32, device=self.dev), min=1)
                        s = (next(_stage) * m).to(torch.int32)
                        return torch.minimum(s, m - 1)

                    rad, _ = rtrace.trace(spec, tab, o, d, w, u_of,
                                          p["max_iters"],
                                          p["compact_schedule"], shift_of)
                    spectra = rad.reshape(len(chunk), spp, B)
                    sens = torch.ones(len(chunk), device=self.dev)
                    s1, s2 = rtrace.xyz_sums(spectra, cie, delta, sens)
                    flat = chunk[:, 0] * ny + chunk[:, 1]
                    ref_mean, ref_m2, _ = rtrace.fold(
                        mean_b[chunk[:, 0], chunk[:, 1]],
                        m2_b[chunk[:, 0], chunk[:, 1]],
                        n_b[chunk[:, 0], chunk[:, 1]].astype(np.float64),
                        s1.double().cpu().numpy(), s2.double().cpu().numpy(),
                        spp)
                    ma = mean_a.reshape(-1, 3)[flat]
                    mb = mean_b.reshape(-1, 3)[flat]
                    na = n_a.reshape(-1, 3)[flat].astype(np.float64)
                    nb = n_b.reshape(-1, 3)[flat].astype(np.float64)
                    got.append((ma * na - mb * nb) / spp)
                    ref.append(s1.double().cpu().numpy() / spp)
                    got_m2.append(m2_a.reshape(-1, 3)[flat])
                    ref_m2s.append(ref_m2)
                pass_off = max(pass_off, off_pct(np.concatenate(got),
                                                 np.concatenate(ref)))
                fold_off = max(fold_off, off_pct(np.concatenate(got_m2),
                                                 np.concatenate(ref_m2s)))
        lim = self.ctx.limits
        missing = len(set(self.check_passes) - set(self.frames))
        return [("pixels_off_pct", pass_off, lim["pixels_off_pct"]),
                ("fold_off_pct", fold_off, lim["fold_off_pct"]),
                ("samples_off", samples_off, 0),
                ("passes_unchecked", missing, 0)]


TRAFFIC = Observe
