"""Traffic ``render``: the batch entry point ``render_batch``, forward
only, back to back.

Each call traces the cell's ray batch with a fresh stream of bounce
uniforms (through the port's ``u_all`` hook, drawn on the device as the
port's own host stream would be). It bypasses the observer. Nothing is
read back inside the window; ``render_rays_per_s`` is the rays of every
call over the window, which ends in a synchronise. The check compares the
final radiance of the first call and of calls drawn from the seed, every
ray and bin, with the plain reference's trace of the same uniforms: the
share of rays with a bin off (``common.off_pct``).
"""

from __future__ import annotations

import torch

from portbench import scene as S
from portbench.reference import tables as rtables
from portbench.reference import trace as rtrace
from portbench.traffic.common import Traffic, grid_rays, off_pct, sampled


class Render(Traffic):

    def setup(self):
        import source_tpu_torch as T
        from source_tpu_torch.parallel import engine

        self.engine = engine
        cfg = self.ctx.config
        sp = cfg["spectral"]
        self.scene = T.compile_scene(
            S.build_world(cfg), T.SpectralConfig(
                sp["min_wavelength"], sp["max_wavelength"], sp["bins"]),
            device=self.dev)
        self.rcfg = S.ray_config(T, cfg, self.p["max_iters"],
                                 spectral_dtype=self.ctx.precision)
        self.o, self.d = grid_rays(self.p["rays"], self.dev)
        self.n = self.o.shape[0]
        self.check_calls = sampled(self.ctx.seed, self.p["check_calls"],
                                   self.p["check_below"], 23)
        self.segments = []
        self.call(-1)          # the warm-up call, at the cell's shapes
        self.sync()

    def call(self, i):
        return self.engine.render_batch(
            self.scene, self.rcfg, self.o, self.d,
            u_all=self.streams.bounce_u(i), device=self.dev)

    def step(self, i):
        st = self.call(i)
        if self.ctx.trace:
            self.segments.append(st.segments)
        if i in self.check_calls:
            self.kept[i] = st.radiance

    def e2e(self, calls, seconds, times):
        self.calls = calls
        return {"render_rays_per_s": calls * self.n / seconds}

    def spans(self):
        import source_tpu_torch.parallel.engine as eng
        import source_tpu_torch.tracer.wavefront as wf
        return [(eng, "render_batch", "render.call"),
                (eng, "trace_rays", "render.trace_rays"),
                (wf.fused, "fused_forward_span", "render.span")]

    def counts(self):
        segs = float(torch.stack(self.segments).double().sum())
        return {"calls": self.calls, "lanes": self.n, "segments": segs,
                "span_launches": self.calls}

    def release(self):
        self.scene = None
        self.segments = []

    def check(self):
        tabs, spec = rtables.compile_config(self.ctx.config, device=self.dev)
        with torch.no_grad():
            tab = rtrace.rb.pack_tabvec(tabs, spec)
            worst = 0.0
            for i in sorted(self.kept):
                u_all = self.streams.bounce_u(i)
                ref, _ = rtrace.trace(spec, tab, self.o, self.d, None, u_all,
                                      self.p["max_iters"])
                got = self.kept[i].to(torch.float32)
                worst = max(worst, off_pct(got.cpu().numpy(),
                                           ref.cpu().numpy()))
        missing = len(set(self.check_calls) - set(self.kept))
        return [("rays_off_pct", worst, self.ctx.limits["rays_off_pct"]),
                ("calls_unchecked", missing, 0)]


TRAFFIC = Render
