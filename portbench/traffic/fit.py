"""Traffic ``fit``: the differentiable rendering step, back to back.

Each call is one ``render_loss_and_grads`` of the cell's ray batch against
a fixed spectral target made in set-up from the seed, with a fresh stream
of bounce uniforms a step (handed to the port through its ``u_all`` hook,
drawn on the device as the port's own host stream would be). Nothing is
read back inside the window. ``fit_rays_per_s`` is the rays of every step
over the window, which ends in a synchronise. The check follows the first
step and steps drawn from the seed: the loss and every table's gradient
against the reference's autograd of the plain bounce.
"""

from __future__ import annotations

import torch

from portbench import scene as S
from portbench.reference import tables as rtables
from portbench.reference import trace as rtrace
from portbench.traffic.common import (
    Traffic, grid_rays, sampled, worst_field_gap,
)


class Fit(Traffic):

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
        g = torch.Generator(device=self.dev)
        g.manual_seed(self.streams.seed)
        self.target = torch.rand((self.n, sp["bins"]), generator=g,
                                 device=self.dev) * self.p["target_scale"]
        self.check_steps = sampled(self.ctx.seed, self.p["check_steps"],
                                   self.p["check_below"], 17)
        self.call(-1)          # the warm-up step, at the cell's shapes
        self.sync()
        self.kept.clear()

    def call(self, i):
        loss, grads = self.engine.render_loss_and_grads(
            self.scene, self.rcfg, self.o, self.d, self.target,
            u_all=self.streams.bounce_u(i), device=self.dev)
        return loss, grads

    def step(self, i):
        out = self.call(i)
        if i in self.check_steps:
            self.kept[i] = out

    def e2e(self, calls, seconds, times):
        self.calls = calls
        return {"fit_rays_per_s": calls * self.n / seconds}

    def spans(self):
        import source_tpu_torch.parallel.engine as eng
        import source_tpu_torch.tracer.wavefront as wf
        return [(eng, "render_loss_and_grads", "fit.step"),
                (eng, "render_batch", "fit.forward"),
                (wf, "trace_rays_diff", "fit.trace_rays_diff"),
                (torch.autograd, "grad", "fit.autograd_grad")]

    def counts(self):
        """Segments of the window's steps, from the port's own counter: a
        forward ``render_batch`` of each step's uniforms (every ``stride``
        th step), after the window."""
        stride = max(1, self.calls // self.p["count_samples"])
        segs = []
        with torch.no_grad():
            for i in range(0, self.calls, stride):
                st = self.engine.render_batch(
                    self.scene, self.rcfg, self.o, self.d,
                    u_all=self.streams.bounce_u(i), device=self.dev)
                segs.append(st.segments)
        mean = float(torch.stack(segs).double().mean())
        return {"calls": self.calls, "lanes": self.n,
                "segments": mean * self.calls, "span_launches": self.calls}

    def release(self):
        self.scene = None
        self.kept = {i: (float(loss), {f: g.detach().cpu()
                                       for f, g in grads.items()})
                     for i, (loss, grads) in self.kept.items()}

    def check(self):
        cfg = self.ctx.config
        tabs, spec = rtables.compile_config(cfg, device=self.dev)
        worst_loss, worst_grad = 0.0, 0.0
        for i in sorted(self.kept):
            loss, grads = self.kept[i]
            u = self.streams.bounce_u(i)(0, self.p["max_iters"], self.n)
            ref_loss, ref_grads = rtrace.loss_and_grads(
                tabs, spec, self.o, self.d, self.target, u,
                block=self.p["reference_block"])
            worst_loss = max(worst_loss, abs(loss - ref_loss) / ref_loss)
            g = worst_field_gap(
                {f: grads[f] for f in rtables.TABLE_FIELDS},
                {f: ref_grads[f].cpu() for f in rtables.TABLE_FIELDS})
            worst_grad = max(worst_grad, g)
            del u, ref_grads
        lim = self.ctx.limits
        missing = len(set(self.check_steps) - set(self.kept))
        return [("loss_gap", worst_loss, lim["loss_gap"]),
                ("grad_gap", worst_grad, lim["grad_gap"]),
                ("steps_unchecked", missing, 0)]


TRAFFIC = Fit
