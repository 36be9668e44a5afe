"""LoggingRay: trajectory-recording trace for visualisation/debugging.

Counterpart of raysect/optical/loggingray.pyx:45-202 (records every
intersection along a path). The wavefront analogue records the whole ray
*batch* at once via ``trace_rays_logged``; this wrapper mirrors the
reference's single-ray API — construct with origin/direction, call
``trace(world)``, read ``path_vertices`` / ``log``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LoggingRay"]


class LoggingRay:
    """Single-ray path logger (optical/loggingray.pyx:45)."""

    def __init__(self, origin=None, direction=None, min_wavelength=375.0,
                 max_wavelength=740.0, bins=15, max_depth=32, seed=0):
        def as3(v, default):
            if v is None:
                return np.asarray(default, np.float32)
            if hasattr(v, "x"):
                return np.asarray([v.x, v.y, v.z], np.float32)
            return np.asarray(list(v), np.float32)

        self.origin = as3(origin, (0.0, 0.0, 0.0))
        self.direction = as3(direction, (0.0, 0.0, 1.0))
        self.min_wavelength = float(min_wavelength)
        self.max_wavelength = float(max_wavelength)
        self.bins = int(bins)
        self.max_depth = int(max_depth)
        self.seed = int(seed)
        self.log = None
        self.path_vertices = []
        self.path_intersections = []

    def trace(self, world, device="cuda", u_all=None):
        """Trace through the world on ``device`` (the card by default; it
        raises without one), recording the trajectory. Returns the per-bin
        spectrum of the traced path. Afterwards ``path_vertices`` holds the
        geometric polyline and ``path_intersections`` the full per-vertex
        records — entity/material ids, world normal, exiting flag,
        throughput at the segment start — mirroring the reference's stored
        Intersection objects (loggingray.pyx:45-202).

        The bounce uniforms come from a ``torch.Generator`` on the device
        seeded by ``seed``; ``u_all`` injects them instead, as
        ``trace_rays_logged`` takes it. The log stays on the device until
        the trace ends and is pulled once."""
        from ..compiler.scene import SpectralConfig, compile_scene
        from ..tracer.wavefront import (
            RayConfig, init_rays, reconstruct_trajectories, trace_rays_logged,
        )

        scene = compile_scene(
            world, SpectralConfig(self.min_wavelength, self.max_wavelength,
                                  self.bins), device=device)
        dev = scene.device
        cfg = RayConfig(
            max_depth=self.max_depth, extinction_prob=0.0,
            max_iters=self.max_depth,
        )
        state = init_rays(
            torch.from_numpy(self.origin)[None, :].to(dev),
            torch.from_numpy(self.direction)[None, :].to(dev), self.bins,
        )
        generator = torch.Generator(device=dev).manual_seed(self.seed)
        final, log = trace_rays_logged(scene, cfg, state, generator,
                                       u_all=u_all)
        full = {k: v.cpu().numpy() for k, v in log.items()}
        self.log = {k: v[:, 0] for k, v in full.items()}
        self.path_intersections = reconstruct_trajectories(full)[0]
        # path vertices: launch point + every recorded hit while alive
        verts = [self.log["origin"][0]]
        verts += [rec["hit_point"] for rec in self.path_intersections]
        self.path_vertices = [tuple(map(float, v)) for v in verts]
        return final.radiance[0].cpu().numpy()
