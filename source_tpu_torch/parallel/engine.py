"""Device entry point for rendering a ray batch.

Counterpart of the reference's render-engine task farm
(raysect/core/workflow.py:123-326): the parallel axis is the ray batch, and
one call traces all of it on one device. Sharded and differentiable entry
points are not part of this package yet.
"""

from __future__ import annotations

import torch

from ..compiler.scene import CompiledScene, resolve_device
from ..tracer.wavefront import RayConfig, init_rays, trace_rays

__all__ = ["render_batch"]


def render_batch(scene: CompiledScene, cfg: RayConfig, origin, direction,
                 generator=None, weight=None, differentiable=False,
                 device="cuda", **trace_kw):
    """Trace a ray batch and return the final RayState: the shared device
    entry point. ``origin``/``direction`` are [N, 3] (tensors or arrays) and
    are moved to ``device``, where the scene must already live. ``trace_kw``
    goes to ``trace_rays`` (``u_all``, ``shifts``, ``span``)."""
    if differentiable:
        raise NotImplementedError(
            "the differentiable tracer (trace_rays_diff) is not part of "
            "this package yet")
    device = resolve_device(device)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(device)
    direction = torch.as_tensor(direction, dtype=torch.float32).to(device)
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32).to(device)
    state = init_rays(origin, direction, scene.bins, weight,
                      spectral_dtype=cfg.spectral_dtype)
    return trace_rays(scene, cfg, state, generator, **trace_kw)
