"""Device entry points: rendering a ray batch, and the training step.

Counterpart of the reference's render-engine task farm
(raysect/core/workflow.py:123-326): the parallel axis is the ray batch, and
one call traces all of it on one device. ``render_batch`` traces forward
through ``trace_rays`` (the fused route for the scenes it takes, the
wavefront route for the rest, CSG and meshes among them); with ``differentiable=True``
the returned radiance carries an autograd graph to the scene's tensors. ``render_loss_and_grads`` is the differentiable
rendering step: an L2 loss against a target and its gradient with respect to
every float table of the scene. Sharded entry points are not part of this
package yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..compiler.scene import CompiledScene, resolve_device
from ..tracer.fused import TABLE_FIELDS
from ..tracer.wavefront import RayConfig, init_rays, trace_rays, trace_rays_diff

__all__ = ["render_batch", "render_loss_and_grads"]


def render_batch(scene: CompiledScene, cfg: RayConfig, origin, direction,
                 generator=None, weight=None, differentiable=False,
                 device="cuda", **trace_kw):
    """Trace a ray batch and return the final RayState: the shared device
    entry point. ``origin``/``direction`` are [N, 3] (tensors or arrays) and
    are moved to ``device``, where the scene must already live. ``trace_kw``
    goes to ``trace_rays`` (``u_all``, ``shifts``, ``span``, ``route``,
    ``rng``, ``seeds``), or with ``differentiable`` to ``trace_rays_diff``
    (``u_all``, ``shifts``, ``span``, ``rng``, ``seeds``). ``rng="kernel"``
    has the whole-span kernel draw the bounce uniforms itself (Philox, one
    seed per span from ``generator``) instead of taking a host draw; it runs
    on the fused route's whole-span kernels only and raises ``ValueError``
    elsewhere (``span="perbounce"``, a scene on the wavefront route)."""
    device = resolve_device(device)
    origin = torch.as_tensor(origin, dtype=torch.float32).to(device)
    direction = torch.as_tensor(direction, dtype=torch.float32).to(device)
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32).to(device)
    state = init_rays(origin, direction, scene.bins, weight,
                      spectral_dtype=cfg.spectral_dtype)
    tracer = trace_rays_diff if differentiable else trace_rays
    return tracer(scene, cfg, state, generator, **trace_kw)


def render_loss_and_grads(scene: CompiledScene, cfg: RayConfig, origin,
                          direction, target, generator=None, device="cuda",
                          **trace_kw):
    """Differentiable-rendering training step: the L2 loss
    ``mean((radiance - target)**2)`` between the traced per-ray spectra and
    ``target`` [N, B], and its gradient with respect to every float table of
    the scene (geometry transforms, primitive parameters, material tables,
    importance spheres).

    Returns ``(loss, grads)``: ``grads`` maps each name of
    ``fused.TABLE_FIELDS`` to a tensor of that field's shape, zeros where the
    trace does not read it. The caller's scene is neither changed nor left
    requiring gradients. ``trace_kw`` goes to ``trace_rays_diff``; with
    ``rng="kernel"`` the step runs the whole-span kernels, which draw their
    uniforms themselves and keep the span's seed for the backward instead of
    its uniforms."""
    device = resolve_device(device)
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in TABLE_FIELDS}
    diff_scene = dataclasses.replace(scene, **leaves)
    # the spec and the descriptor do not depend on the tensors' values
    diff_scene.fused_cache = scene.fused_cache
    final = render_batch(diff_scene, cfg, origin, direction, generator,
                         differentiable=True, device=device, **trace_kw)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    loss = torch.mean((final.radiance - target) ** 2)
    found = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {f: torch.zeros_like(leaves[f]) if g is None else g
             for f, g in zip(TABLE_FIELDS, found)}
    return loss.detach(), grads
