"""Device entry points: rendering a ray batch, and the training step.

Counterpart of the reference's render-engine task farm
(raysect/core/workflow.py:123-326): the parallel axis is the ray batch, and
one call traces all of it on one device. ``render_batch`` traces forward
through ``trace_rays`` (the fused route for the scenes it takes, the
wavefront route for the rest: CSG, meshes, modifiers, user BSDFs,
inhomogeneous volumes); with ``differentiable=True`` it traces through
``trace_rays_diff`` on the same route, and the returned radiance carries an
autograd graph to the scene's tensors. ``render_loss_and_grads`` is the
differentiable rendering step: an L2 loss against a target and its gradient
with respect to every float table of the scene, each mesh's tables
included. ``RenderEngine`` and ``SerialEngine`` are the reference's
render-engine contract; an observer runs its tile loop through one, its
``render_engine``. Sharded entry points and engines are not part of this
package yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..compiler.scene import CompiledScene, resolve_device
from ..tracer.fused import TABLE_FIELDS
from ..tracer.wavefront import RayConfig, init_rays, trace_rays, trace_rays_diff

__all__ = ["render_batch", "render_loss_and_grads", "MESH_FIELDS",
           "RenderEngine", "SerialEngine"]

# the float tables of a mesh instance that ``render_loss_and_grads``
# differentiates (MeshTables fields)
MESH_FIELDS = ("vertices", "w2l", "vertex_normals", "face_normals")


def render_batch(scene: CompiledScene, cfg: RayConfig, origin, direction,
                 generator=None, weight=None, differentiable=False,
                 device="cuda", **trace_kw):
    """Trace a ray batch and return the final RayState: the shared device
    entry point. ``origin``/``direction`` are [N, 3] (tensors or arrays) and
    are moved to ``device``, where the scene must already live. ``trace_kw``
    goes to ``trace_rays`` (``u_all``, ``shifts``, ``span``, ``route``,
    ``rng``, ``seeds``), or with ``differentiable`` to ``trace_rays_diff``
    (``u_all``, ``shifts``, ``span``, ``rng``, ``seeds``). Both take the
    fused route for the scenes it accepts and the wavefront route for the
    rest; ``differentiable=True`` runs every bounce (no early exit), on the
    wavefront route in checkpoint blocks of ``cfg.remat_block`` bounces.
    ``rng="kernel"`` has the whole-span kernel draw the bounce uniforms
    itself (Philox, one seed per span from ``generator``) instead of taking a
    host draw; it runs on the fused route's whole-span kernels only and
    raises ``ValueError`` elsewhere (``span="perbounce"``, a scene on the
    wavefront route)."""
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
    importance spheres, mesh geometry).

    Returns ``(loss, grads)``: ``grads`` maps each name of
    ``fused.TABLE_FIELDS`` to a tensor of that field's shape, zeros where the
    trace does not read it. For a scene with triangle meshes,
    ``grads["meshes"]`` holds one dict per mesh slot (``scene.meshes``) of
    the ``MESH_FIELDS`` -- ``vertices``, ``w2l``, ``vertex_normals``,
    ``face_normals`` -- likewise zeros where the trace does not read them;
    the mesh's BVH and the kernel's packed records are constants of the
    geometry. The caller's scene is neither changed nor left requiring
    gradients. ``trace_kw`` goes to ``trace_rays_diff``; with
    ``rng="kernel"`` the step runs the whole-span kernels, which draw their
    uniforms themselves and keep the span's seed for the backward instead of
    its uniforms."""
    device = resolve_device(device)
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in TABLE_FIELDS}
    mesh_leaves = [{f: getattr(m, f).detach().requires_grad_(True)
                    for f in MESH_FIELDS} for m in scene.meshes]
    diff_scene = dataclasses.replace(
        scene, **leaves,
        meshes=tuple(dataclasses.replace(m, **ml)
                     for m, ml in zip(scene.meshes, mesh_leaves)))
    # the spec and the descriptor do not depend on the tensors' values
    diff_scene.fused_cache = scene.fused_cache
    final = render_batch(diff_scene, cfg, origin, direction, generator,
                         differentiable=True, device=device, **trace_kw)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    loss = torch.mean((final.radiance - target) ** 2)
    wrt = list(leaves.values()) + [t for ml in mesh_leaves
                                   for t in ml.values()]
    found = iter(torch.autograd.grad(loss, wrt, allow_unused=True))

    def grad_of(leaf):
        g = next(found)
        return torch.zeros_like(leaf) if g is None else g

    grads = {f: grad_of(leaves[f]) for f in TABLE_FIELDS}
    if scene.meshes:
        grads["meshes"] = [{f: grad_of(ml[f]) for f in MESH_FIELDS}
                           for ml in mesh_leaves]
    return loss.detach(), grads


class RenderEngine:
    """Render-engine strategy contract (reference core/workflow.py:35-97).

    The reference farms picklable (task, render, update) triples to worker
    processes; here an observer hands ``run`` its tiles (``render`` traces a
    tile on the observer's device, ``update`` keeps its device sums), and
    ``worker_count()`` says how many devices an engine spans."""

    def run(self, tasks, render, update, render_args=(), update_args=()):
        raise NotImplementedError

    def worker_count(self):
        raise NotImplementedError


class SerialEngine(RenderEngine):
    """In-order host loop (reference core/workflow.py:100-120): a debugging
    aid and the semantics reference of the engines."""

    def run(self, tasks, render, update, render_args=(), update_args=()):
        for task in tasks:
            update(render(task, *render_args), *update_args)

    def worker_count(self):
        return 1
