"""Accelerator facade (reference core/acceleration/*.pyx).

Counterpart of source_tpu/accel/facade.py. The reference exposes a pluggable
host-side accelerator: ``Accelerator`` (accelerator.pyx:32-40,
build/hit/contains), ``BoundPrimitive`` (boundprimitive.pyx:34, primitive +
world-space AABB pre-test), ``KDTree`` (kdtree.pyx:165-180) and
``Unaccelerated`` (unaccelerated.pyx:41-105).

Here the accelerator is scene compilation: analytic and CSG leaves are
walked by the analytic-BVH kernel and meshes by the mesh kernel. These
classes keep the reference's interactive host-query contract: ``build``
compiles the world's query scene on the accelerator's ``device`` (the card
unless it was made with ``device="cpu"``), and ``hit``/``contains`` answer
through ``World.hit``/``contains`` there, one kernel launch a query.
``KDTree`` and ``Unaccelerated`` therefore share one code path.
"""

from __future__ import annotations

__all__ = ["Accelerator", "BoundPrimitive", "KDTree", "Unaccelerated"]


class Accelerator:
    """Abstract accelerator contract (accelerator.pyx:32-40)."""

    def build(self, world, force=False):
        """Prepare the acceleration structure for ``world``'s primitives."""
        raise NotImplementedError

    def hit(self, ray):
        """Closest Intersection of ``ray`` with the built scene, or None."""
        raise NotImplementedError

    def contains(self, point):
        """List of primitives containing ``point``."""
        raise NotImplementedError


class BoundPrimitive:
    """A primitive paired with its world-space AABB (boundprimitive.pyx:34).

    The box is the cheap pre-test: ``box_hit(ray)`` runs the slab test
    before any primitive-level query is attempted."""

    def __init__(self, primitive):
        from ..core.boundingbox import BoundingBox3D
        from ..core.math.vector import Point3D

        self.primitive = primitive
        lower, upper = primitive.bounding_box()
        self.box = BoundingBox3D(Point3D(*lower), Point3D(*upper))

    def box_hit(self, ray):
        """Slab test of ``ray`` against the primitive's world AABB."""
        hit, _, _ = self.box.hit(ray.origin, ray.direction)
        return hit

    def contains(self, point):
        return self.box.contains(point)


class _CompiledSceneAccelerator(Accelerator):
    """Shared implementation: the scene compile is the build step."""

    def __init__(self, device="cuda"):
        self.device = device
        self._world = None

    def build(self, world, force=False):
        world.build_accelerator(force=force, device=self.device)
        self._world = world
        self.bound_primitives = [BoundPrimitive(p) for p in world.primitives]

    def _built(self):
        if self._world is None:
            raise RuntimeError("Accelerator not built: call build(world).")
        return self._world

    def hit(self, ray):
        return self._built().hit(ray, device=self.device)

    def contains(self, point):
        return self._built().contains(point, device=self.device)


class KDTree(_CompiledSceneAccelerator):
    """Default accelerator name kept from the reference (kdtree.pyx:165): the
    per-query tree walk is the compiled scene's BVH kernels."""


class Unaccelerated(_CompiledSceneAccelerator):
    """Reference/debug linear-scan accelerator (unaccelerated.pyx:41), kept
    as a distinct type for API parity; the compiled-scene query answers for
    it."""
