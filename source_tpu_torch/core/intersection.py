"""Host-side Intersection record (reference raysect/core/intersection.pyx:35-115).

Returned by ``World.hit(ray)`` for interactive scene queries. The device
compute path uses the SoA ``tracer.intersect.HitRecord`` instead; this class
carries the same fields in the reference's object form, including the
epsilon-displaced inside/outside relaunch points (intersection.pyx:45-50).
"""

from __future__ import annotations

__all__ = ["Intersection"]


class Intersection:
    """Ray-primitive intersection description.

    :param ray: the intersecting Ray
    :param ray_distance: parametric distance to the hit
    :param primitive: the hit Primitive node
    :param hit_point: hit point in primitive local space
    :param inside_point: epsilon-displaced relaunch point just inside the
        surface (local space)
    :param outside_point: epsilon-displaced relaunch point just outside the
        surface (local space)
    :param normal: outward surface normal at the hit (local space, unit)
    :param exiting: True if the ray was travelling from inside the primitive
    :param world_to_primitive / primitive_to_world: AffineMatrix3D transforms
    """

    def __init__(self, ray, ray_distance, primitive, hit_point, inside_point,
                 outside_point, normal, exiting, world_to_primitive,
                 primitive_to_world):
        self.ray = ray
        self.ray_distance = ray_distance
        self.primitive = primitive
        self.hit_point = hit_point
        self.inside_point = inside_point
        self.outside_point = outside_point
        self.normal = normal
        self.exiting = exiting
        self.world_to_primitive = world_to_primitive
        self.primitive_to_world = primitive_to_world

    def __repr__(self):
        return (
            f"Intersection({self.primitive!r}, t={self.ray_distance:.6g}, "
            f"exiting={self.exiting})"
        )
