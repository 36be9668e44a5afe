from .intersect import HitRecord, intersect_scene, entity_contains
from .wavefront import (
    RayConfig, RayState, init_rays, trace_rays, trace_rays_diff, trace_step,
)

__all__ = [
    "HitRecord", "intersect_scene", "entity_contains",
    "RayConfig", "RayState", "init_rays", "trace_rays", "trace_rays_diff",
    "trace_step",
]
