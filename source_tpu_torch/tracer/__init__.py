from .wavefront import RayConfig, RayState, init_rays, trace_rays

__all__ = ["RayConfig", "RayState", "init_rays", "trace_rays"]
