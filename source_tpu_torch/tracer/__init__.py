from .wavefront import RayConfig, RayState, init_rays, trace_rays, trace_step

__all__ = ["RayConfig", "RayState", "init_rays", "trace_rays", "trace_step"]
