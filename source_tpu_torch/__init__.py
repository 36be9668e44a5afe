"""source_tpu_torch — the spectral path tracer on PyTorch and CUDA.

The port of ``source_tpu`` to PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper: the scenegraph compiles to flat SoA device tensors and path
tracing runs as a wavefront. It keeps the directory layout and names of
``source_tpu`` so a reader finds each counterpart.

Covered so far: analytic scenes and triangle meshes with built-in
materials, Beer-Lambert and homogeneous volumes. Forward, ``compile_scene``
-> ``render_batch``/``trace_rays`` takes the fused route (one bounce kernel)
for simple-entity scenes and the wavefront route (``trace_step``: the
analytic-BVH and mesh kernels, then the volume and surface stages as tensor
programs) for the rest, CSG and meshes among them. Differentiable, ``render_loss_and_grads`` -> ``trace_rays_diff``
returns the gradient of an L2 loss with respect to every float table of a
scene the fused route takes. Entry points take ``device=`` and default to
``"cuda"``; they raise if no card is there. Custom BSDFs, modifiers,
inhomogeneous volumes and the differentiable wavefront route raise
``NotImplementedError``.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    AffineMatrix3D, Node, Normal3D, Point2D, Point3D, Vector2D,
    Vector3D, World, translate, rotate, rotate_basis, rotate_vector,
    rotate_x, rotate_y, rotate_z,
)
from .compiler import CompiledScene, SpectralConfig, compile_scene  # noqa: F401
from .tracer.wavefront import (  # noqa: F401
    RayConfig, RayState, init_rays, trace_rays, trace_rays_diff, trace_step,
)
from .parallel import render_batch, render_loss_and_grads  # noqa: F401
from .bridge import scene_from_numpy  # noqa: F401

__all__ = [
    "AffineMatrix3D", "Node", "Normal3D", "Point2D", "Point3D",
    "Vector2D", "Vector3D", "World", "translate", "rotate", "rotate_basis",
    "rotate_vector", "rotate_x", "rotate_y", "rotate_z",
    "CompiledScene", "SpectralConfig", "compile_scene",
    "RayConfig", "RayState", "init_rays", "trace_rays", "trace_rays_diff",
    "trace_step",
    "render_batch", "render_loss_and_grads",
    "scene_from_numpy",
]
