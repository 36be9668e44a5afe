"""source_tpu_torch — the spectral path tracer on PyTorch and CUDA.

The port of ``source_tpu`` to PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper: the scenegraph compiles to flat SoA device tensors and path
tracing runs as a wavefront. It keeps the directory layout and names of
``source_tpu`` so a reader finds each counterpart.

Covered so far: analytic scenes (CSG included) and triangle meshes with the
built-in materials, the modifiers (Roughen, Blend, Add, VolumeTransform),
user BSDFs, and Beer-Lambert, homogeneous and inhomogeneous volumes.
``compile_scene`` -> ``render_batch``/``trace_rays`` takes the fused route
(one bounce kernel) for simple-entity scenes with built-in materials and the
wavefront route (``trace_step``: the analytic-BVH and mesh kernels, then the
volume and surface stages as tensor programs) for the rest.
``render_loss_and_grads`` -> ``trace_rays_diff`` returns the gradient of an
L2 loss with respect to every float table of the scene on either route (on
the wavefront route by autograd through ``trace_step`` in checkpoint
blocks), and with respect to each mesh's vertices, transform and normals.
The observers and pipelines (``optical.observer``: cameras, sensors, RGB,
power, radiance and spectral pipelines, samplers) drive ``trace_rays``
through ``observe()``, as the reference's users do. The per-ray entry
points answer too: ``World.hit``/``contains`` and ``Primitive.hit``/
``next_intersection``/``contains`` (``core.Ray``, ``core.Intersection``),
``optical.Ray.sample`` and ``optical.LoggingRay``, with the spherical
lenses (``primitive.lens``) and the metal and spectra libraries. Meshes
load from and save to OBJ, STL, PLY, VTK and RSM files
(``primitive.mesh``); the function framework (``core.math.function``:
algebraic fields, array and mesh interpolators) and the samplers
(``core.math.sampler``) evaluate on tensors, on the card by default. Entry
points take ``device=`` and default to ``"cuda"``; they raise if no card is
there.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    AffineMatrix3D, Node, Normal3D, Point2D, Point3D, Quaternion, Vector2D,
    Vector3D, World, translate, rotate, rotate_basis, rotate_vector,
    rotate_x, rotate_y, rotate_z,
)
from .compiler import CompiledScene, SpectralConfig, compile_scene  # noqa: F401
from .tracer.wavefront import (  # noqa: F401
    RayConfig, RayState, init_rays, trace_rays, trace_rays_diff, trace_step,
)
from .tracer.intersect import intersect_scene  # noqa: F401
from .parallel import (  # noqa: F401
    RenderEngine, SerialEngine, render_batch, render_loss_and_grads,
)
from .accel import Accelerator, BoundPrimitive, KDTree, Unaccelerated  # noqa: F401
from .bridge import scene_from_numpy  # noqa: F401

__all__ = [
    "AffineMatrix3D", "Node", "Normal3D", "Point2D", "Point3D", "Quaternion",
    "Vector2D", "Vector3D", "World", "translate", "rotate", "rotate_basis",
    "rotate_vector", "rotate_x", "rotate_y", "rotate_z",
    "CompiledScene", "SpectralConfig", "compile_scene",
    "RayConfig", "RayState", "init_rays", "trace_rays", "trace_rays_diff",
    "trace_step", "intersect_scene",
    "render_batch", "render_loss_and_grads", "RenderEngine", "SerialEngine",
    "Accelerator", "BoundPrimitive", "KDTree", "Unaccelerated",
    "scene_from_numpy",
]
