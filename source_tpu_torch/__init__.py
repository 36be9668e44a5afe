"""source_tpu_torch — the spectral path tracer on PyTorch and CUDA.

The port of ``source_tpu`` to PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper: the scenegraph compiles to flat SoA device tensors and path
tracing runs as a fused wavefront kernel. It keeps the directory layout and
names of ``source_tpu`` so a reader finds each counterpart.

Covered so far: the forward fused trace of all-analytic scenes (the six
solids, the built-in materials, Beer-Lambert and homogeneous volumes)
through ``compile_scene`` -> ``render_batch``/``trace_rays``. Entry points
take ``device=`` and default to ``"cuda"``; they raise if no card is there.
Everything else raises ``NotImplementedError``.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    AffineMatrix3D, Node, Normal3D, Point2D, Point3D, Vector2D,
    Vector3D, World, translate, rotate, rotate_basis, rotate_vector,
    rotate_x, rotate_y, rotate_z,
)
from .compiler import CompiledScene, SpectralConfig, compile_scene  # noqa: F401
from .tracer.wavefront import RayConfig, RayState, init_rays, trace_rays  # noqa: F401
from .parallel import render_batch  # noqa: F401
from .bridge import scene_from_numpy  # noqa: F401

__all__ = [
    "AffineMatrix3D", "Node", "Normal3D", "Point2D", "Point3D",
    "Vector2D", "Vector3D", "World", "translate", "rotate", "rotate_basis",
    "rotate_vector", "rotate_x", "rotate_y", "rotate_z",
    "CompiledScene", "SpectralConfig", "compile_scene",
    "RayConfig", "RayState", "init_rays", "trace_rays", "render_batch",
    "scene_from_numpy",
]
