"""Acceleration structures (reference raysect/core/acceleration)."""

from .bvh import FlatBVH, build_bvh
from .facade import Accelerator, BoundPrimitive, KDTree, Unaccelerated

__all__ = [
    "FlatBVH", "build_bvh",
    "Accelerator", "BoundPrimitive", "KDTree", "Unaccelerated",
]
