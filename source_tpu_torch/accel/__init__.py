"""Acceleration structures (reference raysect/core/acceleration)."""

from .bvh import FlatBVH, build_bvh

__all__ = ["FlatBVH", "build_bvh"]
