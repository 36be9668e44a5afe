"""Geometry primitives (reference raysect/primitive)."""

from .shapes import Sphere, Box, Cylinder, Cone, Parabola, Torus

__all__ = ["Sphere", "Box", "Cylinder", "Cone", "Parabola", "Torus"]
