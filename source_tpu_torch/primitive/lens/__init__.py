"""Spherical lens primitives."""

from .spherical import BiConcave, BiConvex, Meniscus, PlanoConcave, PlanoConvex

__all__ = ["BiConvex", "BiConcave", "PlanoConvex", "PlanoConcave", "Meniscus"]
