"""Spherical lens primitives: BiConvex, BiConcave, PlanoConvex,
PlanoConcave, Meniscus.

Counterparts of raysect/primitive/lens/spherical.pyx:46-626. Each lens is a
CSG assembly of spheres and a cylindrical barrel wrapped in an
EncapsulatedPrimitive; the barrel axis is +z with the back surface at z=0.
The sphere/cylinder geometry compiles to the batched analytic kernels, so
lenses trace and differentiate like any other CSG entity.
"""

from __future__ import annotations

import math

from ...core.math.transform import translate
from ..csg import Intersect, Subtract, Union
from ..shapes import Cylinder, Sphere
from ..utility import EncapsulatedPrimitive

__all__ = ["BiConvex", "BiConcave", "PlanoConvex", "PlanoConcave", "Meniscus"]

_PADDING = 1e-6  # barrel padding factor (spherical.pyx:43)


def _sag(curvature, radius):
    """Sagitta of a spherical cap of the given curvature over the barrel
    radius."""
    return curvature - math.sqrt(curvature * curvature - radius * radius)


def _validate(diameter, center_thickness, *curvatures):
    if diameter <= 0:
        raise ValueError("The lens diameter must be greater than zero.")
    if center_thickness <= 0:
        raise ValueError("The lens thickness must be greater than zero.")
    radius = 0.5 * diameter
    for c in curvatures:
        if c < radius:
            raise ValueError(
                "The radius of curvature cannot be less than the barrel radius."
            )
    return radius


class BiConvex(EncapsulatedPrimitive):
    """Bi-convex spherical lens (spherical.pyx:46): two convex surfaces on a
    cylindrical barrel; back surface centre at z=0, lens extends along +z."""

    def __init__(self, diameter, center_thickness, front_curvature,
                 back_curvature, parent=None, transform=None, material=None,
                 name=None):
        radius = _validate(diameter, center_thickness, front_curvature, back_curvature)
        self.diameter = float(diameter)
        self.center_thickness = float(center_thickness)
        self.front_curvature = float(front_curvature)
        self.back_curvature = float(back_curvature)
        self.front_thickness = _sag(front_curvature, radius)
        self.back_thickness = _sag(back_curvature, radius)
        self.edge_thickness = (
            center_thickness - (self.front_thickness + self.back_thickness)
        )
        if self.edge_thickness < 0:
            raise ValueError(
                "The curvatures and/or thickness are too small to produce a "
                "lens of the specified diameter."
            )

        pad = center_thickness * _PADDING
        front = Sphere(front_curvature,
                       transform=translate(0, 0, center_thickness - front_curvature))
        back = Sphere(back_curvature, transform=translate(0, 0, back_curvature))
        # short lens: facing spheres overlap enough for a pure intersection
        available = min(
            2 * (front_curvature - self.front_thickness),
            2 * (back_curvature - self.back_thickness),
        )
        if self.edge_thickness <= available:
            barrel = Cylinder(radius, center_thickness + 2 * pad,
                              transform=translate(0, 0, -pad))
            lens = Intersect(barrel, Intersect(front, back))
        else:
            front_barrel = Cylinder(
                radius, self.front_thickness + 2 * pad,
                transform=translate(0, 0, self.back_thickness + self.edge_thickness - pad),
            )
            back_barrel = Cylinder(radius, self.back_thickness + 2 * pad,
                                   transform=translate(0, 0, -pad))
            barrel = Cylinder(radius, self.edge_thickness,
                              transform=translate(0, 0, self.back_thickness))
            lens = Union(barrel, Union(Intersect(front, front_barrel),
                                       Intersect(back, back_barrel)))
        super().__init__(lens, parent, transform, material, name)

    def instance(self, parent=None, transform=None, material=None, name=None):
        return BiConvex(self.diameter, self.center_thickness,
                        self.front_curvature, self.back_curvature, parent,
                        transform, material or self.material, name)


class BiConcave(EncapsulatedPrimitive):
    """Bi-concave spherical lens (spherical.pyx:183)."""

    def __init__(self, diameter, center_thickness, front_curvature,
                 back_curvature, parent=None, transform=None, material=None,
                 name=None):
        radius = _validate(diameter, center_thickness, front_curvature, back_curvature)
        self.diameter = float(diameter)
        self.center_thickness = float(center_thickness)
        self.front_curvature = float(front_curvature)
        self.back_curvature = float(back_curvature)
        self.front_thickness = _sag(front_curvature, radius)
        self.back_thickness = _sag(back_curvature, radius)
        self.edge_thickness = (
            center_thickness + self.front_thickness + self.back_thickness
        )

        front = Sphere(front_curvature,
                       transform=translate(0, 0, center_thickness + front_curvature))
        back = Sphere(back_curvature, transform=translate(0, 0, -back_curvature))
        barrel = Cylinder(radius, self.edge_thickness,
                          transform=translate(0, 0, -self.back_thickness))
        lens = Subtract(Subtract(barrel, front), back)
        super().__init__(lens, parent, transform, material, name)

    def instance(self, parent=None, transform=None, material=None, name=None):
        return BiConcave(self.diameter, self.center_thickness,
                         self.front_curvature, self.back_curvature, parent,
                         transform, material or self.material, name)


class PlanoConvex(EncapsulatedPrimitive):
    """Plano-convex spherical lens (spherical.pyx:388): plane back surface on
    z=0, convex front surface along +z."""

    def __init__(self, diameter, center_thickness, curvature, parent=None,
                 transform=None, material=None, name=None):
        radius = _validate(diameter, center_thickness, curvature)
        self.diameter = float(diameter)
        self.center_thickness = float(center_thickness)
        self.curvature = float(curvature)
        self.curve_thickness = _sag(curvature, radius)
        self.edge_thickness = center_thickness - self.curve_thickness
        if self.edge_thickness < 0:
            raise ValueError(
                "The curvature and/or thickness is too small to produce a "
                "lens of the specified diameter."
            )

        pad = center_thickness * _PADDING
        front = Sphere(curvature,
                       transform=translate(0, 0, center_thickness - curvature))
        if self.edge_thickness <= 2 * (curvature - self.curve_thickness):
            barrel = Cylinder(radius, center_thickness + pad)
            lens = Intersect(barrel, front)
        else:
            curved_barrel = Cylinder(
                radius, self.curve_thickness + 2 * pad,
                transform=translate(0, 0, self.edge_thickness - pad),
            )
            barrel = Cylinder(radius, self.edge_thickness)
            lens = Union(barrel, Intersect(front, curved_barrel))
        super().__init__(lens, parent, transform, material, name)

    def instance(self, parent=None, transform=None, material=None, name=None):
        return PlanoConvex(self.diameter, self.center_thickness, self.curvature,
                           parent, transform, material or self.material, name)


class PlanoConcave(EncapsulatedPrimitive):
    """Plano-concave spherical lens (spherical.pyx:389-466)."""

    def __init__(self, diameter, center_thickness, curvature, parent=None,
                 transform=None, material=None, name=None):
        radius = _validate(diameter, center_thickness, curvature)
        self.diameter = float(diameter)
        self.center_thickness = float(center_thickness)
        self.curvature = float(curvature)
        self.curve_thickness = _sag(curvature, radius)
        self.edge_thickness = center_thickness + self.curve_thickness

        curve = Sphere(curvature,
                       transform=translate(0, 0, center_thickness + curvature))
        barrel = Cylinder(radius, self.edge_thickness)
        lens = Subtract(barrel, curve)
        super().__init__(lens, parent, transform, material, name)

    def instance(self, parent=None, transform=None, material=None, name=None):
        return PlanoConcave(self.diameter, self.center_thickness, self.curvature,
                            parent, transform, material or self.material, name)


class Meniscus(EncapsulatedPrimitive):
    """Meniscus spherical lens (spherical.pyx:466): concave back at z=0,
    convex front along +z."""

    def __init__(self, diameter, center_thickness, front_curvature,
                 back_curvature, parent=None, transform=None, material=None,
                 name=None):
        radius = _validate(diameter, center_thickness, front_curvature, back_curvature)
        self.diameter = float(diameter)
        self.center_thickness = float(center_thickness)
        self.front_curvature = float(front_curvature)
        self.back_curvature = float(back_curvature)
        self.front_thickness = _sag(front_curvature, radius)
        self.back_thickness = _sag(back_curvature, radius)
        self.edge_thickness = (
            center_thickness - self.front_thickness + self.back_thickness
        )
        if self.edge_thickness < 0:
            raise ValueError(
                "The curvatures and/or thickness are not compatible with the "
                "specified diameter."
            )

        pad = (self.back_thickness + center_thickness) * _PADDING
        front = Sphere(front_curvature,
                       transform=translate(0, 0, center_thickness - front_curvature))
        back = Sphere(back_curvature, transform=translate(0, 0, -back_curvature))
        available = 2 * front_curvature - self.front_thickness
        if (center_thickness + self.back_thickness) <= available:
            barrel = Cylinder(
                radius, self.back_thickness + center_thickness + pad,
                transform=translate(0, 0, -self.back_thickness),
            )
            lens = Subtract(Intersect(barrel, front), back)
        else:
            front_barrel = Cylinder(
                radius, self.front_thickness + 2 * pad,
                transform=translate(0, 0, center_thickness - self.front_thickness - pad),
            )
            barrel = Cylinder(radius, self.edge_thickness,
                              transform=translate(0, 0, -self.back_thickness))
            lens = Subtract(Union(barrel, Intersect(front, front_barrel)), back)
        super().__init__(lens, parent, transform, material, name)

    def instance(self, parent=None, transform=None, material=None, name=None):
        return Meniscus(self.diameter, self.center_thickness,
                        self.front_curvature, self.back_curvature, parent,
                        transform, material or self.material, name)
