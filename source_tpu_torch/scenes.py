"""Stock scenes and ray batches for smoke runs and tests.

``cornell_box`` is the glass Cornell box of the reference's
demos/cornell_box.py (measured wall reflectivities and light spectrum, a
glass box and a glass sphere); ``zoo`` holds every other built-in material
and all six solids; ``furnace`` is the exact-answer check: inside a unit
emitter every ray returns radiance 1 in every bin.
"""

from __future__ import annotations

import numpy as np

from .core import Point3D, rotate, rotate_x, translate
from .core.scenegraph import Node, World
from .optical import InterpolatedSF
from .optical.library import schott
from .optical.material import (
    AbsorbingSurface, AnisotropicSurfaceEmitter, Checkerboard, Conductor,
    Lambert, NullSurface, PerfectReflectingSurface, RoughConductor,
    UniformSurfaceEmitter, UniformVolumeEmitter, UnitySurfaceEmitter,
)
from .primitive import Box, Cone, Cylinder, Parabola, Sphere, Torus

__all__ = ["cornell_box", "zoo", "furnace", "pinhole_rays", "scatter_rays"]


def cornell_box(glass=True):
    """The Cornell box World: 5 walls, the ceiling light, a box and a sphere
    (Schott N-BK7 when ``glass``, else white Lambert)."""
    # measured Cornell-box wall reflectivities (public data,
    # graphics.cornell.edu/online/box/data.html), decimated to 20 nm
    wavelengths = np.arange(400, 701, 20)
    white = np.array([0.343, 0.665, 0.745, 0.751, 0.748, 0.753, 0.735,
                      0.725, 0.732, 0.733, 0.754, 0.734, 0.755, 0.744,
                      0.712, 0.727])[: len(wavelengths)]
    green = np.array([0.092, 0.098, 0.097, 0.107, 0.125, 0.229, 0.472,
                      0.481, 0.447, 0.373, 0.337, 0.266, 0.186, 0.141,
                      0.123, 0.114])[: len(wavelengths)]
    red = np.array([0.040, 0.049, 0.057, 0.062, 0.060, 0.058, 0.057,
                    0.059, 0.061, 0.067, 0.090, 0.255, 0.402, 0.487,
                    0.620, 0.609])[: len(wavelengths)]

    white_reflectivity = InterpolatedSF(wavelengths, white)
    red_reflectivity = InterpolatedSF(wavelengths, red)
    green_reflectivity = InterpolatedSF(wavelengths, green)
    light_spectrum = InterpolatedSF([400, 500, 600, 700], [0.0, 8.0, 15.6, 18.4])

    world = World()
    enclosure = Node(world)

    # enclosing box walls (unit panels transformed like the reference demo)
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, 0, 1) * rotate(0, 0, 0),
        material=Lambert(white_reflectivity), name="back")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, -1, 0) * rotate(0, -90, 0),
        material=Lambert(white_reflectivity), name="floor")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(0, 1, 0) * rotate(0, 90, 0),
        material=Lambert(white_reflectivity), name="ceiling")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(1, 0, 0) * rotate(-90, 0, 0),
        material=Lambert(red_reflectivity), name="left")
    Box(Point3D(-1, -1, 0), Point3D(1, 1, 0), parent=enclosure,
        transform=translate(-1, 0, 0) * rotate(90, 0, 0),
        material=Lambert(green_reflectivity), name="right")

    # ceiling light
    Box(Point3D(-0.4, -0.4, -0.01), Point3D(0.4, 0.4, 0.0), parent=enclosure,
        transform=translate(0, 1, 0) * rotate(0, 90, 0),
        material=UniformSurfaceEmitter(light_spectrum, 2), name="light")

    # objects
    if glass:
        box_mat = schott("N-BK7")
        sphere_mat = schott("N-BK7")
    else:
        box_mat = Lambert(white_reflectivity)
        sphere_mat = Lambert(white_reflectivity)
    Box(Point3D(-0.4, 0, -0.4), Point3D(0.3, 1.4, 0.3), parent=world,
        transform=translate(0.4, -1 + 1e-6, 0.4) * rotate(30, 0, 0),
        material=box_mat, name="glass box")
    Sphere(0.4, parent=world,
           transform=translate(-0.4, -0.6 + 1e-6, -0.4) * rotate(0, 0, 0),
           material=sphere_mat, name="glass sphere")
    return world


def zoo():
    """Every built-in material the Cornell box lacks, on all six solids, with
    an emitting slab so paths can end with radiance."""
    w = World()
    ns = InterpolatedSF([400, 700], [1.2, 1.1])
    ks = InterpolatedSF([400, 700], [5.0, 4.0])
    spec = InterpolatedSF([400, 700], [1.0, 3.0])
    mats = [
        Conductor(ns, ks),
        RoughConductor(ns, ks, 0.3),
        AnisotropicSurfaceEmitter(spec, 1.0, 2.0),
        Checkerboard(0.3, spec, InterpolatedSF([400, 700], [3.0, 1.0]), 1.0),
        PerfectReflectingSurface(),
        NullSurface(),
        AbsorbingSurface(),
        UniformVolumeEmitter(spec, 0.7),
        Lambert(InterpolatedSF([400, 700], [0.4, 0.6])),
    ]
    rng = np.random.RandomState(5)
    for i, mat in enumerate(mats):
        x, y, z = rng.uniform(-2.0, 2.0, 3)
        t = translate(x, y, z) * rotate_x(float(rng.uniform(0, 90)))
        kind = i % 5
        if kind == 0:
            Sphere(0.5, parent=w, transform=t, material=mat)
        elif kind == 1:
            Box(Point3D(-0.4, -0.3, -0.2), Point3D(0.4, 0.3, 0.2),
                parent=w, transform=t, material=mat)
        elif kind == 2:
            Cylinder(0.35, 0.7, parent=w, transform=t, material=mat)
        elif kind == 3:
            Cone(0.35, 0.6, parent=w, transform=t, material=mat)
        else:
            Parabola(0.35, 0.5, parent=w, transform=t, material=mat)
    Torus(0.8, 0.25, parent=w,
          transform=translate(0.0, -1.2, 1.0) * rotate_x(30.0),
          material=Lambert(InterpolatedSF([400, 700], [0.5, 0.5])))
    Box(Point3D(-3, -3, 4.0), Point3D(3, 3, 4.1), parent=w,
        material=UniformSurfaceEmitter(spec, 2.0))
    return w


def furnace(radius=10.0):
    """A sphere that emits 1 W/m2/str/nm: every ray from inside returns
    exactly 1.0 in every bin (reference demos/accuracy/observing_sphere.py)."""
    w = World()
    Sphere(radius, parent=w, material=UnitySurfaceEmitter())
    return w


def pinhole_rays(width, height):
    """Pinhole camera rays into the Cornell box: (origin, direction) as
    f32[width*height, 3] numpy arrays."""
    n = width * height
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width - 0.5
    ys = (np.arange(height, dtype=np.float32) + 0.5) / height - 0.5
    px, py = np.meshgrid(xs, ys, indexing="ij")
    d = np.stack([px.ravel() * 0.8, py.ravel() * 0.8,
                  np.ones(n, np.float32)], axis=-1).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray([0.0, 0.0, -3.3], np.float32), (n, 3)).copy()
    return o, d.astype(np.float32)


def scatter_rays(n, seed=0):
    """Rays from a plane at z=-2.5 with directions scattered round +z."""
    rng = np.random.RandomState(seed)
    o = np.concatenate(
        [rng.uniform(-0.9, 0.9, (n, 2)), np.full((n, 1), -2.5)], axis=1)
    d = rng.normal(size=(n, 3)) + np.array([0, 0, 4.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)
