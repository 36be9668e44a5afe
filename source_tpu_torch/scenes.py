"""Stock scenes and ray batches for smoke runs and tests.

``cornell_box`` is the glass Cornell box of the reference's
demos/cornell_box.py (measured wall reflectivities and light spectrum, a
glass box and a glass sphere); ``zoo`` holds every other built-in material
and all six solids; ``furnace`` is the exact-answer check: inside a unit
emitter every ray returns radiance 1 in every bin. ``csg_world`` is the CSG
demo of the reference's suite (demos/csg.py), the wavefront route's main
scene; ``leaf_field`` is a deep analytic-BVH input: every record kind of
the BVH kernel in a tree of some 130 nodes.
"""

from __future__ import annotations

import numpy as np

from .core import Point3D, rotate, rotate_x, translate
from .core.scenegraph import Node, World
from .optical import InterpolatedSF
from .optical import ConstantSF
from .optical.library import d65_white, schott
from .optical.material import (
    AbsorbingSurface, AnisotropicSurfaceEmitter, Checkerboard, Conductor,
    Lambert, NullSurface, PerfectReflectingSurface, RoughConductor,
    UniformSurfaceEmitter, UniformVolumeEmitter, UnitySurfaceEmitter,
)
from .primitive import (
    Box, Cone, Cylinder, Intersect, Parabola, Sphere, Subtract, Torus, Union,
)

__all__ = ["cornell_box", "zoo", "furnace", "csg_world", "leaf_field",
           "pinhole_rays", "camera_rays", "scatter_rays", "field_rays"]


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


def _csg_solid():
    """Sphere intersected with a cube minus three orthogonal cylinders."""
    cyl_x = Cylinder(1, 4.2, transform=rotate(90, 0, 0) * translate(0, 0, -2.1))
    cyl_y = Cylinder(1, 4.2, transform=rotate(0, 90, 0) * translate(0, 0, -2.1))
    cyl_z = Cylinder(1, 4.2, transform=translate(0, 0, -2.1))
    cube = Box(Point3D(-1.5, -1.5, -1.5), Point3D(1.5, 1.5, 1.5))
    sphere = Sphere(2.0)
    return Intersect(sphere, Subtract(cube, Union(Union(cyl_x, cyl_y), cyl_z)))


def csg_world():
    """The CSG demo (reference demos/csg.py ``build_world``): four CSG solids
    in dispersive Schott glasses, a lens-like intersection of two spheres, a
    checkerboard backdrop and a faint emitting enclosure."""
    world = World()
    for (tx, ty, yaw, pitch), glass in [
        ((-2.1, 2.1, 30, -20), "N-LAK22"),
        ((2.1, 2.1, -30, -20), "SF10"),
        ((2.1, -2.1, -30, 20), "LF5"),
        ((-2.1, -2.1, 30, 20), "N-BK7"),
    ]:
        solid = _csg_solid()
        solid.parent = world
        solid.transform = translate(tx, ty, 2.5) * rotate(yaw, pitch, 0)
        solid.material = schott(glass)
    s1 = Sphere(1.0, transform=translate(0, 0, 1.0 - 0.01))
    s2 = Sphere(0.5, transform=translate(0, 0, -0.5 + 0.01))
    lens = Intersect(s1, s2)
    lens.parent = world
    lens.transform = translate(0, 0, -3.6) * rotate(50, 50, 0)
    lens.material = schott("N-BK7")
    Box(Point3D(-50, -50, 50), Point3D(50, 50, 50.1), parent=world,
        material=Checkerboard(4, d65_white, d65_white, 0.4, 0.8))
    Box(Point3D(-100, -100, -100), Point3D(100, 100, 100), parent=world,
        material=UniformSurfaceEmitter(d65_white, 0.1))
    return world


FIELD_SIDE = 7  # cells per axis of leaf_field's grid, 1.0 apart


def leaf_field(n_simple=256, n_lens=8, seed=0):
    """A field of small solids for the analytic-BVH kernel: ``n_simple``
    simple leaves cycling through the six types (rotated general records,
    plus translated spheres and axis-aligned boxes, which pack as world
    records) on a jittered grid, ``n_lens`` lens-like CSG solids (two
    intersecting spheres) between them, and an emitting enclosure sphere."""
    rng = np.random.RandomState(seed)
    w = World()
    mat = Lambert(ConstantSF(0.5))
    half = 0.5 * (FIELD_SIDE - 1)
    cells = [(i, j, k) for i in range(FIELD_SIDE) for j in range(FIELD_SIDE)
             for k in range(FIELD_SIDE)]
    rng.shuffle(cells)
    for n, (i, j, k) in enumerate(cells[:n_simple + n_lens]):
        pos = translate(*(np.array([i, j, k], float) - half
                          + rng.uniform(-0.15, 0.15, 3)))
        turn = rotate(*rng.uniform(0.0, 90.0, 3))
        if n >= n_simple:
            lens = Intersect(Sphere(0.3, transform=translate(0, 0, 0.22)),
                             Sphere(0.3, transform=translate(0, 0, -0.22)))
            lens.parent = w
            lens.transform = pos * turn
            lens.material = mat
            continue
        kind = n % 6
        if kind == 0:
            Sphere(0.25, parent=w, transform=pos, material=mat)
        elif kind == 1:
            Box(Point3D(-0.2, -0.15, -0.1), Point3D(0.2, 0.15, 0.1), parent=w,
                transform=pos if n % 12 == 1 else pos * turn, material=mat)
        elif kind == 2:
            Cylinder(0.2, 0.4, parent=w, transform=pos * turn, material=mat)
        elif kind == 3:
            Cone(0.2, 0.4, parent=w, transform=pos * turn, material=mat)
        elif kind == 4:
            Parabola(0.2, 0.35, parent=w, transform=pos * turn, material=mat)
        else:
            Torus(0.22, 0.07, parent=w, transform=pos * turn, material=mat)
    Sphere(3.0 * FIELD_SIDE, parent=w,
           material=UniformSurfaceEmitter(ConstantSF(1.0)))
    return w


def camera_rays(width, height, fov, position):
    """Rays of a pinhole camera at ``position`` (x, y, z) looking along +z
    through the pixel centres, ``fov`` degrees across the wider side
    (reference pinhole.pyx:148-200 without the pixel jitter): (origin,
    direction) as f32[width*height, 3] numpy arrays."""
    delta = 2.0 * np.tan(np.pi / 180.0 * 0.5 * fov) / max(width, height)
    px, py = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
    x = 0.5 * width * delta - delta * (px.ravel() + 0.5)
    y = 0.5 * height * delta - delta * (py.ravel() + 0.5)
    d = np.stack([x, y, np.ones_like(x)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.empty(d.shape, np.float32)
    o[:] = np.asarray(position, np.float32)
    return o, d.astype(np.float32)


def field_rays(n, seed=0):
    """Incoherent rays through ``leaf_field``: origins uniform in its grid
    cube, directions uniform on the sphere."""
    rng = np.random.RandomState(seed)
    half = 0.5 * FIELD_SIDE
    o = rng.uniform(-half, half, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)
