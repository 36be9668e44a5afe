"""Stock scenes and ray batches for smoke runs and tests.

``cornell_box`` is the glass Cornell box of the reference's
demos/cornell_box.py (measured wall reflectivities and light spectrum, a
glass box and a glass sphere); ``zoo`` holds every other built-in material
and all six solids; ``furnace`` is the exact-answer check: inside a unit
emitter every ray returns radiance 1 in every bin. ``csg_world`` is the CSG
demo of the reference's suite (demos/csg.py), the wavefront route's main
scene; ``prism_world`` (demos/prism.py) and ``mis_world``
(demos/multiple_importance_sampling.py) are the suite's other two worlds.
``leaf_field`` is a deep analytic-BVH input: every record kind of the BVH
kernel in a tree of some 130 nodes. ``mesh_world`` is the mesh demo
of the reference's suite (demos/mesh_render.py): a dispersive-glass
icosphere and a rough-metal torus knot over Lambert walls under an emitting
box; ``big_mesh_world`` puts the 1.31M-triangle icosphere of
benchmarks/bigmesh.py in place of the glass icosphere. ``modifier_world``
holds every material path that only the wavefront route traces: Blend and
Add mixes, a Roughen, two user BSDFs (``UserLambert``, ``UserMirror``) and
an inhomogeneous volume emitter (``glow``) inside a ``VolumeTransform``.
``cooke_triplet_world`` and ``metal_lens_world`` are the reference's two
imaging demos through real optics (demos/observers/): lenses of Schott
glass, absorbing mounts and a null-material aperture for a
``TargetedCCDArray``. ``hitpoints_world`` and ``logging_lens_world`` are the
worlds of the per-ray query demos (demos/core/ray_intersection_hitpoints.py,
demos/optics/logging_trajectories.py). ``bunny_world`` (demos/materials/
bunny.py: a glass mesh written to PLY and read back, in a CSG glass light
box) and ``tet_emission_world`` (demos/materials/
tetrahedra_mesh_emission.py: an inhomogeneous volume whose density is a
``Discrete3DMesh``) are the two demos of the mesh IO and the function
framework.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core import Point3D, rotate, rotate_x, translate
from .core.math.units import mm
from .core.math.batch import safe_sqrt
from .core.scenegraph import Node, World
from .optical import InterpolatedSF
from .optical import ConstantSF
from .optical.library import d65_white, schott
from .primitive import Mesh
from .optical.material import (
    AbsorbingSurface, Add, AnisotropicSurfaceEmitter, Blend, Checkerboard,
    Conductor, ContinuousBSDF, Dielectric, DiscreteBSDF,
    InhomogeneousVolumeEmitter, Lambert, NullMaterial, NullSurface,
    NumericalIntegrator, PerfectReflectingSurface, RoughConductor, Roughen,
    UniformSurfaceEmitter, UniformVolumeEmitter, UnitySurfaceEmitter,
    VolumeTransform,
)
from .optical.material.base import NSLOTS
from .primitive import (
    BiConcave, BiConvex, Box, Cone, Cylinder, Intersect, Meniscus, Parabola,
    Sphere, Subtract, Torus, Union,
)

__all__ = ["cornell_box", "zoo", "furnace", "csg_world", "prism_world",
           "mis_world", "leaf_field",
           "icosphere", "torus_knot", "mesh_world", "big_mesh_world",
           "cube_mesh", "blob_mesh", "watertight_cases", "MESH_CAMERA",
           "modifier_world", "UserLambert", "UserMirror", "glow",
           "cooke_triplet_world", "metal_lens_world", "hitpoints_world",
           "logging_lens_world", "bunny_mesh", "bunny_world", "BUNNY_CAMERA",
           "icosphere_tets", "tet_emission_world", "TET_CAMERA",
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


def _equilateral_prism(width=0.06, height=0.15, parent=None, transform=None,
                       material=None):
    """An equilateral prism along +y: two angled slabs shaved off a
    rectangular bar (reference demos/prism.py ``equilateral_prism``)."""
    half_width = width / 2
    mid_point = half_width / 2
    centre = Box(Point3D(-half_width * 1.001, 0, 0),
                 Point3D(half_width * 1.001, height, width))
    left = Box(
        Point3D(0, -0.001, 0), Point3D(width, height + 0.001, width * 2),
        transform=translate(half_width, 0, 0) * rotate(30, 0, 0),
    )
    right = Box(
        Point3D(-width, -0.001, 0), Point3D(0, height + 0.001, width * 2),
        transform=translate(-half_width, 0, 0) * rotate(-30, 0, 0),
    )
    prism = Subtract(Subtract(centre, left), right)
    prism.parent = parent
    prism.transform = ((transform or translate(0, 0, 0))
                       * translate(0, 0, -mid_point))
    prism.material = material
    return prism


def _light_box(parent, transform=None):
    """A white source behind a slit (reference demos/prism.py
    ``light_box``)."""
    node = Node(parent)
    if transform is not None:
        node.transform = transform
    outer = Box(Point3D(-0.01, 0, -0.05), Point3D(0.01, 0.15, 0.0))
    slit = Box(Point3D(-0.0015, 0.03, -0.045), Point3D(0.0015, 0.12, 0.0001))
    housing = Subtract(outer, slit)
    housing.parent = node
    housing.material = Lambert(ConstantSF(0.1))
    Box(Point3D(-0.0015, 0.03, -0.045), Point3D(0.0015, 0.12, -0.04),
        parent=node, material=UniformSurfaceEmitter(d65_white, 250))
    return node


def prism_world():
    """The prism demo (reference demos/prism.py ``build_world``): white
    light through a slit onto an SF11 equilateral prism (a CSG ``Subtract``
    of boxes), dispersed onto a Lambert floor."""
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert())
    _equilateral_prism(0.06, 0.15, parent=world, material=schott("SF11"),
                       transform=translate(0, 1e-6, -0.01))
    _light_box(parent=world, transform=rotate(-35.5, 0, 0)
               * translate(0.10, 0, 0) * rotate(90, 0, 0))
    return world


def mis_world():
    """The multiple-importance-sampling demo (reference
    demos/multiple_importance_sampling.py ``build_world``): four emitting
    spheres of equal power, radii 4x smaller each step, over four tilted
    RoughConductor plates of increasing roughness, a Lambert floor and
    backdrop."""
    world = World()
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.5)))
    Box(Point3D(-10, 0, 4), Point3D(10, 10, 4.1), parent=world,
        material=Lambert(ConstantSF(0.2)))
    radii = [0.5, 0.125, 0.03125, 0.0078125]
    for i, r in enumerate(radii):
        scale = (radii[0] / r) ** 2  # constant total power
        Sphere(r, parent=world, transform=translate(-1.8 + 1.2 * i, 2.2, 2.0),
               material=UniformSurfaceEmitter(d65_white, scale))
    n = ConstantSF(0.9)
    k = ConstantSF(6.0)
    for i, rough in enumerate([0.02, 0.05, 0.15, 0.4]):
        Box(Point3D(-2.4, -0.02, -0.3), Point3D(2.4, 0.0, 0.3), parent=world,
            transform=translate(0, 0.35 + 0.45 * i, 0.6 + 0.6 * i)
            * rotate(0, 62 - 8 * i, 0),
            material=RoughConductor(n, k, rough))
    return world


FIELD_SIDE = 7  # cells per axis of leaf_field's grid, 1.0 apart


class UserLambert(ContinuousBSDF):
    """A cosine-hemisphere Lambert written against the ContinuousBSDF
    contract: it traces as the built-in Lambert does (the same uniforms, the
    same one-sample MIS weight)."""

    def __init__(self, reflectivity=0.5):
        super().__init__()
        self._reflectivity = ConstantSF(reflectivity)

    def compile_spectra(self, min_wavelength, max_wavelength, bins):
        out = np.zeros((NSLOTS, bins))
        out[0] = self._reflectivity.sample(min_wavelength, max_wavelength,
                                           bins)
        return out

    def sample(self, w_in, u1, u2, spectra, params, back_face):
        z = safe_sqrt(u1)
        r = safe_sqrt(1.0 - u1)
        phi = 2.0 * math.pi * u2
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    def pdf(self, w_in, w_out, spectra, params, back_face):
        return torch.clamp(w_out[:, 2], min=0.0) / math.pi

    def bsdf(self, w_in, w_out, wavelengths, spectra, params, back_face):
        # reflective only: zero below the hemisphere (lambert.pyx:85)
        up = (w_out[:, 2] > 0.0)[:, None]
        return torch.where(up, spectra[:, 0, :] / math.pi, 0.0)


class UserMirror(DiscreteBSDF):
    """A lossless mirror written against the DiscreteBSDF contract: it traces
    as PerfectReflectingSurface does."""

    def evaluate_shading(self, w_in, u, wavelengths, spectra, params,
                         back_face):
        w_out = torch.stack([-w_in[:, 0], -w_in[:, 1], w_in[:, 2]], dim=-1)
        weight = torch.ones((w_in.shape[0], wavelengths.shape[0]),
                            dtype=w_in.dtype, device=w_in.device)
        transmitted = torch.zeros(w_in.shape[0], dtype=torch.bool,
                                  device=w_in.device)
        return w_out, weight, transmitted


def glow(p_local, d_local, wavelengths):
    """The emission density of ``modifier_world``'s inhomogeneous volume: a
    Gaussian ball, brighter toward +z and toward the red, W/m3/str/nm,
    [..., bins]."""
    r2 = (p_local * p_local).sum(-1)
    rho = 3.0 * torch.exp(-2.0 * r2) * (
        1.0 + 0.5 * torch.sin(3.0 * p_local[..., 2]))
    return rho[..., None] * (wavelengths / 550.0)


def modifier_world():
    """Every material path of the wavefront route that the fused route does
    not take, in front of the CSG demo's camera (``camera_rays`` at (0, 0,
    -4), fov 75): a Blend of two Lamberts, an Add of two emitters, a Roughen
    around a smooth conductor, a user ContinuousBSDF (``UserLambert``) and a
    user DiscreteBSDF (``UserMirror``), and the ``glow`` inhomogeneous
    volume emitter inside a ``VolumeTransform``, in a closed Lambert room lit
    by an emitting panel."""
    world = World()
    Box(Point3D(-6, -4, -6), Point3D(6, 4, 7), parent=world,
        material=Lambert(ConstantSF(0.5)))
    Box(Point3D(-2, 3.6, 0), Point3D(2, 3.8, 4), parent=world,
        material=UniformSurfaceEmitter(
            InterpolatedSF([400, 700], [2.0, 3.0])))
    Sphere(0.9, parent=world, transform=translate(-2.4, 1.3, 2.5),
           material=Blend(Lambert(ConstantSF(0.8)),
                          Lambert(InterpolatedSF([400, 700], [0.1, 0.7])),
                          0.3))
    Sphere(0.9, parent=world, transform=translate(0.0, 1.3, 2.5),
           material=Add(UniformSurfaceEmitter(ConstantSF(0.5)),
                        UniformSurfaceEmitter(
                            InterpolatedSF([400, 700], [1.0, 0.2]))))
    Box(Point3D(-0.8, -0.8, -0.8), Point3D(0.8, 0.8, 0.8), parent=world,
        transform=translate(2.4, 1.3, 2.5) * rotate(30, 20, 0),
        material=Roughen(Conductor(ConstantSF(0.9), ConstantSF(6.0)), 0.3))
    Sphere(0.9, parent=world, transform=translate(-2.4, -1.3, 2.5),
           material=UserLambert(0.6))
    Box(Point3D(-0.8, -0.8, -0.8), Point3D(0.8, 0.8, 0.8), parent=world,
        transform=translate(0.0, -1.3, 2.5) * rotate(-25, 15, 0),
        material=UserMirror())
    Sphere(0.9, parent=world, transform=translate(2.4, -1.3, 2.5),
           material=VolumeTransform(
               InhomogeneousVolumeEmitter(
                   glow, NumericalIntegrator(step=0.1, max_samples=16)),
               translate(0.0, 0.0, 0.3)))
    return world


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


def camera_rays(width, height, fov, position, rotation=(0.0, 0.0, 0.0)):
    """Rays of a pinhole camera at ``position`` (x, y, z), turned by
    ``rotate(*rotation)`` (yaw, pitch, roll in degrees) from looking along
    +z, through the pixel centres, ``fov`` degrees across the wider side
    (reference pinhole.pyx:148-200 without the pixel jitter): (origin,
    direction) as f32[width*height, 3] numpy arrays."""
    delta = 2.0 * np.tan(np.pi / 180.0 * 0.5 * fov) / max(width, height)
    px, py = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
    x = 0.5 * width * delta - delta * (px.ravel() + 0.5)
    y = 0.5 * height * delta - delta * (py.ravel() + 0.5)
    d = np.stack([x, y, np.ones_like(x)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ rotate(*rotation).to_array(np.float64)[:3, :3].T
    o = np.empty(d.shape, np.float32)
    o[:] = np.asarray(position, np.float32)
    return o, d.astype(np.float32)


def icosphere(subdivisions=3, radius=1.0):
    """Subdivided icosahedron: vertices f32[V,3], triangles i32[T,3]. The
    mesh of the reference's demos/mesh_render.py (and of
    tests/test_mesh_paging.py): every pass splits each face into four at its
    edge midpoints, a new vertex numbered at its edge's first appearance in
    face order, (a, b), (b, c), (c, a) per face; built here one pass at a
    time over all edges at once."""
    verts, faces = _icosphere64(subdivisions)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def _icosphere64(subdivisions):
    """The unit icosphere in float64: vertices [V,3], triangles i64[T,3]."""
    g = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
        [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
        [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1],
    ], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        nv = len(verts)
        a, b, c = faces.T
        edges = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                          np.stack([c, a], 1)], axis=1).reshape(-1, 2)
        key = edges.min(axis=1) * nv + edges.max(axis=1)
        _, first, inverse = np.unique(key, return_index=True,
                                      return_inverse=True)
        by_first = np.argsort(first, kind="stable")
        rank = np.empty_like(by_first)
        rank[by_first] = np.arange(len(by_first))
        ends = edges[first[by_first]]
        mid = verts[ends[:, 0]] + verts[ends[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = (nv + rank[inverse.reshape(-1)]).reshape(-1, 3).T
        faces = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                          np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                         axis=1).reshape(-1, 3)
        verts = np.concatenate([verts, mid])
    return verts, faces


def torus_knot(p=2, q=3, tube=0.25, scale=0.6, segments=160, sides=12):
    """Tube swept along a (p, q) torus knot (the reference's
    demos/mesh_render.py): vertices f32[V,3], triangles i32[T,3]."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = 2.0 + np.cos(q * t)
    centre = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1
    ) * scale
    # frames along the curve
    tangent = np.roll(centre, -1, axis=0) - np.roll(centre, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    normal = np.cross(tangent, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(normal, axis=1) < 1e-6
    normal[bad] = np.cross(tangent[bad], [1.0, 0.0, 0.0])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    binormal = np.cross(tangent, normal)

    phi = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * normal[None] +
            np.sin(phi)[:, None, None] * binormal[None])  # [sides, seg, 3]
    verts = (centre[None] + tube * scale * ring).transpose(1, 0, 2).reshape(-1, 3)

    tris = []
    for i in range(segments):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            c = ((i + 1) % segments) * sides + j
            d = ((i + 1) % segments) * sides + (j + 1) % sides
            tris += [[a, c, b], [b, c, d]]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


# the mesh demo's camera (demos/mesh_render.py): fov 50 across 512x384,
# translate(0, 1.4, -3.6) * rotate(0, -8, 0)
MESH_CAMERA = dict(width=512, height=384, fov=50.0, position=(0.0, 1.4, -3.6),
                   rotation=(0.0, -8.0, 0.0))


def mesh_world(small=False, sphere=None):
    """The mesh demo (reference demos/mesh_render.py ``build_world``): an
    N-BK7 icosphere (3 subdivisions, 1 280 triangles; 2 when ``small``)
    and a rough-conductor torus knot (160 x 12 segments, 3 840 triangles;
    64 x 8 when ``small``), both smoothed and closed, a Lambert floor and
    back wall and an emitting box above. ``sphere`` replaces the icosphere's
    (vertices, triangles)."""
    world = World()
    v, f = icosphere(2 if small else 3, radius=0.8) if sphere is None else sphere
    Mesh(v, f, smoothing=True, closed=True, parent=world,
         transform=translate(-1.1, 0.8, 0.0), material=schott("N-BK7"))
    v2, f2 = torus_knot(segments=64 if small else 160, sides=8 if small else 12)
    Mesh(v2, f2, smoothing=True, closed=True, parent=world,
         transform=translate(1.2, 0.9, 0.3) * rotate(0, 70, 0),
         material=RoughConductor(ConstantSF(0.9), ConstantSF(6.0), 0.2))
    Box(Point3D(-10, -0.1, -10), Point3D(10, 0, 10), parent=world,
        material=Lambert(ConstantSF(0.6)))
    Box(Point3D(-10, 0, 4), Point3D(10, 6, 4.1), parent=world,
        material=Lambert(ConstantSF(0.3)))
    Box(Point3D(-1.5, 3.0, -1.5), Point3D(1.5, 3.2, 1.5), parent=world,
        material=UniformSurfaceEmitter(d65_white, 4.0))
    return world


def big_mesh_world():
    """The mesh demo with the icosphere of benchmarks/bigmesh.py (8
    subdivisions, 1 310 720 triangles) as its glass sphere, at the demo's
    radius 0.8 so it rests where the demo's does."""
    return mesh_world(sphere=icosphere(8, radius=0.8))


def cube_mesh():
    """The closed cube [-1, 1]^3 as 12 triangles, shared edges everywhere
    (tests/test_mesh_watertight.py): vertices f32[8,3], triangles i32[12,3]."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 dtype=np.float32)
    # index: bit2 = x, bit1 = y, bit0 = z; outward winding
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x = -1, x = +1
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y = -1, y = +1
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z = -1, z = +1
    ], dtype=np.int32)
    return v, f


def blob_mesh(subdivisions=3, seed=11):
    """A closed displaced icosphere with irregular, sliver-prone triangles
    at every orientation (tests/test_mesh_watertight.py): vertices
    f32[V,3], triangles i32[T,3]."""
    verts, faces = _icosphere64(subdivisions)
    rng = np.random.RandomState(seed)
    amps = rng.uniform(-1, 1, (6, 4))
    r = 1.0
    for k in range(6):
        r = r + 0.12 * amps[k, 0] * np.sin(
            (k + 1) * verts[:, 0] + amps[k, 1]) * np.cos(
            (k + 2) * verts[:, 1] + amps[k, 2]) * np.sin(
            (k + 1) * verts[:, 2] + amps[k, 3])
    return (verts * r[:, None]).astype(np.float32), faces.astype(np.int32)


def watertight_cases():
    """Rays aimed exactly at shared edges and vertices of closed meshes, the
    patterns of tests/test_mesh_watertight.py: (name, vertices, triangles,
    origins f32[N,3], unit directions f32[N,3]) per case. "cube": its 8
    vertices, 12 edge midpoints and 6 face-diagonal midpoints from
    (5, 4, 3); "cube_axis": axis-aligned rays in the face planes, across
    shared edges; "blob": 64 edge midpoints and 32 vertices of
    ``blob_mesh`` from jittered points outside it."""
    v, f = cube_mesh()
    targets = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    for a in (-1, 1):
        for b in (-1, 1):
            targets += [(0.0, a, b), (a, 0.0, b), (a, b, 0.0)]
    for a in (-1, 1):
        targets += [(a, 0.0, 0.0), (0.0, a, 0.0), (0.0, 0.0, a)]
    targets = np.asarray(targets, np.float32)
    d = targets - np.asarray([5.0, 4.0, 3.0], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray([5.0, 4.0, 3.0], np.float32), d.shape)
    cases = [("cube", v, f, o.copy(), d)]
    o, d = [], []
    for axis in range(3):
        for u_val in (-1.0, 0.0, 1.0):
            for v_val in (-1.0, 0.0, 1.0):
                origin = np.zeros(3, np.float32)
                origin[axis] = -5.0
                origin[(axis + 1) % 3] = u_val
                origin[(axis + 2) % 3] = v_val
                o.append(origin)
                d.append(np.eye(3, dtype=np.float32)[axis])
    cases.append(("cube_axis", v, f, np.stack(o), np.stack(d)))
    vb, fb = blob_mesh()
    rng = np.random.RandomState(3)
    e0 = vb[fb[:, [0, 1, 2]].ravel()]
    e1 = vb[fb[:, [1, 2, 0]].ravel()]
    sel = rng.choice(len(e0), 64, replace=False)
    mids = 0.5 * (e0[sel] + e1[sel])
    targets = np.concatenate([mids, vb[rng.choice(len(vb), 32, replace=False)]])
    radial = targets / np.linalg.norm(targets, axis=1, keepdims=True)
    origins = targets - 4.0 * radial + rng.normal(scale=0.3, size=targets.shape)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cases.append(("blob", vb, fb, origins.astype(np.float32),
                  d.astype(np.float32)))
    return cases


def field_rays(n, seed=0):
    """Incoherent rays through ``leaf_field``: origins uniform in its grid
    cube, directions uniform on the sphere."""
    rng = np.random.RandomState(seed)
    half = 0.5 * FIELD_SIDE
    o = rng.uniform(-half, half, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def cooke_triplet_world():
    """The Cornell box imaged through a Cooke triplet
    (demos/observers/cornell_box_cooke_triplet.py:29-65 on
    demos/cornell_box.py's glass box): a Meniscus / BiConcave / BiConvex
    triplet of Schott glass (lens importance sampling off), each lens, its
    mount and the stop parented to the lens before, an absorbing camera
    body, and a null-material aperture inside the stop. Returns (world,
    image_plane, aperture): a ``TargetedCCDArray`` under ``image_plane``,
    turned by ``rotate(0, 0, 180)``, aims its samples at ``aperture``."""
    world = cornell_box(glass=True)
    camera = Node(parent=world, transform=translate(0, 0, -3.8))
    lenses = Node(parent=camera)
    l1 = Meniscus(mm(21), mm(4.831), mm(23.713), mm(7331.288),
                  parent=lenses, transform=translate(0, 0, mm(-4.831)),
                  material=schott("N-LAK9"))
    l2 = BiConcave(mm(13), mm(0.975), mm(24.456), mm(21.896), parent=l1,
                   transform=translate(0, 0, mm(-6.835)),
                   material=schott("SF5"))
    l3 = BiConvex(mm(18), mm(3.127), mm(86.759), mm(20.4942), parent=l2,
                  transform=translate(0, 0, mm(-7.949)),
                  material=schott("N-LAK9"))
    image_plane = Node(parent=l3, transform=translate(0, 0, mm(-41.5)))
    for lens in (l1, l2, l3):
        lens.material.importance = 0.0

    Subtract(Cylinder(mm(26), mm(80.0), transform=translate(0, 0, mm(-63))),
             Cylinder(mm(25), mm(79.1), transform=translate(0, 0, mm(-62))),
             parent=camera, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(5.0)),
             Cylinder(mm(21 / 2 + 0.01), mm(5.1),
                      transform=translate(0, 0, mm(-0.05))),
             parent=l1, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(4.0)),
             Cylinder(mm(13 / 2 + 0.01), mm(4.1),
                      transform=translate(0, 0, mm(-0.05))),
             parent=l2, material=AbsorbingSurface())
    Subtract(Cylinder(mm(25.5), mm(1.0)),
             Cylinder(mm(12 / 2 + 0.01), mm(1.1),
                      transform=translate(0, 0, mm(-0.05))),
             parent=l2, transform=translate(0, 0, mm(-2)),
             material=AbsorbingSurface())
    aperture = Cylinder(mm(12 / 2), mm(0.5), parent=l2,
                        transform=translate(0, 0, mm(-1.95)),
                        material=NullMaterial())
    return world, image_plane, aperture


def metal_lens_world():
    """Six measured-n/k metal spheres on a white floor under a D65
    cylinder light, seen through a BiConvex N-BK7 lens in an absorbing
    camera body with a null-material aperture
    (demos/observers/metal_with_lens.py:31-57). Returns (world, camera,
    aperture): a ``TargetedCCDArray`` under ``camera`` aims at
    ``aperture``."""
    from .optical.library import (
        Aluminium, Beryllium, Copper, Gold, Silver, Titanium,
    )
    world = World()
    for (tx, tz), metal in [((1.2, 0.6), Gold), ((0.6, -0.6), Silver),
                            ((0, 0.6), Copper), ((-0.6, -0.6), Titanium),
                            ((-1.2, 0.6), Aluminium), ((0, -1.8), Beryllium)]:
        Sphere(0.5, parent=world, transform=translate(tx, 0.5001, tz),
               material=metal())
    Box(Point3D(-100, -0.1, -100), Point3D(100, 0, 100), parent=world,
        material=Lambert(ConstantSF(1.0)))
    Cylinder(3.0, 8.0, parent=world,
             transform=translate(4, 8, 0) * rotate(90, 0, 0),
             material=UniformSurfaceEmitter(d65_white, 1.0))

    camera = Node(parent=world,
                  transform=translate(0, 4, -3.5) * rotate(0, -48, 180))
    BiConvex(0.0508, 0.0144, 0.0593, 0.0593, parent=camera,
             transform=translate(0, 0, 0.0536), material=schott("N-BK7"))
    Subtract(
        Subtract(Cylinder(0.0260, 0.07),
                 Cylinder(0.0255, 0.06, transform=translate(0, 0, 0.005))),
        Cylinder(0.015, 0.007, transform=translate(0, 0, 0.064)),
        parent=camera, transform=translate(0, 0, -0.01),
        material=AbsorbingSurface(),
    )
    aperture = Cylinder(0.016, 0.0009, parent=camera,
                        transform=translate(0, 0, 0.064),
                        material=NullMaterial())
    return world, camera, aperture


def hitpoints_world():
    """A box with a sphere cut out of it, 2 m down +z
    (demos/core/ray_intersection_hitpoints.py:22-27). Returns (world,
    solid)."""
    world = World()
    solid = Subtract(
        Box(Point3D(-0.5, -0.5, -0.5), Point3D(0.5, 0.5, 0.5)),
        Sphere(0.6),
        parent=world, transform=translate(0, 0, 2),
        material=AbsorbingSurface(),
    )
    return world, solid


def logging_lens_world():
    """An f~51 mm BiConvex lens of index 1.5 (transmission only) and an
    absorbing screen past its focal plane
    (demos/optics/logging_trajectories.py:20-26)."""
    world = World()
    BiConvex(0.02, 0.006, 0.05, 0.05, parent=world,
             material=Dielectric(ConstantSF(1.5), ConstantSF(1.0),
                                 transmission_only=True))
    Box(Point3D(-0.05, -0.05, 0.062), Point3D(0.05, 0.05, 0.063),
        parent=world, material=AbsorbingSurface())
    return world


def bunny_mesh(subdiv=5):
    """The bunny demo's stand-in for the Stanford scan
    (demos/materials/bunny.py ``_stand_in_mesh``): ``icosphere`` of radius
    0.05 m displaced along its normals by a low-frequency bump and lifted
    0.055 m onto the pedestal, in float32 as the demo computes it; 20 480
    triangles at 5 subdivisions. Returns (vertices, triangles)."""
    v, f = icosphere(subdiv, radius=0.05)
    r = np.linalg.norm(v, axis=1, keepdims=True)
    n = v / r
    bump = (0.22 * np.sin(6.0 * n[:, 0]) * np.cos(4.0 * n[:, 1])
            + 0.15 * np.sin(5.0 * n[:, 2] + 1.7)) * 0.05
    v = v + n * bump[:, None] * 0.35
    v[:, 1] += 0.055
    return v, f


def bunny_world(small=False):
    """The glass bunny on an illuminated glass pedestal
    (demos/materials/bunny.py ``build_world``) with the demo's stand-in for
    the Stanford scan, which the repository does not hold (``bunny_mesh``,
    5 subdivisions, 3 when ``small``) written with ``export_ply`` and read
    back with ``import_ply``, in N-BK7; inside a light box of a Lambert CSG
    enclosure, an N-BK7 CSG glass shell and a D65 volume emitter."""
    import os
    import tempfile

    from .primitive.mesh import export_ply, import_ply

    world = World()
    v, f = bunny_mesh(3 if small else 5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bunny_stand_in.ply")
        export_ply(Mesh(v, f), path)
        import_ply(path, parent=world, material=schott("N-BK7"))

    # light box (reference bunny.py:40-70)
    padding = 1e-5
    enclosure_thickness = 0.001 + padding
    glass_thickness = 0.003
    light_box = Node(parent=world)
    e, g = enclosure_thickness, glass_thickness
    Subtract(
        Box(Point3D(-0.10 - e, -0.02 - e, -0.10 - e),
            Point3D(0.10 + e, 0.0, 0.10 + e)),
        Box(Point3D(-0.10 - padding, -0.02 - padding, -0.10 - padding),
            Point3D(0.10 + padding, 0.001, 0.10 + padding)),
        material=Lambert(ConstantSF(0.2)), parent=light_box)
    Subtract(
        Box(Point3D(-0.10, -0.02, -0.10), Point3D(0.10, 0.0, 0.10)),
        Box(Point3D(-0.10 + g, -0.02 + g, -0.10 + g),
            Point3D(0.10 - g, -g, 0.10 - g)),
        material=schott("N-BK7"), parent=light_box)
    Box(Point3D(-0.10 + g + padding, -0.02 + g + padding, -0.10 + g + padding),
        Point3D(0.10 - g - padding, -g - padding, 0.10 - g - padding),
        material=UniformVolumeEmitter(d65_white, 50), parent=light_box)
    return world


# the bunny demo's camera: PinholeCamera (fov 45) at
# translate(0, 0.16, -0.4) * rotate(0, -12, 0)
BUNNY_CAMERA = dict(fov=45.0, position=(0.0, 0.16, -0.4),
                    rotation=(0.0, -12.0, 0.0))


def icosphere_tets(subdiv=2, radius=0.5):
    """An icosphere tetrahedralised against its centre
    (demos/materials/tetrahedra_mesh_emission.py ``icosphere_tets``, whose
    float64 midpoints this follows bit for bit): every surface triangle
    forms a tetrahedron with the centre vertex, the last. Returns
    (vertices f64[V,3], tetrahedra i32[T,4])."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0],
        [0, -1, g], [0, 1, g], [0, -1, -g], [0, 1, -g],
        [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = _icosphere64(0)[1].astype(np.int32)
    for _ in range(subdiv):
        cache, new_faces = {}, []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int32)
    verts = np.concatenate([verts * radius, np.zeros((1, 3))])
    tets = np.concatenate(
        [faces, np.full((len(faces), 1), len(verts) - 1, np.int32)], axis=1)
    return verts, tets


def tet_emission_world(subdiv=2):
    """Tetrahedral-mesh volume emission
    (demos/materials/tetrahedra_mesh_emission.py ``build_world``): an
    ``InhomogeneousVolumeEmitter`` box whose emission density is a
    ``Discrete3DMesh`` over ``icosphere_tets`` (per-tet constants, brighter
    toward +y; 0 outside the mesh), marched at 24 samples, over a
    rough-titanium floor. The march hands the field tensors, and it
    evaluates on their device."""
    from .core.math.function import Discrete3DMesh
    from .optical.library import RoughTitanium

    world = World()
    verts, tets = icosphere_tets(subdiv, radius=0.5)
    centroids = verts[tets].mean(axis=1)
    tet_data = 1.0 + 4.0 * np.clip(centroids[:, 1] + 0.5, 0, 1)
    field = Discrete3DMesh(verts, tets, tet_data, limit=False,
                           default_value=0.0)

    def emission(p, direction, wavelengths):
        dens = field(p[..., 0], p[..., 1], p[..., 2])
        return dens[..., None].expand(dens.shape + (wavelengths.shape[0],))

    Box(Point3D(-0.6, -0.6, -0.6), Point3D(0.6, 0.6, 0.6), parent=world,
        transform=translate(0, 0.62, 0),
        material=InhomogeneousVolumeEmitter(
            emission, integrator=NumericalIntegrator(max_samples=24)))
    Box(Point3D(-100, -0.1, -100), Point3D(100, -0.01, 100), parent=world,
        material=RoughTitanium(0.1))
    return world


# the tetrahedral-emission demo's camera: PinholeCamera, fov 50, at
# translate(0, 0.75, -2.2)
TET_CAMERA = dict(fov=50.0, position=(0.0, 0.75, -2.2))
