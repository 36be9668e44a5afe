"""Shared inputs of the source_tpu_torch parity tests (no tests in here):
the test configuration, the JAX-side "zoo" scene, and the carrier that hands
a JAX-compiled scene to the port as numpy arrays."""

import numpy as np

import source_tpu as S
from source_tpu.optical import InterpolatedSF
from source_tpu.optical.material import (
    AbsorbingSurface, AnisotropicSurfaceEmitter, Checkerboard, Conductor,
    Lambert, NullSurface, PerfectReflectingSurface, RoughConductor,
    UniformSurfaceEmitter, UniformVolumeEmitter,
)
from source_tpu.primitive import Box, Cone, Cylinder, Parabola, Sphere, Torus

from source_tpu_torch.bridge import ARRAY_FIELDS, STATIC_FIELDS, scene_from_numpy

B = 5  # spectral bins of every parity test
CFG = dict(max_depth=6, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25, max_iters=8)


def jax_zoo():
    """The zoo scene of tests/test_fused.py, compiled by the JAX package:
    every built-in material the Cornell box lacks, all six solids."""
    w = S.World()
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
        t = S.translate(x, y, z) * S.rotate_x(float(rng.uniform(0, 90)))
        kind = i % 5
        if kind == 0:
            Sphere(0.5, parent=w, transform=t, material=mat)
        elif kind == 1:
            Box(S.Point3D(-0.4, -0.3, -0.2), S.Point3D(0.4, 0.3, 0.2),
                parent=w, transform=t, material=mat)
        elif kind == 2:
            Cylinder(0.35, 0.7, parent=w, transform=t, material=mat)
        elif kind == 3:
            Cone(0.35, 0.6, parent=w, transform=t, material=mat)
        else:
            Parabola(0.35, 0.5, parent=w, transform=t, material=mat)
    Torus(0.8, 0.25, parent=w,
          transform=S.translate(0.0, -1.2, 1.0) * S.rotate_x(30.0),
          material=Lambert(InterpolatedSF([400, 700], [0.5, 0.5])))
    Box(S.Point3D(-3, -3, 4.0), S.Point3D(3, 3, 4.1), parent=w,
        material=UniformSurfaceEmitter(spec, 2.0))
    return S.compile_scene(w, S.SpectralConfig(375.0, 740.0, B))


def carry_scene(js, device="cpu"):
    """A JAX CompiledScene as the port's, through ``scene_from_numpy``."""
    arrays = {k: np.asarray(getattr(js, k)) for k in ARRAY_FIELDS}
    static = {k: getattr(js, k) for k in STATIC_FIELDS}
    static["volume_entities"] = tuple(
        r[:3] + (None,) + r[4:] for r in js.volume_entities)
    return scene_from_numpy(arrays, static, device=device)
