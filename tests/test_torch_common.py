"""Shared inputs of the source_tpu_torch parity tests (no tests in here):
the test configuration, the JAX-side "zoo" scene, the carriers that hand a
compiled scene across between the two packages as numpy arrays, and the
compile of a JAX reference with LLVM's optimisation off."""

import contextlib
import os

import numpy as np

import jax
import jax.numpy as jnp

import source_tpu as S
from source_tpu.optical import InterpolatedSF
from source_tpu.optical.material import (
    AbsorbingSurface, AnisotropicSurfaceEmitter, Checkerboard, Conductor,
    Lambert, NullSurface, PerfectReflectingSurface, RoughConductor,
    UniformSurfaceEmitter, UniformVolumeEmitter,
)
from source_tpu.compiler.scene import CompiledScene as JaxCompiledScene
from source_tpu.primitive import Box, Cone, Cylinder, Parabola, Sphere, Torus
from source_tpu.tracer.meshtrace import MeshTables as JaxMeshTables

from source_tpu_torch.bridge import (
    ARRAY_FIELDS, MESH_ARRAYS, MESH_STATIC, STATIC_FIELDS, scene_from_numpy,
)

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
    if js.leaf_bvh is not None:
        arrays["leaf_bvh"] = {k: np.asarray(v) for k, v in js.leaf_bvh.items()}
    arrays["meshes"] = [
        {**{k: np.asarray(getattr(m, k)) for k in MESH_ARRAYS},
         **{k: getattr(m, k) for k in MESH_STATIC}} for m in js.meshes]
    static = {k: getattr(js, k) for k in STATIC_FIELDS}
    static["volume_entities"] = tuple(
        r[:3] + (None,) + r[4:] for r in js.volume_entities)
    return scene_from_numpy(arrays, static, device=device)


def to_jax(ts):
    """The port's compiled scene as the JAX package's, so both trace the same
    tables, meshes included (without the TPU packing of a mesh, which the
    JAX package's CPU route does not read). Spectral baking is held to the
    reference in tests/test_torch_compile.py; the JAX compile of a
    dispersive glass costs seconds of eager resampling."""
    arrays = {k: jnp.asarray(getattr(ts, k).numpy()) for k in ARRAY_FIELDS}
    static = {k: getattr(ts, k) for k in STATIC_FIELDS}
    bvh = (None if ts.leaf_bvh is None else
           {k: jnp.asarray(v.numpy()) for k, v in ts.leaf_bvh.items()})
    meshes = tuple(JaxMeshTables(
        **{k: jnp.asarray(getattr(m, k).numpy()) for k in MESH_ARRAYS},
        **{k: getattr(m, k) for k in MESH_STATIC}) for m in ts.meshes)
    return JaxCompiledScene(**arrays, **static, leaf_bvh=bvh, meshes=meshes)


@contextlib.contextmanager
def env(**kw):
    """Environment variables set for the duration of a with-block."""
    prev = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_compiled(fn, *args):
    """``fn`` compiled by XLA for the CPU with LLVM's optimisation off (at
    the default level the CPU build of the reference's ``trace_step``
    returns a zero normal on some CSG lanes, ROADMAP.md queue 3)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
