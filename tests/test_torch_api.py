"""The port's public surface against source_tpu's, on the CPU.

  (a) every name in an ``__all__`` of a module of ``source_tpu`` resolves in
      the module of the same path in ``source_tpu_torch``, except the names
      listed in ``NOT_PORTED``, each with its ROADMAP.md entry;
  (b) the modules ported by the mesh-IO and host-math slice import in a
      fresh interpreter without jax, jaxlib, source_tpu or triton, and
      importing builds and loads no native library (the OBJ tokenizer is
      compiled at the first OBJ import, the BVH builder at the first mesh);
  (c) the accelerator facade (``KDTree``, ``Unaccelerated``,
      ``BoundPrimitive``) on CPU tensors: built on a world of a sphere, a
      CSG solid and a closed mesh, its hits (primitive, exiting, t, hit
      point and normal within 1e-5, the mesh's triangle) and its contains
      lists equal to those of ``source_tpu.accel``'s same class on the same
      world built with the JAX package's primitives (SOURCE_TPU_LEAF_BVH=0,
      SOURCE_TPU_FUSED=0), and every query equal to the port's own
      ``World.hit`` and ``World.contains``.
"""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import source_tpu as S
from source_tpu import accel as jaccel
from source_tpu.core import Ray as JRay
from source_tpu.optical.material import AbsorbingSurface as JAbsorbing
from source_tpu.primitive import (
    Box as JBox, Mesh as JMesh, Sphere as JSphere, Subtract as JSubtract,
)
from source_tpu.tracer import intersect as jintersect

import source_tpu_torch as T
from source_tpu_torch import accel, scenes
from source_tpu_torch.core import Ray
from source_tpu_torch.optical.material import AbsorbingSurface
from source_tpu_torch.primitive import Box, Mesh, Sphere, Subtract

from test_torch_common import env, jax_compiled

REPO = Path(__file__).resolve().parent.parent

_MULTI_GPU = "ROADMAP.md queue 1 item 5 (multi-GPU)"
_NOT_CARRIED = "ROADMAP.md queue 1 item 6 (not carried)"
_PALLAS = "ROADMAP.md queue 2: the Pallas kernels, ported as CUDA kernels"
# (module of source_tpu, name or None for the whole module) -> ROADMAP entry
NOT_PORTED = {
    ("source_tpu.tracer.pallas_analytic", None): _PALLAS,
    ("source_tpu.tracer.pallas_fused", None): _PALLAS,
    ("source_tpu.tracer.pallas_mesh", None): _PALLAS,
    ("source_tpu.parallel.distributed", None): _MULTI_GPU,
    ("source_tpu", "MulticoreEngine"): _MULTI_GPU,
    ("source_tpu", "ShardedEngine"): _MULTI_GPU,
    ("source_tpu.parallel", "MulticoreEngine"): _MULTI_GPU,
    ("source_tpu.parallel", "ShardedEngine"): _MULTI_GPU,
    ("source_tpu.parallel", "default_mesh"): _MULTI_GPU,
    ("source_tpu.parallel.engine", "MulticoreEngine"): _MULTI_GPU,
    ("source_tpu.parallel.engine", "ShardedEngine"): _MULTI_GPU,
    ("source_tpu.parallel.engine", "default_mesh"): _MULTI_GPU,
    ("source_tpu.parallel.engine", "sharded_render_batch"): _MULTI_GPU,
    ("source_tpu.parallel.engine", "sharded_render_loss_and_grads"): _MULTI_GPU,
    ("source_tpu.core.math.random", "ray_keys"): _NOT_CARRIED,
    ("source_tpu.tracer.meshtrace", "mesh_forest_intersect"): _NOT_CARRIED,
    ("source_tpu.tracer.meshtrace", "mesh_hit_count"): _NOT_CARRIED,
}

MODULES = ["source_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(S.__path__, "source_tpu."))


@pytest.mark.parametrize("name", MODULES)
def test_public_names_resolve_in_the_port(name):
    if (name, None) in NOT_PORTED:
        return
    ref = importlib.import_module(name)
    port = importlib.import_module("source_tpu_torch" + name[len("source_tpu"):])
    missing = [n for n in getattr(ref, "__all__", ())
               if not hasattr(port, n) and (name, n) not in NOT_PORTED]
    assert not missing, missing
    # every exception is still an exception: a name ported later leaves it
    for (mod, n), entry in NOT_PORTED.items():
        if mod == name and n is not None:
            assert not hasattr(port, n), f"{n} is ported: drop it ({entry})"


def test_exceptions_name_modules_that_exist():
    names = set(MODULES)
    assert all(mod in names for mod, _ in NOT_PORTED)


_IMPORT_CHECK = """
import sys
import source_tpu_torch
from source_tpu_torch import scenes
from source_tpu_torch.accel import bvh, facade
from source_tpu_torch.core import boundingbox, containers
from source_tpu_torch.core.math import (
    batch, polygon, polyroots, quaternion, sampler, spatial, triangle,
)
from source_tpu_torch.core.math.function import (
    base, interpolate, mesh_interp, samplers, vector3d,
)
from source_tpu_torch.primitive.mesh import io
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "source_tpu", "triton")]
assert not bad, bad
# nothing was built or loaded by importing
assert io._MESHIO_LIB is None and not io._MESHIO_FAILED
assert bvh._LIB is None and not bvh._LIB_FAILED
with open("/proc/self/maps") as f:
    maps = f.read()
assert "libmeshio" not in maps and "libbvh" not in maps
print("clean")
"""


def test_new_modules_import_without_jax_and_build_nothing():
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


# --- (c) the accelerator facade ----------------------------------------------------


def _build_world(W, Sp, Bx, Sub, Ms, point, translate, absorbing):
    """The facade's world in either package: a sphere, a box with a sphere
    cut out, and a closed icosphere mesh, side by side at z = 3."""
    world = W()
    Sp(0.5, parent=world, transform=translate(-1.0, 0.0, 3.0),
       material=absorbing())
    Sub(Bx(point(-0.5, -0.5, -0.5), point(0.5, 0.5, 0.5)), Sp(0.6),
        parent=world, transform=translate(1.0, 0.0, 3.0), material=absorbing())
    Ms(*scenes.icosphere(2, radius=0.4), closed=True, parent=world,
       transform=translate(0.0, 1.0, 3.0), material=absorbing())
    return world


@pytest.fixture(scope="module")
def facade_world():
    return _build_world(T.World, Sphere, Box, Subtract, Mesh, T.Point3D,
                        T.translate, AbsorbingSurface)


# 24 seeded rays from z = 0 towards +z (most miss), then one aimed at each
# primitive: the sphere, the CSG solid and the mesh
_FACADE_RNG = np.random.RandomState(7)
FACADE_O = np.r_[np.c_[_FACADE_RNG.uniform(-1.5, 1.5, (24, 2)), np.zeros(24)],
                 [[-1.0, 0.1, 0.0], [1.42, -0.42, 0.0], [0.05, 1.02, 0.0]]]
FACADE_D = np.r_[np.c_[_FACADE_RNG.uniform(-0.2, 0.2, (24, 2)), np.ones(24)],
                 [[0.02, 0.0, 1.0], [0.0, 0.003, 1.0], [0.01, -0.005, 1.0]]]
FACADE_P = np.asarray([[-1.0, 0.0, 3.0], [1.0, 0.0, 3.0], [0.0, 1.0, 3.0],
                       [1.45, 0.45, 3.45], [5.0, 5.0, 5.0]])


def _record(ix, prims):
    if ix is None:
        return None
    return dict(primitive=prims.index(ix.primitive), exiting=ix.exiting,
                t=ix.ray_distance, triangle=getattr(ix, "triangle", None),
                **{k: np.asarray([getattr(ix, k).x, getattr(ix, k).y,
                                  getattr(ix, k).z], np.float64)
                   for k in ("hit_point", "normal")})


def _compiled_query(fn):
    """``fn(scene, *rows)`` compiled once per scene (``jax_compiled``): the
    JAX package runs a one-ray query op by op, about a second each with a
    mesh in the world."""
    cache = {}

    def call(scene, *rows):
        if id(scene) not in cache:
            cache[id(scene)] = (scene, jax_compiled(
                lambda *a: fn(scene, *a), *rows))
        return cache[id(scene)][1](*rows)
    return call


@pytest.fixture(scope="module")
def jax_facade():
    """source_tpu.accel.KDTree built on the JAX package's copy of the
    world: its hit records for FACADE_O/D and contains lists (as primitive
    indices) for FACADE_P. ``World.hit``/``contains`` run as they are, with
    their scene queries compiled."""
    world = _build_world(S.World, JSphere, JBox, JSubtract, JMesh, S.Point3D,
                         S.translate, JAbsorbing)
    prims = world.primitives
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"), \
            pytest.MonkeyPatch.context() as mp:
        for name in ("intersect_scene", "entity_contains"):
            mp.setattr(jintersect, name,
                       _compiled_query(getattr(jintersect, name)))
        acc = jaccel.KDTree()
        acc.build(world)
        return (
            [_record(acc.hit(JRay(S.Point3D(*o), S.Vector3D(*d))), prims)
             for o, d in zip(FACADE_O, FACADE_D)],
            [[prims.index(q) for q in acc.contains(S.Point3D(*p))]
             for p in FACADE_P])


def _same_record(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got["primitive"] == ref["primitive"]
    assert got["exiting"] == ref["exiting"]
    for k in ("t", "hit_point", "normal"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    if got["triangle"] != ref["triangle"]:
        # a ray through an edge or a vertex: tied triangles, one hit point
        assert None not in (got["triangle"], ref["triangle"])
        np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)


@pytest.mark.parametrize("cls", [accel.KDTree, accel.Unaccelerated])
def test_facade_matches_world_queries(facade_world, jax_facade, cls):
    acc = cls(device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        acc.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1)))
    acc.build(facade_world)
    prims = facade_world.primitives
    assert [b.primitive for b in acc.bound_primitives] == prims
    ref_hits, ref_in = jax_facade
    hits = 0
    for o, d, ref in zip(FACADE_O, FACADE_D, ref_hits):
        ray = Ray(T.Point3D(*o), T.Vector3D(*d))
        got = acc.hit(ray)
        # against the JAX package's facade on the same world
        _same_record(_record(got, prims), ref)
        # and the same answer as the port's own World.hit
        own = facade_world.hit(ray, device="cpu")
        assert (got is None) == (own is None)
        if got is not None:
            assert (got.primitive, got.exiting, got.ray_distance,
                    got.hit_point.x, got.normal.x,
                    getattr(got, "triangle", None)) == (
                own.primitive, own.exiting, own.ray_distance,
                own.hit_point.x, own.normal.x, getattr(own, "triangle", None))
        hits += got is not None
    assert 3 < hits < len(FACADE_O)
    assert [r["primitive"] for r in ref_hits[-3:]] == [0, 1, 2]
    assert ref_hits[-1]["triangle"] is not None
    for p, ref in zip(FACADE_P, ref_in):
        p = T.Point3D(*p)
        got = acc.contains(p)
        assert [prims.index(q) for q in got] == ref
        assert got == facade_world.contains(p, device="cpu")
    assert len(acc.contains(T.Point3D(0.0, 1.0, 3.0))) == 1


def test_bound_primitive_box(facade_world):
    sphere = facade_world.primitives[0]
    bp = accel.BoundPrimitive(sphere)
    np.testing.assert_allclose(bp.box.lower, [-1.5, -0.5, 2.5], atol=1e-4)
    np.testing.assert_allclose(bp.box.upper, [-0.5, 0.5, 3.5], atol=1e-4)
    assert bp.box_hit(Ray(T.Point3D(-1, 0, 0), T.Vector3D(0, 0, 1)))
    assert not bp.box_hit(Ray(T.Point3D(3, 0, 0), T.Vector3D(0, 0, 1)))
    assert bp.contains(T.Point3D(-1.0, 0.2, 3.4))
