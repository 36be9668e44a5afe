"""The port's mesh file IO against source_tpu's, on the CPU.

  (a) every writer and reader of the port, on the bunny demo's stand-in
      mesh at 2 subdivisions (320 triangles): the mesh read back equals the
      mesh built from the written arrays, vertices and triangles exactly
      (STL welds its soup at 6 decimals: within 6e-7) and the BVH node for
      node;
  (b) across the packages: each writer of the two packages makes the same
      bytes from the same mesh, and each package reads the other's file
      into the same arrays bit for bit;
  (c) the native OBJ tokenizer and the Python reader agree (polygons,
      v//vn and v/vt/vn tokens, files with and without normals);
  (d) ``import_rsm`` refuses a bad header or version;
  (e) ``MeshData`` save/load, and a bundle the JAX package saved;
  (f) one traced batch of the bunny demo's small world (3 subdivisions,
      the mesh through ``export_ply``/``import_ply``, CSG glass light box) against
      the reference's ``trace_rays`` on its uniforms: 256 rays, 5 bins, 8
      bounces. The reference's compiled CPU step zeroes some CSG glass
      normals at LLVM's default level, so it is compiled at level 0;
  (g) ``scenes.bunny_world(small=True)`` compiles to the tables of the
      demo's own ``build_world(small=True)`` (3 bins): every table within
      rtol 1e-5 / atol 1e-6, the static structure and the mesh's arrays
      equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from source_tpu.primitive import Mesh as JMesh
from source_tpu.primitive.mesh import MeshData as JMeshData
from source_tpu.primitive.mesh import io as jio
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig, init_rays as jax_init_rays,
    trace_rays as jax_trace_rays,
)

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.primitive import Mesh
from source_tpu_torch.primitive.mesh import MeshData
from source_tpu_torch.primitive.mesh import io as tio

from test_torch_common import env, jax_compiled, to_jax

# (writer keyword arguments, reader) per format
FORMATS = {
    "obj": ("obj", {}, "native"),
    "obj_python": ("obj", {}, "python"),
    "stl_ascii": ("stl", {"mode": "ascii"}, None),
    "stl_binary": ("stl", {"mode": "binary"}, None),
    "ply_ascii": ("ply", {"mode": "ascii"}, None),
    "ply_binary": ("ply", {"mode": "binary"}, None),
    "vtk": ("vtk", {}, None),
    "rsm": ("rsm", {}, None),
}
BVH_FIELDS = ("node_lo", "node_hi", "node_skip", "node_first", "node_count",
              "order")


@pytest.fixture(scope="module")
def bunny():
    return scenes.bunny_mesh(2)


def _write(pkg, fmt, kw, mesh, path):
    getattr(pkg, f"export_{fmt}")(mesh, str(path), **kw)


def _read(pkg, fmt, reader, path):
    if reader == "python":
        return pkg._import_obj_python(str(path))
    if reader == "native":
        mesh = pkg._import_obj_native(str(path), 1.0)
        assert mesh is not None, "the native OBJ reader did not build"
        return mesh
    return getattr(pkg, f"import_{fmt}")(str(path))


def _assert_same_data(a, b, exact=True):
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=0, atol=6e-7)
    np.testing.assert_allclose(a.vertices[a.triangles], b.vertices[b.triangles],
                               **tol)
    if exact:
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.triangles, b.triangles)
    for k in BVH_FIELDS:
        x, y = getattr(a.bvh, k), getattr(b.bvh, k)
        if k in ("node_lo", "node_hi"):
            np.testing.assert_allclose(x, y, **tol, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.smoothing == b.smoothing and a.closed == b.closed


@pytest.mark.parametrize("name", list(FORMATS))
def test_round_trip(bunny, name, tmp_path):
    fmt, kw, reader = FORMATS[name]
    mesh = Mesh(*bunny)
    path = tmp_path / f"bunny.{fmt}"
    _write(tio, fmt, kw, mesh, path)
    back = _read(tio, fmt, reader, path).data
    direct = Mesh(mesh.data.vertices, mesh.data.triangles).data
    _assert_same_data(back, direct, exact=fmt != "stl")
    if fmt in ("obj", "rsm"):
        # the file carries the per-vertex normals
        np.testing.assert_allclose(back.vertex_normals, mesh.data.vertex_normals,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(FORMATS))
def test_files_across_packages(bunny, name, tmp_path):
    fmt, kw, reader = FORMATS[name]
    tm, jm = Mesh(*bunny), JMesh(*bunny)
    pt, pj = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    _write(tio, fmt, kw, tm, pt)
    _write(jio, fmt, kw, jm, pj)
    assert pt.read_bytes() == pj.read_bytes()
    # each package reads the other's file as the other does
    for path in (pt, pj):
        a = _read(tio, fmt, reader, path).data
        b = _read(jio, fmt, reader, path).data
        for k in ("vertices", "triangles", "vertex_normals", "face_normals"):
            np.testing.assert_array_equal(getattr(a, k), np.asarray(getattr(b, k)),
                                          err_msg=k)


_OBJ_POLYGONS = """# quads and a pentagon, v/vt/vn and v//vn tokens
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vt 0 0
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/1/1 3/1/1 4/1/1
f 4//2 3//2 5//2
f 1/1/1 2/1/1 3/1/1 5/1/2 4/1/2
"""

_OBJ_PLAIN = """v -1.5 0 2
v 1 0.25 2
v 0 1e-3 -2.5e1
v 3 3 3
f 1 2 3
f 2 3 4 1
"""


@pytest.mark.parametrize("text", [_OBJ_POLYGONS, _OBJ_PLAIN],
                         ids=["normals", "plain"])
def test_native_and_python_obj_readers_agree(text, tmp_path):
    path = tmp_path / "mesh.obj"
    path.write_text(text)
    a = tio._import_obj_native(str(path), 2.0)
    assert a is not None
    b = tio._import_obj_python(str(path), 2.0)
    for k in ("vertices", "triangles", "vertex_normals", "face_normals"):
        np.testing.assert_array_equal(getattr(a.data, k), getattr(b.data, k),
                                      err_msg=k)
    assert tio.import_obj(str(path), 2.0).data.n_triangles == a.data.n_triangles


def test_import_rsm_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad.rsm"
    bad.write_bytes(b"PLY\x01\x00")
    with pytest.raises(ValueError, match="not a Raysect mesh"):
        tio.import_rsm(str(bad))
    bad.write_bytes(b"RSM\x02\x00")
    with pytest.raises(ValueError, match="version"):
        tio.import_rsm(str(bad))
    with pytest.raises(ValueError, match="mode"):
        tio.export_ply(Mesh(*scenes.cube_mesh()), str(tmp_path / "x.ply"),
                       mode="text")


def test_mesh_data_save_load(bunny, tmp_path):
    data = MeshData(*bunny, closed=True)
    data.save(tmp_path / "port.npz")
    JMeshData(*bunny, closed=True).save(tmp_path / "jax.npz")
    for name in ("port.npz", "jax.npz"):
        back = MeshData.load(tmp_path / name)
        _assert_same_data(back, data)
        for k in ("face_normals", "vertex_normals"):
            np.testing.assert_array_equal(getattr(back, k), getattr(data, k))
        assert back.max_leaf == data.max_leaf


# --- (f) the bunny demo's world traced against the reference --------------------

CFG = dict(max_depth=8, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25, max_iters=8)
B = 5


def test_bunny_world_matches_the_demo():
    """The port's bunny world against demos/materials/bunny.py's own, each
    compiled by its package at 3 bins (the JAX compile resamples N-BK7
    eagerly); without the Stanford scan both build the stand-in."""
    import source_tpu as S
    from demos.materials import bunny
    from source_tpu_torch.bridge import ARRAY_FIELDS, MESH_ARRAYS

    assert not os.path.exists(bunny.BUNNY_PATH)
    js = S.compile_scene(bunny.build_world(small=True),
                         S.SpectralConfig(375.0, 740.0, 3))
    ts = T.compile_scene(scenes.bunny_world(small=True),
                         T.SpectralConfig(375.0, 740.0, 3), device="cpu")
    for k in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("n_leaves", "n_entities", "mat_types", "type_slices",
              "csg_entities", "mesh_entities"):
        assert getattr(ts, k) == getattr(js, k), k
    # the volume rows, their material objects (index 3) by class
    assert len(ts.volume_entities) == len(js.volume_entities) == 3
    for trow, jrow in zip(ts.volume_entities, js.volume_entities):
        assert trow[:3] + trow[4:] == jrow[:3] + jrow[4:]
        assert type(trow[3]).__name__ == type(jrow[3]).__name__
    (tm,), (jm,) = ts.meshes, js.meshes
    assert len(tm.triangles) == 1280
    for k in MESH_ARRAYS:
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tm.vertices.numpy(), np.asarray(jm.vertices))


def test_bunny_world_trace_matches_jax(tmp_path):
    """The world of demos/materials/bunny.py with its stand-in at 3
    subdivisions (``--small``), the mesh imported from the port's PLY file
    by both packages alike; the port's compiled scene handed to the JAX tracer (the
    JAX compile of N-BK7 resamples spectra eagerly for seconds)."""
    v, f = scenes.bunny_mesh(3)
    path = tmp_path / "bunny.ply"
    tio.export_ply(Mesh(v, f), str(path))
    a, b = tio.import_ply(str(path)).data, jio.import_ply(str(path)).data
    for k in ("vertices", "triangles", "vertex_normals"):
        np.testing.assert_array_equal(getattr(a, k), np.asarray(getattr(b, k)))

    ts = T.compile_scene(scenes.bunny_world(small=True),
                         T.SpectralConfig(375.0, 740.0, B), device="cpu")
    assert len(ts.meshes) == 1 and len(ts.csg_entities) >= 2
    np.testing.assert_array_equal(ts.meshes[0].vertices.numpy(), a.vertices)
    js = to_jax(ts)
    o, d = scenes.camera_rays(16, 16, **scenes.BUNNY_CAMERA)
    key = jax.random.PRNGKey(4)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        st = jax_init_rays(jnp.asarray(o), jnp.asarray(d), B)
        ref = jax_compiled(
            lambda st: jax_trace_rays(js, JaxRayConfig(**CFG), st, key), st)(st)

    def u_all(start, n_steps, n_lanes):
        u = jax.random.uniform(jax.random.fold_in(key, 0x7A000 + start),
                               (n_steps, n_lanes, 10), jnp.float32)
        return torch.from_numpy(np.array(u))

    got = T.render_batch(ts, T.RayConfig(**CFG), o, d, u_all=u_all,
                         device="cpu")
    same = ((got.alive.numpy() == np.asarray(ref.alive))
            & (got.depth.numpy() == np.asarray(ref.depth)))
    a, b = np.asarray(ref.radiance), got.radiance.numpy()
    same &= np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1)
    assert np.isfinite(b).all()
    # a lane aimed at a mesh edge may keep the other of two tied triangles
    # against XLA's rounding of t (tests/test_torch_mesh.py)
    assert (~same).sum() <= 1, np.nonzero(~same)
    assert abs(int(got.segments) - int(ref.segments)) <= 8
    assert float(b.sum()) > 0.0
