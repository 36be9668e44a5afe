"""The mesh path of source_tpu_torch against source_tpu, on the CPU.

The port runs the plain PyTorch version of its mesh kernel
(``mesh_intersect_plain``, ``device="cpu"``); inputs are made with numpy from
fixed seeds and handed to both packages, and every JAX reference is built
once per module (no interpret-mode Pallas call: the JAX package's CPU route
for a mesh is its XLA pointer walk).

  (a) ``MeshData``: vertices, triangle order, face and vertex normals and the
      BVH arrays equal to the JAX package's (both build through the same
      ``bvh.cpp``), with flipped normals and explicit normal ids; save/load.
  (b) ``woop_tri_test`` against the reference's, evaluated op by op: valid
      and front equal, t/u/v within 1 ulp.
  (c) ``mesh_intersect`` on icosphere(3), 1 024 scattered plus 512 edge- and
      vertex-aimed rays, with and without ``t_max``: tri, t, u, v and front
      bit for bit against the reference's Woop test evaluated op by op on
      every (ray, triangle) pair; against the reference's compiled walk, t
      within rtol 1e-6 on every lane, tri and front equal on every lane but
      the aimed lanes whose candidate triangles tie in t (within rtol 1e-6:
      XLA rounds t an ulp or two otherwise, and the strict t < t_best keeps
      another of the tied triangles; counted and printed), u/v within rtol
      1e-6 and atol 1.2e-7 (an ulp of the unit interval: against a u near 0
      XLA's rounding of the terms is large) on the lanes that agree.
  (c') the kernel's records (``pack_mesh_records``): every triangle reached
      once, leaf ranges in increasing order, each child's box and reference
      that of the threaded BVH, the depth within the stack; the kernel's
      walk in plain PyTorch (``ordered_walk_plain``, nearest child first
      under the (t, triangle id) rule) bit for bit equal to the brute force
      on every ico3 ray, with and without ``t_max``, and to
      ``mesh_intersect_plain`` on the watertight cases, with no leak; the
      records packed again after an in-place edit or a swap of the
      vertices, the triangles or a BVH table; the kernel's wrapper refuses
      CPU tensors.
  (d) no leak: the edge- and vertex-aimed rays of
      tests/test_mesh_watertight.py (the port's own copies) all hit, and
      march through the closed meshes with strictly alternating faces.
  (e) the gradient against the reference's VJP of ``mesh_intersect``
      (``_winners_bwd``, what ``jax.vjp`` calls, compiled with LLVM's
      optimisation off) with respect to vertices, origin and direction:
      rtol 1e-5.
  (f) ``compile_scene`` of the small mesh demo: every array equal, the mesh
      tables included; an emitting mesh's importance sphere within rtol
      1e-6; ``scene_from_numpy`` carries a mesh scene back and forth.
  (g) ``intersect_scene`` and ``entity_contains`` on that world against the
      JAX functions (compiled with LLVM's optimisation off, as in
      tests/test_torch_wavefront.py): hit, entity, tri and exiting equal,
      normals and points within rtol 1e-5.
  (h) the wavefront ``trace_rays`` of that world on the reference's
      uniforms: segments, alive and depth equal, radiance within rtol 1e-3 /
      atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.mesh_render import build_world as jax_mesh_world
import source_tpu as S
from source_tpu.optical.material.lambert import Lambert as JaxLambert
from source_tpu.primitive.mesh.data import MeshData as JaxMeshData
from source_tpu.tracer import meshtrace as JM
from source_tpu.tracer import watertight as JW
from source_tpu.tracer.intersect import (
    entity_contains as jax_contains, intersect_scene as jax_intersect,
)
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig, init_rays as jax_init_rays,
    trace_rays as jax_trace_rays,
)

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.bridge import ARRAY_FIELDS, MESH_ARRAYS, MESH_STATIC, STATIC_FIELDS
from source_tpu_torch.optical.material import Lambert
from source_tpu_torch.primitive import Mesh, MeshData
from source_tpu_torch.tracer import mesh_bvh as TB
from source_tpu_torch.tracer import meshtrace as TM
from source_tpu_torch.tracer import watertight as TW
from source_tpu_torch.tracer.intersect import entity_contains, intersect_scene

from test_torch_common import B, carry_scene, env, jax_compiled, to_jax

SPECTRAL = (375.0, 740.0, B)
IDENTITY = np.eye(4)
SCATTERED = 1024  # rays of ``ico3`` before the edge- and vertex-aimed ones


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


# --- (a) MeshData -------------------------------------------------------------------


def _mesh_inputs(name):
    if name == "icosphere2":
        v, f = scenes.icosphere(2, 0.8)
        return (v, f), {}
    if name == "knot_flipped":
        v, f = scenes.torus_knot(segments=64, sides=8)
        return (v, f), dict(flip_normals=True, smoothing=False)
    # explicit per-corner normals through normal ids ([T, 6] triangles)
    v, f = scenes.icosphere(1)
    rng = np.random.RandomState(4)
    normals = (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    ids = rng.randint(0, len(v), f.shape).astype(np.int32)
    return (v, np.concatenate([f, ids], axis=1)), dict(normals=normals)


@pytest.mark.parametrize("name", ["icosphere2", "knot_flipped", "normal_ids"])
def test_mesh_data_matches_jax(name, tmp_path):
    args, kw = _mesh_inputs(name)
    jd, td = JaxMeshData(*args, **kw), MeshData(*args, **kw)
    for k in ("vertices", "triangles", "face_normals", "vertex_normals"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k), err_msg=k)
    for k in ("node_lo", "node_hi", "node_skip", "node_first", "node_count",
              "order"):
        np.testing.assert_array_equal(getattr(td.bvh, k), getattr(jd.bvh, k),
                                      err_msg=k)
    assert (td.max_leaf, td.smoothing, td.closed) == (
        jd.max_leaf, jd.smoothing, jd.closed)
    td.save(tmp_path / "mesh.npz")
    back = MeshData.load(tmp_path / "mesh.npz")
    for k in ("vertices", "triangles", "face_normals", "vertex_normals"):
        np.testing.assert_array_equal(getattr(back, k), getattr(td, k))
    np.testing.assert_array_equal(back.bvh.node_skip, td.bvh.node_skip)
    assert back.max_leaf == td.max_leaf and back.smoothing == td.smoothing


def test_mesh_validation_and_instances():
    v, f = scenes.icosphere(1)
    with pytest.raises(ValueError):
        MeshData(v[:, :2], f)
    with pytest.raises(ValueError):
        MeshData(v, f + len(v))
    world = T.World()
    m = Mesh(v, f, parent=world, transform=T.translate(1, 2, 3),
             material=Lambert())
    twin = m.instance(parent=world, transform=T.translate(-1, 0, 0))
    assert twin.data is m.data and twin.material is m.material
    lo, hi = m.bounding_box()
    np.testing.assert_allclose(lo, [0, 1, 2], atol=1e-4)
    np.testing.assert_allclose(hi, [2, 3, 4], atol=1e-4)
    centre, radius = m.bounding_sphere()
    assert abs(centre.x - 1.0) < 1e-4 and radius >= 3 ** 0.5


# --- (b) the Woop test ---------------------------------------------------------------


def test_woop_tri_test_matches_jax():
    rng = np.random.RandomState(1)
    n = 4096
    tri = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # half aimed inside the triangle, a quarter at an edge, a quarter at a
    # vertex
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    w[n // 2:3 * n // 4, 0] = 0.0
    w[n // 2:3 * n // 4] /= w[n // 2:3 * n // 4].sum(1, keepdims=True)
    w[3 * n // 4:] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n // 4)]
    d = (w[:, :, None] * tri).sum(1) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    comps = [tri[:, i, j] for i in range(3) for j in range(3)]
    ref = JW.woop_tri_test(JW.woop_setup(*[jnp.asarray(x) for x in (*o.T, *d.T)]),
                           *[jnp.asarray(c) for c in comps], jnp.asarray(t_min))
    got = TW.woop_tri_test(TW.woop_setup(*[torch.from_numpy(x.copy())
                                           for x in (*o.T, *d.T)]),
                           *[torch.from_numpy(c.copy()) for c in comps],
                           torch.from_numpy(t_min))
    t_r, u_r, v_r, f_r, ok_r = (np.asarray(x) for x in ref)
    t_g, u_g, v_g, f_g, ok_g = (x.numpy() for x in got)
    np.testing.assert_array_equal(ok_g, ok_r)
    np.testing.assert_array_equal(f_g, f_r)
    for a, b in ((t_g, t_r), (u_g, u_r), (v_g, v_r)):
        fin = np.isfinite(b)
        np.testing.assert_array_max_ulp(a[fin], b[fin], maxulp=1)
    assert ok_r.mean() > 0.4


# --- (c) mesh_intersect ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ico3():
    """icosphere(3) in both packages, its rays, and the reference's nearest
    hits (its XLA walk compiled once, with and without t_max)."""
    v, f = scenes.icosphere(3, 1.0)
    jt = JaxMeshData(v, f, smoothing=True, closed=True).to_tables(IDENTITY,
                                                                 IDENTITY)
    tt = MeshData(v, f, smoothing=True, closed=True).to_tables(IDENTITY,
                                                              IDENTITY)
    rng = np.random.RandomState(0)
    n = SCATTERED
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 2] = -3.0
    tgt = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    # edge midpoints and vertices of the mesh itself, from outside
    corners = v[f[:256, 0]]
    edges = 0.5 * (v[f[256:512, 0]] + v[f[256:512, 1]])
    o_a = np.concatenate([corners, edges]) * 3.0 + rng.normal(
        scale=0.2, size=(512, 3)).astype(np.float32)
    o = np.concatenate([o, o_a]).astype(np.float32)
    tgt = np.concatenate([tgt, corners, edges])
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.full(len(o), 1e-4, np.float32)
    t_max = rng.uniform(2.0, 3.5, len(o)).astype(np.float32)
    args = tuple(jnp.asarray(x) for x in (o, d, t_min, t_max))
    ref = jax_compiled(lambda o, d, a: JM.mesh_intersect(jt, o, d, a),
                       *args[:3])(*args[:3])
    ref_cut = jax_compiled(lambda o, d, a, b: JM.mesh_intersect(jt, o, d, a, b),
                           *args)(*args)
    # the reference's Woop test evaluated op by op on every (ray, triangle)
    # pair, triangles in leaf order: [N, T] each of t, u, v, front, valid
    tris = tt.triangles.numpy()
    s = JW.woop_setup(*[jnp.asarray(x)[:, None] for x in (*o.T, *d.T)])
    verts = [jnp.asarray(v[tris[:, j], k])[None] for j in range(3)
             for k in range(3)]
    woop = [np.asarray(x) for x in JW.woop_tri_test(
        s, *verts, jnp.asarray(t_min)[:, None])]
    return dict(jt=jt, tt=tt, v=v, f=f, o=o, d=d, t_min=t_min, t_max=t_max,
                ref=_np(ref), ref_cut=_np(ref_cut), woop=woop)


def _brute_force(c, cut):
    """The nearest valid hit of ``c["woop"]`` per ray, the first minimum in
    leaf order, which is the walk's winner (it visits the leaves in that
    order and takes a triangle under the strict t < t_best). Returns the
    winning tri, the [N, T] matrix of t and the winner's t, u, v, front."""
    res = c["woop"]
    ok = res[4] & (res[0] < c["t_max"][:, None]) if cut else res[4]
    t = np.where(ok, res[0], np.inf)
    tri = np.argmin(t, axis=1)
    lanes = np.arange(len(t))
    tri = np.where(np.isfinite(t[lanes, tri]), tri, -1)
    return tri, t, [r[lanes, np.maximum(tri, 0)] for r in res[:4]]


@pytest.mark.parametrize("cut", [False, True])
def test_mesh_intersect_matches_jax(ico3, cut):
    c = ico3
    ref = c["ref_cut"] if cut else c["ref"]
    got = TM.mesh_intersect(c["tt"], *(torch.from_numpy(c[k]) for k in (
        "o", "d", "t_min")), torch.from_numpy(c["t_max"]) if cut else None)
    got = {k: x.numpy() for k, x in got.items()}
    hit = got["tri"] >= 0
    assert np.isinf(got["t"][~hit]).all()
    # bit for bit: the reference's own Woop test over every triangle
    tri_x, t_all, (t_x, u_x, v_x, f_x) = _brute_force(c, cut)
    np.testing.assert_array_equal(got["tri"], tri_x)
    for k, x in (("t", t_x), ("u", u_x), ("v", v_x), ("front", f_x)):
        np.testing.assert_array_equal(got[k][hit], x[hit], err_msg=k)
    # the reference's compiled walk: every lane chooses alike, except rays
    # aimed at an edge or a vertex whose triangles tie in t (XLA rounds t an
    # ulp or two otherwise than op-by-op evaluation, and the strict t <
    # t_best then keeps another of the tied triangles)
    same = got["tri"] == ref["tri"]
    lanes = np.nonzero(~same)[0]
    print(f"{len(lanes)} of {len(same)} lanes take another of tied "
          f"triangles; all beyond the {SCATTERED} scattered rays")
    assert (lanes >= SCATTERED).all()
    np.testing.assert_allclose(t_all[lanes, ref["tri"][lanes]],
                               t_all[lanes, got["tri"][lanes]], rtol=1e-6)
    np.testing.assert_array_equal(got["front"][same], ref["front"][same])
    np.testing.assert_allclose(got["t"][hit], ref["t"][hit], rtol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][same & hit], ref[k][same & hit],
                                   rtol=1e-6, atol=1.2e-7, err_msg=k)
    if cut:
        assert (got["t"][hit] < c["t_max"][hit]).all()
        assert hit.sum() < (c["ref"]["tri"] >= 0).sum()


def test_plain_walk_counts(ico3):
    c = ico3
    out = TM.mesh_intersect_plain(c["tt"], *(torch.from_numpy(c[k]) for k in (
        "o", "d", "t_min")))
    nv, tt = out["nodes_visited"].numpy(), out["tris_tested"].numpy()
    assert (nv >= 1).all() and (tt >= (out["tri"].numpy() >= 0)).all()
    # a 1 280-triangle tree: a hit walks a few dozen nodes, not the tree
    assert nv.mean() < c["tt"].n_nodes / 4
    # the records read: the root, every winner, no more than were tested
    nt, tr = out["nodes_touched"].numpy(), out["tris_touched"].numpy()
    win = out["tri"].numpy()
    assert nt[0] and tr[win[win >= 0]].all()
    assert nt.sum() <= min(nv.sum(), len(nt)) and tr.sum() <= tt.sum()


# --- (c') the kernel's records and walk ---------------------------------------------


def test_packed_records_follow_the_threaded_bvh(ico3):
    tt = ico3["tt"]
    rec = tt.records.current(tt)
    nodes, bits = rec.nodes.numpy(), rec.nodes.view(torch.int32).numpy()
    lo, hi = tt.node_lo.numpy(), tt.node_hi.numpy()
    skip, first = tt.node_skip.numpy(), tt.node_first.numpy()
    count = tt.node_count.numpy()
    leaves, deepest = [], 0
    # (row, child slot, threaded node, depth): the root sits in row 0 slot 0
    todo = [(0, 0, 0, 0)]
    while todo:
        r, c, n, depth = todo.pop()
        col = 8 * c
        np.testing.assert_array_equal(nodes[r, col:col + 3], lo[n])
        np.testing.assert_array_equal(nodes[r, col + 4:col + 7], hi[n])
        ref, cnt = bits[r, col + 3], bits[r, col + 7]
        assert cnt == count[n]
        if cnt > 0:
            assert ~ref == first[n]
            leaves.append((~ref, cnt))
            deepest = max(deepest, depth)
            continue
        assert ref > 0
        todo += [(ref, 1, skip[n + 1], depth + 1), (ref, 0, n + 1, depth + 1)]
    assert len(leaves) == int((count > 0).sum()) == nodes.shape[0]
    starts = np.array([f for f, _ in leaves])
    ends = np.array([f + c for f, c in leaves])
    # child 0 first, in DFS order: contiguous increasing ranges over all T
    assert starts[0] == 0 and ends[-1] == tt.n_triangles
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert rec.depth == deepest <= TB.STACK
    want = tt.vertices.numpy()[tt.triangles.numpy()]
    tri = rec.tris.numpy().reshape(-1, 3, 4)
    np.testing.assert_array_equal(tri[..., :3], want)
    assert (tri[..., 3] == 0).all()
    assert rec.nbytes == 4 * (nodes.size + tri.size)


@pytest.mark.parametrize("cut", [False, True])
def test_ordered_walk_keeps_the_first_nearest_triangle(ico3, cut):
    c = ico3
    tt = c["tt"]
    got = TB.ordered_walk_plain(
        tt.records.current(tt), *(torch.from_numpy(c[k]) for k in (
            "o", "d", "t_min")), torch.from_numpy(c["t_max"]) if cut else None)
    got = {k: x.numpy() for k, x in got.items()}
    tri_x, _, (t_x, u_x, v_x, f_x) = _brute_force(c, cut)
    np.testing.assert_array_equal(got["tri"], tri_x)
    hit = tri_x >= 0
    assert np.isinf(got["t"][~hit]).all()
    for k, x in (("t", t_x), ("u", u_x), ("v", v_x), ("front", f_x)):
        np.testing.assert_array_equal(got[k][hit], x[hit], err_msg=k)
    # nearest child first reads fewer records than the threaded walk
    old = TM.mesh_intersect_plain(tt, *(torch.from_numpy(c[k]) for k in (
        "o", "d", "t_min")), torch.from_numpy(c["t_max"]) if cut else None)
    assert got["tris_tested"].sum() < old["tris_tested"].sum()
    assert got["node_fetches"].sum() < old["nodes_visited"].sum()
    assert (got["sectors"] >= got["node_fetches"]).all()
    # the records read at least once: the root's row, no more than fetched
    assert bool(got["rows_touched"][0])
    assert got["rows_touched"].sum() <= got["node_fetches"].sum()
    assert 0 < got["tris_touched"].sum() <= got["tris_tested"].sum()


@pytest.mark.parametrize("case", ["cube", "cube_axis", "blob"])
def test_ordered_walk_never_leaks(case):
    name, v, f, o, d = [c for c in scenes.watertight_cases() if c[0] == case][0]
    tables = MeshData(v, f, smoothing=False, closed=True).to_tables(IDENTITY,
                                                                    IDENTITY)
    o, d = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    t_min = torch.zeros(len(o))
    got = TB.ordered_walk_plain(tables.records.current(tables), o, d, t_min)
    want = TM.mesh_intersect_plain(tables, o, d, t_min)
    assert bool((got["tri"] >= 0).all())
    for k in ("t", "tri", "u", "v", "front"):
        assert torch.equal(got[k], want[k]), k


def test_records_repacked_after_vertex_edit(ico3):
    tt = ico3["tt"]
    mesh = dataclasses.replace(tt, vertices=tt.vertices.clone(),
                               records=TB.MeshRecords())
    rec = mesh.records.current(mesh)
    nodes, tris = rec.nodes, rec.tris
    # a copy as _MeshIntersect makes it shares the records: nothing repacked
    twin = dataclasses.replace(mesh, vertices=mesh.vertices.detach())
    assert twin.records is rec
    assert twin.records.current(twin).tris is tris
    with torch.no_grad():
        mesh.vertices[:, 0] += 0.25
    assert rec.current(twin).tris is not tris
    want = mesh.vertices.numpy()[mesh.triangles.numpy()]
    np.testing.assert_array_equal(
        rec.tris.numpy().reshape(-1, 3, 4)[..., :3], want)
    np.testing.assert_array_equal(rec.nodes.numpy(), nodes.numpy())
    # the original tables keep their own records
    assert tt.records is not rec


@pytest.mark.parametrize("table", ["triangles", "node_hi", "node_skip"])
def test_records_repacked_after_table_edit(ico3, table):
    tt = ico3["tt"]
    mesh = dataclasses.replace(tt, **{table: getattr(tt, table).clone()},
                               records=TB.MeshRecords())
    rec = mesh.records.current(mesh)
    nodes, tris = rec.nodes, rec.tris
    assert rec.current(mesh).nodes is nodes
    # an edit in place that keeps the tree valid: a triangle's vertices
    # rotated, the root's box grown, the last node's skip link written again
    x = getattr(mesh, table)
    with torch.no_grad():
        if table == "triangles":
            x[0] = x[0].roll(1)
        elif table == "node_hi":
            x[0] += 1.0
        else:
            x[-1] = x[-1].clone()
    assert rec.current(mesh).nodes is not nodes
    want_n, want_t, _ = TB.pack_mesh_records(mesh)
    # as bits: a leaf's reference ~first reads as a NaN
    for got, want in ((rec.nodes, want_n), (rec.tris, want_t)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # swapping the table for another tensor repacks too
    nodes = rec.nodes
    swapped = dataclasses.replace(mesh, **{table: x.clone()})
    assert swapped.records is rec
    assert rec.current(swapped).nodes is not nodes


def test_mesh_kernel_wrapper_refuses_cpu_tensors(ico3):
    c = ico3
    with pytest.raises(ValueError, match="CUDA"):
        TB.mesh_bvh_winner(c["tt"], *(torch.from_numpy(c[k]) for k in (
            "o", "d", "t_min")))


# --- (d) watertightness --------------------------------------------------------------------


def _march(tables, o, d, steps=12):
    """Successive crossings along each ray: (hit, front, t) per step."""
    o = torch.from_numpy(o.copy())
    d = torch.from_numpy(d.copy())
    t_min = torch.zeros(len(o))
    seq = []
    for _ in range(steps):
        r = TM.mesh_intersect(tables, o, d, t_min)
        hit = r["tri"] >= 0
        if not bool(hit.any()):
            break
        seq.append((hit.numpy(), r["front"].numpy(), r["t"].numpy()))
        t = torch.where(hit, r["t"], 0.0)
        t_min = torch.where(hit, t + 1e-4 * (1.0 + t.abs()), torch.inf)
    return seq


@pytest.mark.parametrize("case", ["cube", "cube_axis", "blob"])
def test_aimed_rays_never_leak(case):
    name, v, f, o, d = [c for c in scenes.watertight_cases() if c[0] == case][0]
    tables = MeshData(v, f, smoothing=False, closed=True).to_tables(IDENTITY,
                                                                    IDENTITY)
    seq = _march(tables, o, d)
    hit0, _, t0 = seq[0]
    assert hit0.all(), o[~hit0]
    if case == "cube_axis":
        np.testing.assert_allclose(t0, 4.0, atol=1e-3)
    if case != "blob":  # the cube's rays may only touch it at a corner
        return
    # through the closed surface and out: front, back, front, back...
    for lane in range(len(o)):
        fronts = [fr[lane] for h, fr, _ in seq if h[lane]]
        assert len(fronts) % 2 == 0, (lane, fronts)
        assert fronts == [k % 2 == 0 for k in range(len(fronts))], (lane, fronts)


# --- (e) the gradient ---------------------------------------------------------------------


def test_mesh_intersect_gradient_matches_jax_vjp(ico3):
    c = ico3
    n = SCATTERED
    o, d, t_min = c["o"][:n], c["d"][:n], c["t_min"][:n]
    rng = np.random.RandomState(2)
    g = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    hit = c["ref"]["tri"][:n] >= 0
    g[0] = np.where(hit, g[0], 0.0).astype(np.float32)

    # jax.vjp's backward of the reference's mesh_intersect is its custom VJP
    # rule ``_winners_bwd`` on the forward's residuals; compiled with LLVM's
    # optimisation off (at XLA's default level the jitted jnp.cross is
    # contracted into FMAs, which moves the cotangents of grazing lanes by
    # 1e-4)
    float0 = np.zeros(n, dtype=jax.dtypes.float0)

    def rule(verts, o, d, tri, front, g_t, g_u, g_v):
        res = (dataclasses.replace(c["jt"], vertices=verts), o, d,
               jnp.asarray(t_min), tri, front)
        mesh_ct, o_ct, d_ct, _ = JM._winners_bwd(
            res, {"t": g_t, "u": g_u, "v": g_v, "tri": float0,
                  "front": float0})
        return mesh_ct.vertices, o_ct, d_ct

    args = (c["jt"].vertices, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(c["ref"]["tri"][:n]), jnp.asarray(c["ref"]["front"][:n]),
            *[jnp.asarray(x) for x in g])
    ref = [np.asarray(x) for x in jax_compiled(rule, *args)(*args)]

    verts = c["tt"].vertices.clone().requires_grad_(True)
    tables = dataclasses.replace(c["tt"], vertices=verts)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    r = TM.mesh_intersect(tables, ot, dt, torch.from_numpy(t_min))
    loss = sum((torch.where(torch.isfinite(r[k]), r[k], 0.0)
                * torch.from_numpy(gk)).sum() for k, gk in zip("tuv", g))
    got = torch.autograd.grad(loss, [verts, ot, dt])
    for name, a, b in zip(("vertices", "origin", "direction"), got, ref):
        assert np.isfinite(b).all() and np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


# --- (f) compile_scene, (g) intersect_scene, (h) trace_rays ------------------------------------


@pytest.fixture(scope="module")
def world():
    """The small mesh demo compiled by the port, and the same tables as a
    JAX scene."""
    ts = T.compile_scene(scenes.mesh_world(small=True),
                         T.SpectralConfig(*SPECTRAL), device="cpu")
    return ts, to_jax(ts)


def _demo_rays(width=32, height=16):
    cam = dict(scenes.MESH_CAMERA, width=width, height=height)
    return scenes.camera_rays(**cam)


def test_compile_mesh_world_matches_jax():
    """Each package compiles the small mesh demo from its own scenegraph
    classes (every material a Lambert: spectral baking is held to the
    reference in tests/test_torch_compile.py)."""
    jw = jax_mesh_world(small=True)
    for prim in jw.primitives:
        prim.material = JaxLambert()
    tw = scenes.mesh_world(small=True)
    for prim in tw.primitives:
        prim.material = Lambert()
    js = S.compile_scene(jw, S.SpectralConfig(*SPECTRAL))
    ts = T.compile_scene(tw, T.SpectralConfig(*SPECTRAL), device="cpu")
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in STATIC_FIELDS:
        a, b = getattr(js, k), getattr(ts, k)
        if k == "volume_entities":
            a, b = [tuple(r[:3] + r[4:] for r in x) for x in (a, b)]
        assert a == b, k
    for k, v in js.leaf_bvh.items():
        np.testing.assert_array_equal(ts.leaf_bvh[k].numpy(), np.asarray(v))
    assert len(ts.meshes) == len(js.meshes) == 2
    for jm, tm in zip(js.meshes, ts.meshes):
        for k in MESH_ARRAYS:
            np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                          np.asarray(getattr(jm, k)), err_msg=k)
        for k in MESH_STATIC:
            assert getattr(tm, k) == getattr(jm, k), k


def test_mesh_importance_sphere_matches_jax():
    """A mesh that emits is an importance target: its bounding sphere (from
    ``Mesh.bounding_sphere``, in the world frame) equal to the JAX
    package's."""
    from source_tpu.optical import ConstantSF as JaxConstantSF
    from source_tpu.optical.material import (
        UniformSurfaceEmitter as JaxEmitter,
    )
    from source_tpu.primitive import Mesh as JaxMesh
    from source_tpu_torch.optical import ConstantSF
    from source_tpu_torch.optical.material import UniformSurfaceEmitter
    v, f = scenes.torus_knot(segments=32, sides=6)
    jw, tw = S.World(), T.World()
    JaxMesh(v, f, closed=True, parent=jw, material=JaxEmitter(JaxConstantSF(2.0)),
            transform=S.translate(0.5, -1.0, 2.0) * S.rotate(20, 30, 0))
    Mesh(v, f, closed=True, parent=tw, material=UniformSurfaceEmitter(ConstantSF(2.0)),
         transform=T.translate(0.5, -1.0, 2.0) * T.rotate(20, 30, 0))
    js = S.compile_scene(jw, S.SpectralConfig(*SPECTRAL))
    ts = T.compile_scene(tw, T.SpectralConfig(*SPECTRAL), device="cpu")
    assert ts.has_importance and js.has_importance and ts.n_leaves == 0
    for k in ("imp_centre", "imp_radius", "imp_weight", "imp_cdf"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-6,
                                   err_msg=k)


def test_scene_from_numpy_carries_meshes(world):
    ts, js = world
    back = carry_scene(js)
    assert back.mesh_entities == ts.mesh_entities
    for a, b in zip(back.meshes, ts.meshes):
        for k in MESH_ARRAYS:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        for k in MESH_STATIC:
            assert getattr(a, k) == getattr(b, k)
    o, d = (torch.from_numpy(x) for x in _demo_rays(8, 8))
    r1 = intersect_scene(back, o, d, need_grad=False)
    r2 = intersect_scene(ts, o, d, need_grad=False)
    assert torch.equal(r1.tri, r2.tri) and torch.equal(r1.t, r2.t)


@pytest.fixture(scope="module")
def world_refs(world):
    """The reference's intersect_scene and entity_contains on the world."""
    ts, js = world
    o, d = _demo_rays()
    rng = np.random.RandomState(6)
    pts = np.concatenate([
        rng.uniform([-2.0, -0.2, -1.5], [2.5, 2.0, 1.5], (512, 3)),
        # along the meshes' local axes, where the +z probe grazes
        np.asarray([[-1.1, 0.8, 0.0], [1.2, 0.9, 0.3]]) + rng.normal(
            scale=0.3, size=(2, 3))]).astype(np.float32)
    args = tuple(jnp.asarray(x) for x in (o, d, pts))
    with env(SOURCE_TPU_LEAF_BVH="0"):
        rec, inside = jax_compiled(
            lambda o, d, p: (jax_intersect(js, o, d), jax_contains(js, p)),
            *args)(*args)
    return o, d, pts, jax.tree_util.tree_map(np.asarray, rec), np.asarray(inside)


@pytest.mark.parametrize("need_grad", [False, True])
def test_intersect_scene_matches_jax(world, world_refs, need_grad):
    ts, _ = world
    o, d, _, ref, _ = world_refs
    got = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                          need_grad=need_grad)
    for k in ("hit", "entity", "tri", "exiting"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref, k),
                                      err_msg=k)
    h = ref.hit
    on_mesh = ref.tri >= 0
    assert on_mesh.sum() > len(o) // 8 and h.all()
    for k in ("normal", "point", "bary_u", "bary_v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[h],
                                   getattr(ref, k)[h], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_entity_contains_matches_jax(world, world_refs):
    ts, _ = world
    pts, inside = world_refs[2], world_refs[4]
    got = entity_contains(ts, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, inside)
    assert got[:, :2].any(0).all()  # both meshes contain some points


def test_trace_rays_matches_jax(world):
    """The wavefront route through both meshes on the reference's uniforms:
    512 rays, 5 bins, 8 bounces."""
    ts, js = world
    o, d = _demo_rays()
    cfg = dict(max_depth=8, extinction_prob=0.1, extinction_min_depth=3,
               importance_sampling=True, important_path_weight=0.25,
               max_iters=8)
    key = jax.random.PRNGKey(9)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        st = jax_init_rays(jnp.asarray(o), jnp.asarray(d), B)
        ref = jax_compiled(
            lambda st: jax_trace_rays(js, JaxRayConfig(**cfg), st, key), st)(st)

    def u_all(start, n_steps, n_lanes):
        u = jax.random.uniform(jax.random.fold_in(key, 0x7A000 + start),
                               (n_steps, n_lanes, 10), jnp.float32)
        return torch.from_numpy(np.array(u))

    got = T.render_batch(ts, T.RayConfig(**cfg), o, d, u_all=u_all,
                         device="cpu")
    assert int(got.segments) == int(ref.segments)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    a, b = np.asarray(ref.radiance), got.radiance.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    assert float(b.sum()) > 0.0
