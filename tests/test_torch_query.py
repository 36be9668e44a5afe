"""The port's per-ray entry points against source_tpu's, on the CPU.

The port answers on CPU tensors (``device="cpu"``), where its kernel
wrappers take their plain versions; the reference runs with
SOURCE_TPU_LEAF_BVH=0 (its streaming route) and SOURCE_TPU_FUSED=0. Each
reference world is built and compiled once per module: its first
``World.hit`` costs seconds, later ones a few hundredths.

  (a) the core ``Ray``, ``Intersection`` and the unit helpers;
  (b) ``World.hit`` on the solid of demos/core/ray_intersection_hitpoints.py
      (a box with a sphere cut out) for 32 rays, unnormalised directions
      and misses among them: hit, t, exiting, the hit, inside and outside
      points and the normal within 1e-5, the same primitive; the demo's
      walk through ``World.hit`` and the ``Primitive.hit`` /
      ``next_intersection`` cursor along it;
  (c) ``World.contains`` and ``Primitive.contains`` on a 64-point grid:
      equal; the query scene is compiled again after a geometry change;
  (d) ``World.hit`` on a closed icosphere mesh: a ``MeshIntersection`` with
      the reference's triangle and barycentrics (another triangle only at a
      tie in t, as tests/test_torch_mesh.py allows), and ``contains``;
  (e) ``trace_rays_logged`` on the lens of demos/optics/logging_trajectories.py
      with the reference's per-bounce uniforms injected: ids and flags
      equal, continuous fields within 1e-5, ``reconstruct_trajectories``
      equal; ``LoggingRay`` on tests/test_core_utils.py's mirror scene with
      that test's assertions;
  (f) ``optical.Ray.sample``: the unity furnace exactly 1.0 in every bin,
      and on the Cornell box the mean within 4 standard errors of the
      reference's.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world as jax_cornell_world
import source_tpu as S
from source_tpu.core import Ray as JRay
from source_tpu.core.math import units as JU
from source_tpu.optical import ConstantSF as JConstantSF
from source_tpu.optical import Ray as JOpticalRay
from source_tpu.optical.material import (
    AbsorbingSurface as JAbsorbing, Dielectric as JDielectric,
)
from source_tpu.primitive import (
    BiConvex as JBiConvex, Box as JBox, Mesh as JMesh, Sphere as JSphere,
    Subtract as JSubtract,
)
from source_tpu.tracer import wavefront as JW

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.core import Intersection, Ray
from source_tpu_torch.core.math import units as TU
from source_tpu_torch.optical import LoggingRay
from source_tpu_torch.optical import Ray as OpticalRay
from source_tpu_torch.optical.material import (
    AbsorbingSurface, PerfectReflectingSurface, UnitySurfaceEmitter,
)
from source_tpu_torch.primitive import Box, Mesh, MeshIntersection, Sphere
from source_tpu_torch.tracer import wavefront as TW

from test_torch_common import env, jax_compiled

TOL = 1e-5
REF_ENV = dict(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0")


def _xyz(v):
    return np.asarray([v.x, v.y, v.z], np.float64)


# --- (a) core Ray, Intersection, units -------------------------------------------


def test_core_ray_point_on_copy_and_validation():
    r = Ray(T.Point3D(1, 2, 3), T.Vector3D(0, 0, 2), max_distance=5.0)
    p = r.point_on(2.0)
    assert (p.x, p.y, p.z) == (1, 2, 7)
    c = r.copy()
    assert c.max_distance == 5.0 and c.origin is not r.origin
    assert _xyz(c.direction).tolist() == [0, 0, 2]
    with pytest.raises(ValueError):
        Ray(max_distance=0.0)
    assert r.__getstate__()[2] == 5.0


def test_intersection_record_fields():
    ix = Intersection("ray", 1.5, "prim", 1, 2, 3, 4, True, 5, 6)
    assert (ix.ray_distance, ix.primitive, ix.exiting) == (1.5, "prim", True)
    m = MeshIntersection("ray", 1.0, "mesh", 1, 2, 3, 4, False, 5, 6,
                         triangle=7, u=0.25, v=0.5, w=0.25)
    assert isinstance(m, Intersection)
    assert (m.triangle, m.u, m.v, m.w) == (7, 0.25, 0.5, 0.25)


@pytest.mark.parametrize("name", JU.__all__)
def test_units_match_reference(name):
    for v in (1.0, 2.5, math.pi):
        assert getattr(TU, name)(v) == getattr(JU, name)(v)
    assert getattr(T.core, name) is getattr(TU, name)


def test_units_reference_semantics():
    # units.pyx:135: radians in, degrees out
    assert TU.radian(math.pi) == pytest.approx(180.0)
    assert TU.degree(180.0) == pytest.approx(math.pi)
    assert TU.mm(10) == pytest.approx(0.01) and TU.km(1) == 1000.0


# --- (b) World.hit and the next_intersection walk ----------------------------------


def _jax_hitpoints():
    w = S.World()
    solid = JSubtract(JBox(S.Point3D(-0.5, -0.5, -0.5), S.Point3D(0.5, 0.5, 0.5)),
                      JSphere(0.6), parent=w, transform=S.translate(0, 0, 2),
                      material=JAbsorbing())
    return w, solid


N_RAYS = 32
_RNG = np.random.default_rng(12)
# from in front of the solid, aimed at it (some miss), directions not unit
# length; the last eight start inside the box's corners or the cut-out
_O = np.concatenate([
    np.c_[_RNG.uniform(-0.7, 0.7, (24, 2)), np.full(24, -2.0)],
    np.c_[_RNG.choice([-0.45, 0.45], (8, 2)), _RNG.uniform(1.6, 2.4, 8)]])
_D = np.c_[_RNG.uniform(-0.15, 0.15, (N_RAYS, 2)), np.ones(N_RAYS)]
_D *= _RNG.uniform(0.5, 3.0, (N_RAYS, 1))


def _record(ix, prims):
    if ix is None:
        return None
    return dict(t=ix.ray_distance, exiting=ix.exiting,
                primitive=prims.index(ix.primitive),
                **{k: _xyz(getattr(ix, k)) for k in
                   ("hit_point", "inside_point", "outside_point", "normal")})


def _same_record(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got["exiting"] == ref["exiting"]
    assert got["primitive"] == ref["primitive"]
    for k in ("t", "hit_point", "inside_point", "outside_point", "normal"):
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def _walk(world, solid, o, d, make_ray, point, vector, **kw):
    """The demo's walk (World.hit, relaunching from the inside or outside
    point), then the Primitive.hit / next_intersection cursor."""
    prims = world.primitives
    ray = make_ray(point(*o), vector(*d))
    walk = []
    while len(walk) < 8:
        ix = world.hit(ray, **kw)
        if ix is None:
            break
        walk.append(_record(ix, prims))
        p2w = ix.primitive_to_world
        ray = make_ray((ix.outside_point if ix.exiting else ix.inside_point)
                       .transform(p2w), ray.direction)
    cursor = []
    ix = solid.hit(make_ray(point(*o), vector(*d)), **kw)
    while ix is not None and len(cursor) < 8:
        assert ix.primitive is solid
        cursor.append((ix.ray_distance, _xyz(ix.hit_point)))
        ix = solid.next_intersection()
    return walk, cursor


@pytest.fixture(scope="module")
def hitpoints():
    jw, jsolid = _jax_hitpoints()
    tw, tsolid = scenes.hitpoints_world()
    ref, got = [], []
    with env(**REF_ENV):
        for o, d in zip(_O, _D):
            ref.append(_record(jw.hit(JRay(S.Point3D(*o), S.Vector3D(*d))),
                               jw.primitives))
        jwalk = [_walk(jw, jsolid, _O[i], _D[i], JRay, S.Point3D, S.Vector3D)
                 for i in range(0, N_RAYS, 4)]
    for o, d in zip(_O, _D):
        got.append(_record(tw.hit(Ray(T.Point3D(*o), T.Vector3D(*d)),
                                  device="cpu"), tw.primitives))
    twalk = [_walk(tw, tsolid, _O[i], _D[i], Ray, T.Point3D, T.Vector3D,
                   device="cpu") for i in range(0, N_RAYS, 4)]
    return dict(ref=ref, got=got, jwalk=jwalk, twalk=twalk, jw=jw, tw=tw,
                jsolid=jsolid, tsolid=tsolid)


@pytest.mark.parametrize("i", range(N_RAYS))
def test_world_hit_matches_reference(hitpoints, i):
    _same_record(hitpoints["got"][i], hitpoints["ref"][i])


def test_world_hit_fan_hits_and_misses(hitpoints):
    hits = [r is not None for r in hitpoints["ref"]]
    assert 0 < sum(hits) < N_RAYS
    assert any(r["exiting"] for r in hitpoints["ref"] if r is not None)


@pytest.mark.parametrize("k", range(N_RAYS // 4))
def test_hitpoints_walk_matches_reference(hitpoints, k):
    (jwalk, jcur), (twalk, tcur) = hitpoints["jwalk"][k], hitpoints["twalk"][k]
    assert len(twalk) == len(jwalk)
    for got, ref in zip(twalk, jwalk):
        _same_record(got, ref)
    assert len(tcur) == len(jcur)
    for (tt, tp), (jt, jp) in zip(tcur, jcur):
        np.testing.assert_allclose(tt, jt, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)


def test_demo_walk_crosses_the_cut_box():
    """demos/core/ray_intersection_hitpoints.py: the ray at the box's
    corner enters and leaves it."""
    world, _ = scenes.hitpoints_world()
    ray = Ray(T.Point3D(0.45, 0.45, -2), T.Vector3D(0, 0, 1))
    zs = []
    while True:
        ix = world.hit(ray, device="cpu")
        if ix is None:
            break
        zs.append(ix.hit_point.transform(ix.primitive_to_world).z)
        ray = Ray((ix.outside_point if ix.exiting else ix.inside_point)
                  .transform(ix.primitive_to_world), ray.direction)
    np.testing.assert_allclose(zs, [1.5, 2.5], atol=1e-5)


def test_hit_validates_and_needs_a_device():
    world, solid = scenes.hitpoints_world()
    with pytest.raises(ValueError):
        world.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 0)), device="cpu")
    assert world.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1),
                         max_distance=1.0), device="cpu") is None
    with pytest.raises(RuntimeError):
        solid.next_intersection()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            world.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solid.contains(T.Point3D(0, 0, 2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OpticalRay().sample(world, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LoggingRay().trace(world)


# --- (c) contains ---------------------------------------------------------------------

_G = np.asarray([-0.65, -0.45, 0.45, 0.65])
GRID = np.stack(np.meshgrid(_G, _G, 2.0 + _G, indexing="ij"), -1).reshape(-1, 3)


def test_world_contains_matches_reference(hitpoints):
    jw, tw = hitpoints["jw"], hitpoints["tw"]
    with env(**REF_ENV):
        ref = [len(jw.contains(S.Point3D(*p))) for p in GRID]
        ref_prim = [hitpoints["jsolid"].contains(S.Point3D(*p)) for p in GRID]
    got = [len(tw.contains(T.Point3D(*p), device="cpu")) for p in GRID]
    got_prim = [hitpoints["tsolid"].contains(T.Point3D(*p), device="cpu")
                for p in GRID]
    assert got == ref and got_prim == ref_prim
    assert 0 < sum(got) < len(GRID)


def test_rebuild_after_geometry_change():
    w = T.World()
    s = Sphere(0.5, parent=w, transform=T.translate(0, 0, 2),
               material=AbsorbingSurface())
    assert w.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1)),
                 device="cpu") is not None
    s.transform = T.translate(0, 5, 2)  # GEOMETRY signal -> recompile
    assert w.hit(Ray(T.Point3D(0, 0, 0), T.Vector3D(0, 0, 1)),
                 device="cpu") is None
    ix = w.hit(Ray(T.Point3D(0, 5, 0), T.Vector3D(0, 0, 1)), device="cpu")
    assert ix.ray_distance == pytest.approx(1.5, abs=1e-4)
    assert s.contains(T.Point3D(0, 5, 2), device="cpu")
    assert not s.contains(T.Point3D(0, 0, 2), device="cpu")
    box = Box(T.Point3D(-3, -3, -3), T.Point3D(3, 3, 3), parent=w,
              material=AbsorbingSurface())
    assert w.contains(T.Point3D(0, 5, 2), device="cpu") == [s]
    assert w.contains(T.Point3D(0, 0, 2), device="cpu") == [box]
    w.build_accelerator(force=True, device="cpu")
    assert set(w._query_scenes) == {torch.device("cpu")}


# --- (d) a mesh: MeshIntersection ----------------------------------------------------

# rays from outside (one misses) and from inside; points inside and outside
MESH_O = np.asarray([[0.1, 0.2, 0.0], [0.5, -0.4, 0.5], [0.0, 0.05, 3.0],
                     [2.0, 0.0, 3.0]])
MESH_D = np.asarray([[0.0, 0.0, 1.0], [-0.2, 0.15, 1.0], [0.3, 0.1, 1.0],
                     [0.0, 0.0, 1.0]])
MESH_P = np.asarray([[0.0, 0.0, 3.0], [0.0, 0.0, 4.5], [0.3, 0.2, 2.5]])


def _mesh_record(ix, prims):
    rec = _record(ix, prims)
    if rec is not None:
        assert type(ix).__name__ == "MeshIntersection"
        rec.update(triangle=ix.triangle, uvw=np.asarray([ix.u, ix.v, ix.w]))
    return rec


@pytest.fixture(scope="module")
def mesh_queries():
    v, f = scenes.icosphere(3)
    tw, jw = T.World(), S.World()
    tmesh = Mesh(v, f, closed=True, parent=tw, material=AbsorbingSurface(),
                 transform=T.translate(0, 0, 3) * T.rotate(20, 10, 0))
    JMesh(v, f, closed=True, parent=jw, material=JAbsorbing(),
          transform=S.translate(0, 0, 3) * S.rotate(20, 10, 0))
    with env(**REF_ENV):
        ref = [_mesh_record(jw.hit(JRay(S.Point3D(*o), S.Vector3D(*d))),
                            jw.primitives) for o, d in zip(MESH_O, MESH_D)]
        ref_in = [len(jw.contains(S.Point3D(*p))) for p in MESH_P]
    got = [_mesh_record(tw.hit(Ray(T.Point3D(*o), T.Vector3D(*d)), device="cpu"),
                        tw.primitives) for o, d in zip(MESH_O, MESH_D)]
    got_in = [len(tw.contains(T.Point3D(*p), device="cpu")) for p in MESH_P]
    return dict(ref=ref, got=got, ref_in=ref_in, got_in=got_in, mesh=tmesh)


@pytest.mark.parametrize("i", range(len(MESH_O)))
def test_mesh_intersection_matches_reference(mesh_queries, i):
    got, ref = mesh_queries["got"][i], mesh_queries["ref"][i]
    _same_record(got, ref)
    if ref is None:
        return
    if got["triangle"] == ref["triangle"]:
        np.testing.assert_allclose(got["uvw"], ref["uvw"], rtol=1e-6, atol=1e-6)
    else:
        # a ray at an edge or a vertex: tied triangles, one hit point
        np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    assert abs(got["uvw"].sum() - 1.0) < 1e-6


def test_mesh_contains_matches_reference(mesh_queries):
    assert mesh_queries["got_in"] == mesh_queries["ref_in"]
    assert mesh_queries["got_in"] == [1, 0, 1]
    assert [r is not None for r in mesh_queries["got"]] == [True, True, True,
                                                            False]
    assert mesh_queries["mesh"].contains(T.Point3D(0, 0, 3), device="cpu")


# --- (e) trace_rays_logged and LoggingRay ---------------------------------------------

LOG_BINS = 4
LOG_CFG = dict(max_depth=8, extinction_prob=0.0, max_iters=8)
LOG_H = np.r_[-0.008, -0.004, 0.0, 0.004, 0.008, np.linspace(-0.0095, 0.0095, 11)]


def _jax_logging_lens():
    w = S.World()
    JBiConvex(0.02, 0.006, 0.05, 0.05, parent=w,
              material=JDielectric(JConstantSF(1.5), JConstantSF(1.0),
                                   transmission_only=True))
    JBox(S.Point3D(-0.05, -0.05, 0.062), S.Point3D(0.05, 0.05, 0.063),
         parent=w, material=JAbsorbing())
    return w


@pytest.fixture(scope="module")
def logged():
    n = len(LOG_H)
    o = np.c_[LOG_H, np.zeros(n), np.full(n, -0.05)].astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.05, 1.0]], np.float32), (n, 1))
    d[:5] = [0.0, 0.0, 1.0]  # the demo's five rays along the axis
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    key = jax.random.PRNGKey(9)
    js = S.compile_scene(_jax_logging_lens(),
                         S.SpectralConfig(375.0, 740.0, LOG_BINS))
    st = JW.init_rays(jnp.asarray(o), jnp.asarray(d), LOG_BINS)
    with env(**REF_ENV):
        # at LLVM's default level the reference's scan returns a zero normal
        # on some lens hits (ROADMAP.md queue 3)
        jfin, jlog = jax_compiled(
            lambda st, key: JW.trace_rays_logged(js, JW.RayConfig(**LOG_CFG),
                                                 st, key), st, key)(st, key)
    n_u = JW._n_uniforms(js)

    def u_all(i, n_steps, n_lanes):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, i), (n_lanes, n_u))))[None]

    ts = T.compile_scene(scenes.logging_lens_world(),
                         T.SpectralConfig(375.0, 740.0, LOG_BINS), device="cpu")
    tfin, tlog = TW.trace_rays_logged(
        ts, T.RayConfig(**LOG_CFG),
        T.init_rays(torch.from_numpy(o), torch.from_numpy(d), LOG_BINS),
        u_all=u_all)
    return dict(jfin=jfin, jlog={k: np.asarray(v) for k, v in jlog.items()},
                tfin=tfin, tlog=tlog)


@pytest.mark.parametrize("field", ["entity", "material", "exiting", "alive"])
def test_logged_ids_and_flags_match_reference(logged, field):
    got, ref = logged["tlog"][field].numpy(), logged["jlog"][field]
    assert got.shape == ref.shape == (LOG_CFG["max_iters"], len(LOG_H))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("field", ["origin", "hit_point", "normal",
                                   "throughput", "t"])
def test_logged_fields_match_reference(logged, field):
    got, ref = logged["tlog"][field].numpy(), logged["jlog"][field]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=TOL, atol=TOL)


def test_logged_trajectories_match_reference(logged):
    got = TW.reconstruct_trajectories(logged["tlog"])
    ref = JW.reconstruct_trajectories(logged["jlog"])
    assert [len(p) for p in got] == [len(p) for p in ref]
    assert min(len(p) for p in got) >= 3  # lens front, back, screen
    for gp, rp in zip(got, ref):
        for g, r in zip(gp, rp):
            assert g.keys() >= r.keys()
            for k in r:
                np.testing.assert_allclose(g[k], r[k], rtol=TOL, atol=TOL,
                                           err_msg=k)
    np.testing.assert_allclose(logged["tfin"].radiance.numpy(),
                               np.asarray(logged["jfin"].radiance),
                               rtol=TOL, atol=TOL)


def test_logging_ray_mirror_then_emitter():
    """tests/test_core_utils.py::test_logging_ray in the port."""
    w = T.World()
    Sphere(radius=5.0, parent=w, material=UnitySurfaceEmitter())
    Box(lower=T.Point3D(-1, -1, 2), upper=T.Point3D(1, 1, 2.5), parent=w,
        material=PerfectReflectingSurface())
    ray = LoggingRay(origin=(0, 0, 0), direction=(0, 0, 1), bins=4, max_depth=8)
    spectrum = ray.trace(w, device="cpu")
    assert np.allclose(spectrum, 1.0, atol=1e-4)  # mirror then emitter
    assert len(ray.path_vertices) >= 3
    assert abs(ray.path_vertices[1][2] - 2.0) < 1e-3
    assert ray.path_vertices[2][2] < 0
    recs = ray.path_intersections
    assert len(recs) == len(ray.path_vertices) - 1
    assert recs[0]["entity"] == 1 and recs[1]["entity"] == 0
    assert recs[0]["material"] != recs[1]["material"]
    assert not recs[0]["exiting"]
    assert abs(recs[0]["normal"][2] + 1.0) < 1e-4
    assert np.allclose(recs[1]["throughput"], 1.0, atol=1e-5)
    assert ray.log["alive"].shape == (8,)


def test_logging_ray_focuses_through_the_lens():
    """demos/optics/logging_trajectories.py: off-axis rays cross the axis
    behind the lens and stop on the screen."""
    world = scenes.logging_lens_world()
    for h in (-0.008, 0.004):
        ray = LoggingRay(origin=(h, 0.0, -0.05), direction=(0, 0, 1), bins=4,
                         max_depth=8)
        ray.trace(world, device="cpu")
        v = np.asarray(ray.path_vertices)
        assert len(v) == 4  # launch, front, back, screen
        assert abs(v[-1, 2] - 0.062) < 1e-4 and np.sign(v[-1, 0]) == -np.sign(h)
        assert [r["exiting"] for r in ray.path_intersections] == [False, True,
                                                                  False]


# --- (f) optical.Ray ----------------------------------------------------------------


def test_optical_ray_sample_furnace():
    """tests/test_query_api.py::test_optical_ray_sample_furnace in the
    port: exactly 1.0 in every bin."""
    w = T.World()
    Sphere(radius=5.0, parent=w, material=UnitySurfaceEmitter())
    ray = OpticalRay(origin=(0, 0, 0), direction=(0, 0, 1), bins=6,
                     extinction_prob=0.0, max_depth=4)
    spec = ray.sample(w, 64, seed=3, device="cpu")
    assert spec.bins == 6
    assert (spec.samples == 1.0).all()
    assert ray.ray_count == 64
    one = ray.trace(w, seed=4, device="cpu")
    assert (one.samples == 1.0).all()
    r2 = ray.copy(origin=(1, 0, 0))
    assert r2.bins == ray.bins and r2.max_depth == ray.max_depth
    assert r2.origin.tolist() == [1, 0, 0]
    assert ray.new_spectrum().samples.shape == (6,)
    with pytest.raises(ValueError):
        ray.sample(w, 0, device="cpu")
    with pytest.raises(ValueError):
        OpticalRay(bins=0)


SAMPLE_N = 4096
SAMPLE_KW = dict(origin=(0.0, 0.0, -3.3), direction=(0.0, 0.0, 1.0), bins=5,
                 max_depth=6)


def test_optical_ray_sample_cornell_mean_matches_reference():
    """One batch of identical rays into the Cornell box (no glass): the
    port's mean within 4 standard errors of the reference's, per bin."""
    with env(**REF_ENV):
        ref = JOpticalRay(**SAMPLE_KW).sample(jax_cornell_world(glass=False),
                                              SAMPLE_N, seed=5).samples
    world = scenes.cornell_box(glass=False)
    ray = OpticalRay(**SAMPLE_KW)
    got = ray.sample(world, SAMPLE_N, seed=5, device="cpu").samples
    assert ray.ray_count >= SAMPLE_N
    # the spread of one lane's radiance, from a second batch of the port
    scene = T.compile_scene(world, T.SpectralConfig(375.0, 740.0, 5),
                            device="cpu")
    o = np.tile(np.float32(SAMPLE_KW["origin"]), (SAMPLE_N, 1))
    d = np.tile(np.float32(SAMPLE_KW["direction"]), (SAMPLE_N, 1))
    rad = T.render_batch(scene, ray._config(), o, d,
                         torch.Generator().manual_seed(6),
                         device="cpu").radiance.numpy()
    se = math.sqrt(2.0) * rad.std(axis=0) / math.sqrt(SAMPLE_N)
    assert (got > 0).all() and (ref > 0).all()
    assert (np.abs(got - ref) <= 4.0 * se).all(), (got, ref, se)
