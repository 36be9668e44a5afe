"""The wavefront route of source_tpu_torch against source_tpu, on the CPU.

The port runs the plain PyTorch versions of its kernels (``device="cpu"``);
inputs are made with numpy from fixed seeds and handed to both packages.
Every JAX reference is built once per module.

  (a) BVH build and ``pack_leaf_bvh_host``: node and item order equal, tables
      bit for bit, on the CSG demo (each package compiling its own
      scenegraph) and on the lens world of tests/test_csg_bvh.py (the JAX
      compile's inputs handed to the port's packer).
  (b) the batched ``candidates_*``/``normal_*``/``contains_*`` per type:
      rtol 1e-5 (atol 1e-6); the torus candidates atol 5e-3, the f32
      quartic's conditioning (ROADMAP queue 3).
  (c) ``analytic_bvh_winner_plain`` against the JAX ``analytic_bvh_winner``
      in interpret mode on the CSG demo, record for record at the
      tolerances of tests/test_csg_bvh.py (t rtol/atol 1e-3, normal atol
      3e-3, the rest equal).
  (d) the port's ``intersect_scene`` on the BVH fast path, the recompute
      path and the streaming route against the JAX streaming route: the
      same tolerances; at most 0.5 % of lanes may decide otherwise (XLA
      contracts multiply-adds into FMAs, PyTorch does not).
  (e) ``trace_step`` bounce by bounce from the same state and uniforms:
      continuous state within rtol 1e-5 / atol 1e-6 on the lanes whose
      choices agree, at most 0.5 % of lanes otherwise.
  (f) ``render_batch`` with compaction against the JAX ``trace_rays`` on
      the reference's uniforms and rotations: as tests/test_torch_trace.py,
      radiance within rtol 1e-3 / atol 1e-4 on all but 0.5 % of lanes.
      The JAX references of (e) and (f) are compiled with LLVM's
      optimisation off (``xla_backend_optimization_level=0``): at the
      default level the CPU build of the reference's ``trace_step`` returns
      a zero normal on 10 of 512 first-bounce lanes of the CSG demo, where
      its eager evaluation and the port agree (ROADMAP.md, queue 3).
  (g) the route argument: the Cornell box on the wavefront route against
      the fused route on the same uniforms, f32 spectral state, the fused
      route's tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.csg import build_world as jax_csg_world
import source_tpu as S
from source_tpu.optical.material.lambert import Lambert as JaxLambert
from source_tpu.primitive import analytic as JA
from source_tpu.tracer import pallas_analytic as JPA
from source_tpu.tracer.intersect import intersect_scene as jax_intersect
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig,
    init_rays as jax_init_rays, trace_rays as jax_trace_rays,
)

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.primitive import analytic as TA
from source_tpu_torch.tracer import analytic_bvh as TAB
from source_tpu_torch.tracer.intersect import intersect_scene

from test_torch_common import B, carry_scene, trace_step_parity
from test_torch_common import env as _env, jax_compiled as _jax_compiled, to_jax

SPECTRAL = (375.0, 740.0, B)
MAX_FLIP = 0.005


@pytest.fixture(scope="module")
def csg_pair():
    """The CSG demo: the JAX package's compile of its geometry (materials
    swapped for Lambert, which the BVH does not read) beside the port's
    compile of its own scenegraph, and the port's scene as a JAX scene."""
    world = jax_csg_world()
    for prim in world.primitives:
        prim.material = JaxLambert()
    js = S.compile_scene(world, S.SpectralConfig(*SPECTRAL))
    ts = T.compile_scene(scenes.csg_world(), T.SpectralConfig(*SPECTRAL),
                         device="cpu")
    return js, ts, to_jax(ts)


def _lens_world():
    """The lens world of tests/test_csg_bvh.py (JAX classes: the port has no
    lens primitives yet)."""
    from source_tpu.core.math.transform import rotate_x, translate
    from source_tpu.core.math.vector import Point3D
    from source_tpu.optical.material.lambert import Lambert
    from source_tpu.primitive import Box, Cylinder, Sphere
    from source_tpu.primitive.csg import Intersect, Subtract, Union
    from source_tpu.primitive.lens.spherical import (
        BiConcave, BiConvex, Meniscus, PlanoConvex,
    )
    w = S.World()
    rng = np.random.RandomState(0)
    lenses = [BiConvex, BiConcave, PlanoConvex, Meniscus]
    for i in range(8):
        x, y = (i % 3 - 1) * 0.3, (i // 3 - 1) * 0.3
        L = lenses[i % 4]
        if L is PlanoConvex:
            p = L(0.1, 0.02, 0.3)
        elif L is Meniscus:
            p = L(0.1, 0.02, 0.25, 0.3)
        else:
            p = L(0.1, 0.02, 0.3, 0.3)
        p.parent = w
        p.transform = translate(x, y, 0.4 * i) * rotate_x(float(rng.uniform(0, 20)))
        p.material = Lambert()
    Subtract(Sphere(0.5), Box(Point3D(0, -1, -1), Point3D(1, 1, 1)), parent=w,
             transform=translate(0.0, 1.2, 1.0), material=Lambert())
    Union(Sphere(0.3), Cylinder(0.2, 0.6), parent=w,
          transform=translate(-1.2, 0.0, 1.5), material=Lambert())
    Intersect(Sphere(0.4), Sphere(0.4, transform=translate(0.3, 0, 0)),
              parent=w, transform=translate(1.2, 0.0, 2.0), material=Lambert())
    Sphere(0.25, parent=w, transform=translate(0.0, -1.2, 2.5),
           material=Lambert())
    Box(Point3D(-0.2, -0.2, -0.2), Point3D(0.2, 0.2, 0.2), parent=w,
        transform=translate(1.0, 1.0, 3.0), material=Lambert())
    return w


# --- (a) the BVH tables ------------------------------------------------------------


def _same_tables(jt, tt, jmeta, tmeta):
    assert tmeta == jmeta
    for k in ("nodes", "leaves", "csg"):
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]),
                                      err_msg=k)


def test_bvh_tables_csg_demo(csg_pair):
    js, ts, _ = csg_pair
    _same_tables(js.leaf_bvh, {k: v.numpy() for k, v in ts.leaf_bvh.items()},
                 js.leaf_bvh_meta, ts.leaf_bvh_meta)
    for f in ("bvh_leaf_ids", "kernel_csg_entities", "csg_entities",
              "simple_leaf_of_entity"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.kernel_csg_entities == (0, 1, 2, 3, 4)
    assert ts.leaf_bvh_meta[:3] == (5, 4, (TAB.KT_BOX_W, TAB.KT_CSG))


def test_pack_leaf_bvh_host_lens_world(monkeypatch):
    """The JAX compile's own packer inputs, packed by both packages."""
    calls = []
    real = JPA.pack_leaf_bvh_host

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(JPA, "pack_leaf_bvh_host", spy)
    js = S.compile_scene(_lens_world(), S.SpectralConfig(*SPECTRAL))
    (args, kw, (jt, jmeta)), = calls
    assert len(js.kernel_csg_entities) == 11 and jmeta[0] > 3
    tt, tmeta = TAB.pack_leaf_bvh_host(*args, **kw)
    _same_tables(jt, tt, jmeta, tmeta)
    # the carried scene holds the same tables as the JAX one
    carried = carry_scene(js)
    _same_tables(js.leaf_bvh, {k: v.numpy() for k, v in carried.leaf_bvh.items()},
                 js.leaf_bvh_meta, carried.leaf_bvh_meta)


# --- (b) the batched closed forms --------------------------------------------------

_PARAMS = {
    TA.TYPE_SPHERE: lambda r: [r.uniform(0.3, 1.0)],
    TA.TYPE_BOX: lambda r: list(-r.uniform(0.2, 0.8, 3)) + list(r.uniform(0.2, 0.8, 3)),
    TA.TYPE_CYLINDER: lambda r: [r.uniform(0.3, 0.8), r.uniform(0.5, 1.5)],
    TA.TYPE_CONE: lambda r: [r.uniform(0.3, 0.8), r.uniform(0.5, 1.5)],
    TA.TYPE_PARABOLA: lambda r: [r.uniform(0.3, 0.8), r.uniform(0.5, 1.5)],
    TA.TYPE_TORUS: lambda r: [r.uniform(0.6, 0.9), r.uniform(0.1, 0.3)],
}


@pytest.mark.parametrize("tid", sorted(_PARAMS))
def test_closed_forms_match_jax(tid):
    rng = np.random.RandomState(40 + tid)
    n, l = 256, 4
    params = np.zeros((l, 8), np.float32)
    for j in range(l):
        p = _PARAMS[tid](rng)
        params[j, :len(p)] = p
    # origins around the solid, aimed at points inside its bounds, plus a
    # quarter axial rays (the degenerate branches)
    o = rng.uniform(-2.0, 2.0, (n, l, 3)).astype(np.float32)
    tgt = rng.uniform(-0.4, 0.4, (n, l, 3)) + np.array([0, 0, 0.3])
    d = tgt - o
    d[: n // 4, :, :2] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    pt = torch.from_numpy(params)[None]
    cand_t = TA.CANDIDATE_FNS[tid](torch.from_numpy(o), torch.from_numpy(d),
                                   pt).numpy()
    # normals at points on and near the surface (one param row per point),
    # containment off it (on it, the test is a coin toss of ulps)
    t0 = np.where(np.isfinite(cand_t[..., 0]), cand_t[..., 0], 0.5)
    p = (o + t0[..., None] * d).astype(np.float32)
    p[::3] += rng.normal(scale=0.05, size=p[::3].shape).astype(np.float32)
    q = (p + rng.normal(scale=0.05, size=p.shape)).astype(np.float32)
    pp = np.ascontiguousarray(np.broadcast_to(params, (n, l, 8)))
    nt = TA.NORMAL_FNS[tid](torch.from_numpy(p), torch.from_numpy(pp)).numpy()
    ct = TA.CONTAINS_FNS[tid](torch.from_numpy(q), pt).numpy()
    args = [jnp.asarray(x) for x in (o, d, params[None], p, pp, q)]
    cand_j, nj, cj = (np.asarray(x) for x in _jax_compiled(
        lambda o, d, pr, p, pp, q: (JA.CANDIDATE_FNS[tid](o, d, pr),
                                    JA.NORMAL_FNS[tid](p, pp),
                                    JA.CONTAINS_FNS[tid](q, pr)), *args)(*args))
    fin = np.isfinite(cand_j)
    if tid == TA.TYPE_TORUS:
        # the quartic's plug-back filter sits within rounding of its
        # threshold on a few grazing lanes
        same = (np.isfinite(cand_t) == fin).all(-1)
        print(f"torus: {int((~same).sum())} of {same.size} rays keep "
              "another set of roots")
        assert (~same).mean() <= MAX_FLIP
        fin &= same[..., None]
    else:
        np.testing.assert_array_equal(np.isfinite(cand_t), fin)
    atol = 5e-3 if tid == TA.TYPE_TORUS else 1e-6
    np.testing.assert_allclose(cand_t[fin], cand_j[fin], rtol=1e-5, atol=atol)
    assert fin.any()
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ct, cj)
    assert cj.any() and not cj.all()


# --- (c) the BVH kernel's plain version against interpret-mode Pallas -------------


def _csg_rays(n_side=32):
    """The CSG demo's camera at n_side x n_side pixel centres."""
    return scenes.camera_rays(n_side, n_side, 75.0, (0.0, 0.0, -4.0))


def _eps(o):
    return (1e-4 * np.maximum(1.0, np.abs(o).max(axis=-1))).astype(np.float32)


def test_bvh_winner_plain_matches_interpret_kernel(csg_pair):
    js, ts, _ = csg_pair
    o, d = _csg_rays()
    # half the rays start inside the solids, aimed along +z
    o[1::2] = (np.asarray(ts.leaf_l2w[:, :3, 3])[np.arange(512) % ts.n_leaves]
               + np.array([1.7e-3, 1.3e-3, 2.9e-3], np.float32))
    eps = _eps(o)
    ref = JPA.analytic_bvh_winner(js.leaf_bvh, js.leaf_bvh_meta,
                                  jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(eps), sort_rays=False)
    got = TAB.analytic_bvh_winner(ts.leaf_bvh, ts.leaf_bvh_meta,
                                  torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(eps))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    hit = ref["leaf"] >= 0
    assert hit.sum() > 700 and (~hit).sum() == 0 or hit.sum() > 700
    for k in ("leaf", "entity", "inside", "crossing_hi"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["t"][hit], ref["t"][hit], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["normal"][hit], ref["normal"][hit],
                               atol=3e-3)
    assert np.isinf(got["t"][~hit]).all()
    assert ref["crossing_hi"].any()


# --- (d) intersect_scene against the JAX streaming route ---------------------------


def _aimed_rays(l2w, n, seed):
    """Rays aimed at the leaf centres (tests/test_csg_bvh.py)."""
    centres = l2w[:, :3, 3]
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, len(centres), n)
    o = rng.uniform(-2, 2, (n, 3)) * np.array([1, 1, 0.0]) + np.array(
        [0, 0, -1.5])
    tgt = centres[pick] + rng.normal(scale=0.08, size=(n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # a quarter start inside the leaves, displaced off their frames' planes
    k = n // 4
    o[:k] = centres[pick[:k]] + np.array([1.7e-3, 1.3e-3, 2.9e-3])
    return o.astype(np.float32), d.astype(np.float32)


def _mixed_world():
    """BVH items beside CSG entities the kernel cannot take: a 7-child CSG
    and one with a torus child stream beside the tree."""
    from source_tpu.core.math.transform import rotate_x, translate
    from source_tpu.core.math.vector import Point3D
    from source_tpu.optical.material.lambert import Lambert
    from source_tpu.primitive import Box, Cylinder, Sphere, Torus
    from source_tpu.primitive.csg import Intersect, Subtract, Union
    w = S.World()
    big = Sphere(0.45)
    for k in range(6):
        big = Subtract(big, Sphere(0.12, transform=translate(
            0.4 * np.cos(k), 0.4 * np.sin(k), 0.1 * k - 0.25)))
    big.parent = w
    big.transform = translate(-0.8, 0.0, 1.5)
    big.material = Lambert()
    Union(Torus(0.4, 0.1), Box(Point3D(-0.1, -0.1, -0.3), Point3D(0.1, 0.1, 0.3)),
          parent=w, transform=translate(0.8, 0.0, 1.5) * rotate_x(30.0),
          material=Lambert())
    Intersect(Sphere(0.4), Cylinder(0.3, 0.8, transform=translate(0, 0, -0.4)),
              parent=w, transform=translate(0.0, 0.9, 2.0), material=Lambert())
    Sphere(0.3, parent=w, transform=translate(0.0, -0.9, 2.0), material=Lambert())
    Box(Point3D(-0.3, -0.3, -0.3), Point3D(0.3, 0.3, 0.3), parent=w,
        transform=translate(0.0, 0.0, 3.0) * rotate_x(20.0), material=Lambert())
    return w


@pytest.fixture(scope="module")
def intersect_cases(csg_pair):
    """(JAX scene, port scene, rays) per case; the port's scenes are the JAX
    ones carried across, so both intersect the same tables."""
    js = csg_pair[0]
    jm = S.compile_scene(_mixed_world(), S.SpectralConfig(*SPECTRAL))
    cases = {}
    for name, scene in (("csg", js), ("mixed", jm)):
        o, d = _aimed_rays(np.asarray(scene.leaf_l2w), 1024, seed=7)
        o_j, d_j = jnp.asarray(o), jnp.asarray(d)
        with _env(SOURCE_TPU_LEAF_BVH="0"):
            ref = _jax_compiled(lambda o, d, s=scene: jax_intersect(s, o, d),
                                o_j, d_j)(o_j, d_j)
        cases[name] = (scene, carry_scene(scene), o, d,
                       jax.tree_util.tree_map(np.asarray, ref))
    return cases


def _compare_records(got, ref, name):
    h_r, h_g = ref.hit, got.hit.numpy()
    same = ((h_r == h_g) & (ref.entity == got.entity.numpy())
            & (ref.exiting == got.exiting.numpy()))
    m = h_r & same
    same[m] &= ref.leaf[m] == got.leaf.numpy()[m]
    same[m] &= np.isclose(got.t.numpy()[m], ref.t[m], rtol=1e-3, atol=1e-3)
    same[m] &= (np.abs(got.normal.numpy()[m] - ref.normal[m]) <= 3e-3).all(-1)
    flip = 1.0 - same.mean()
    print(f"{name}: {int((~same).sum())} of {len(same)} lanes decide otherwise")
    assert flip <= MAX_FLIP, name
    assert h_r.sum() > len(h_r) // 2
    assert np.isfinite(got.point.numpy()).all()


@pytest.mark.parametrize("path", ["fast", "recompute", "streaming"])
def test_intersect_matches_jax_streaming(intersect_cases, path):
    js, ts, o, d, ref = intersect_cases["csg"]
    kw = {"fast": dict(need_grad=False), "recompute": dict(need_grad=True),
          "streaming": dict(leaf_bvh=False)}[path]
    got = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d), **kw)
    _compare_records(got, ref, f"csg/{path}")


def test_intersect_mixed_branches(intersect_cases):
    """Kernel-resolved CSG and simple items from the BVH, with CSG entities
    the kernel cannot take streamed beside it (branch b)."""
    js, ts, o, d, ref = intersect_cases["mixed"]
    assert ts.leaf_bvh is not None and 0 < len(ts.bvh_leaf_ids) < ts.n_leaves
    assert len(ts.kernel_csg_entities) == 1 and len(ts.csg_entities) == 3
    for need_grad in (False, True):
        got = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d),
                              need_grad=need_grad)
        _compare_records(got, ref, f"mixed/need_grad={need_grad}")


# --- (e) trace_step, (f) render_batch ----------------------------------------------

# the suite's CSG settings (benchmarks/suite.py::bench_csg, camera defaults)
CSG_CFG = dict(max_depth=24, extinction_prob=0.01, extinction_min_depth=3,
               importance_sampling=True, important_path_weight=0.25,
               max_iters=32)


def _jax_state(o, d):
    return jax_init_rays(jnp.asarray(o), jnp.asarray(d), B)


def test_trace_step_matches_jax(csg_pair):
    """Four bounces, each from the JAX state, with the same uniforms."""
    _, ts, js = csg_pair
    o, d = _csg_rays(32)
    o, d = o[::2], d[::2]
    u_all = np.random.RandomState(3).random_sample((4, len(o), 10)).astype(
        np.float32)
    differ, st = trace_step_parity(js, ts, CSG_CFG, o, d, u_all)
    print(f"trace_step: {int(differ.sum())} of {len(o)} lanes decide otherwise "
          "in some bounce")
    assert float(np.asarray(st.radiance).sum()) > 0.0


def test_render_batch_matches_jax_trace_rays(csg_pair):
    """The wavefront route with compaction on the reference's uniforms and
    compaction rotations, against the JAX ``trace_rays``."""
    _, ts, js = csg_pair
    o, d = _csg_rays(32)
    o, d = o[1::2], d[1::2]
    cfg = dict(CSG_CFG, max_iters=10, compact_schedule=((4, 4),))
    key = jax.random.PRNGKey(5)
    with _env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        st = _jax_state(o, d)
        ref = _jax_compiled(
            lambda st: jax_trace_rays(js, JaxRayConfig(**cfg), st, key), st)(st)

    def u_all(start, n_steps, n_lanes):
        u = jax.random.uniform(jax.random.fold_in(key, 0x7A000 + start),
                               (n_steps, n_lanes, 10), jnp.float32)
        return torch.from_numpy(np.array(u))

    def shifts(done, alive_count):
        return int(jax.random.randint(jax.random.fold_in(key, 1_000_000 + done),
                                      (), 0, max(alive_count, 1)))

    got = T.render_batch(ts, T.RayConfig(**cfg), o, d, u_all=u_all,
                         shifts=shifts, device="cpu")
    a = np.asarray(ref.radiance)
    b = got.radiance.numpy()
    assert np.isfinite(b).all() and b.shape == a.shape
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(axis=1)
    print(f"render_batch: {int(bad.sum())} of {len(bad)} lanes beyond "
          f"tolerance; segments {int(got.segments)} / {int(ref.segments)}, "
          f"overflow {int(got.overflow)} / {int(ref.overflow)}")
    assert bad.mean() <= MAX_FLIP
    assert abs(int(got.segments) - int(ref.segments)) <= MAX_FLIP * int(ref.segments)
    assert int(got.overflow) == int(ref.overflow)
    assert float(b.sum()) > 0.0


# --- (g) the route argument --------------------------------------------------------


def test_wavefront_route_equals_fused_route():
    """A scene the fused route takes, traced by both routes on the same
    uniforms (f32 spectral state: the wavefront route rounds the state every
    bounce, the fused span does not)."""
    scene = T.compile_scene(scenes.cornell_box(glass=True),
                            T.SpectralConfig(*SPECTRAL), device="cpu")
    o, d = scenes.scatter_rays(512, seed=4)
    cfg = T.RayConfig(max_depth=8, max_iters=10)
    u = torch.from_numpy(np.random.RandomState(8).random_sample(
        (cfg.max_iters, len(o), 10)).astype(np.float32))

    def same_u(start, n_steps, n_lanes):
        return u[start:start + n_steps, :n_lanes]

    fused_st = T.render_batch(scene, cfg, o, d, u_all=same_u, device="cpu")
    wave = T.render_batch(scene, cfg, o, d, u_all=same_u, route="wavefront",
                          device="cpu")
    a, b = fused_st.radiance.numpy(), wave.radiance.numpy()
    bad = (np.abs(a - b) > 1e-4 + 1e-3 * np.abs(a)).any(axis=1)
    print(f"routes: {int(bad.sum())} of {len(bad)} lanes beyond tolerance")
    assert bad.mean() <= MAX_FLIP
    assert abs(int(wave.segments) - int(fused_st.segments)) <= MAX_FLIP * 512 * 10
    assert float(a.sum()) > 0.0
    with pytest.raises(ValueError, match="route"):
        T.render_batch(scene, cfg, o, d, route="fused", device="cpu")


def test_all_leaf_helpers_agree_with_single_leaf_ones(intersect_cases):
    """``leaf_candidates``/``entity_contains`` (every leaf, every entity at
    once) against the per-leaf and per-entity forms the route takes."""
    from source_tpu_torch.tracer.intersect import (
        _single_leaf_candidates, entity_contains, leaf_candidates,
    )
    from source_tpu_torch.tracer.wavefront import _entity_inside
    _, ts, o, d, _ = intersect_cases["mixed"]
    o, d = torch.from_numpy(o[:256]), torch.from_numpy(d[:256])
    allc = leaf_candidates(ts, o, d)
    for g in range(ts.n_leaves):
        one = _single_leaf_candidates(ts, torch.full((256,), g), o, d)
        assert torch.equal(allc[:, g], one), g
    pts = o + 2.0 * d
    inside = entity_contains(ts, pts)
    for e in range(ts.n_entities):
        assert torch.equal(inside[:, e], _entity_inside(ts, e, pts)), e
    assert inside.any() and not inside.all()
