"""The port's host math against source_tpu's, on the CPU.

  (a) containers: one sequence of LinkedList/Stack/Queue operations gives
      the same values and errors in both packages (Stack pushes at the head);
  (b) bounding boxes and spheres: the same operations, the same values;
  (c) Quaternion: algebra, matrices and axis-angle equal to 1e-12;
  (d) ``triangulate2d`` on seeded star polygons: equal triangles;
  (e) ``KDTree2D``/``KDTree3D.items_containing`` on seeded boxes: equal ids;
  (f) the triangle, tetrahedron and polygon helpers at seeded points;
  (g) ``batch.length``/``orthogonal``/``safe_div``/``safe_pow`` and
      ``polyroots.solve_cubic``;
  (h) the samplers on the JAX draws' uniforms: samples and pdfs;
  (i) where ``core.math.random`` draws: on the card unless told otherwise.

Float32 comparisons allow a few ulp (rtol 1e-5 / atol 1e-6): XLA may
contract products into FMAs where torch rounds each.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import source_tpu.core.boundingbox as JB
import source_tpu.core.containers as JC
import source_tpu.core.math.sampler as JS
from source_tpu.core.math import batch as jbatch
from source_tpu.core.math import polyroots as jroots
from source_tpu.core.math import triangle as jtri
from source_tpu.core.math.polygon import triangulate2d as jtriangulate
from source_tpu.core.math.quaternion import Quaternion as JQ
from source_tpu.core.math.spatial import (
    Item2D as JItem2D, Item3D as JItem3D, KDTree2D as JKD2, KDTree3D as JKD3,
)
from source_tpu.core.math.vector import Vector3D as JV

import source_tpu_torch.core.boundingbox as TB
import source_tpu_torch.core.containers as TC
import source_tpu_torch.core.math.sampler as TS
from source_tpu_torch.core.math import AffineMatrix3D, rotate
from source_tpu_torch.core.math import batch as tbatch
from source_tpu_torch.core.math import polyroots as troots
from source_tpu_torch.core.math import random as trandom
from source_tpu_torch.core.math import triangle as ttri
from source_tpu_torch.core.math.polygon import triangulate2d as ttriangulate
from source_tpu_torch.core.math.quaternion import Quaternion as TQ
from source_tpu_torch.core.math.spatial import (
    Item2D as TItem2D, Item3D as TItem3D, KDTree2D as TKD2, KDTree3D as TKD3,
)
from source_tpu_torch.core.math.vector import Point3D, Vector3D

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- (a) containers ------------------------------------------------------------


def _container_script(C):
    out = []
    ll = C.LinkedList([1, 2, 3])
    ll.add(4)
    ll.insert(0, 0)
    ll.insert(9, 2)
    ll.insert(7, 99)
    out += [list(ll), len(ll), ll.get_index(3), ll.remove(2), ll.remove(0),
            list(ll), ll.is_empty()]
    st = C.Stack()
    for v in "abc":
        st.push(v)
    out += [list(st), st.pop(), st.pop(), len(st), st.pop(), st.is_empty()]
    q = C.Queue(range(3))
    q.add(7)
    out += [q.next_in_queue(), q.next_in_queue(), list(q)]
    for fn in (st.pop, C.Queue().next_in_queue, lambda: ll.get_index(10),
               lambda: ll.remove(-1)):
        try:
            fn()
            out.append("no error")
        except IndexError as e:
            out.append(str(e))
    return out


def test_containers_match_jax():
    assert _container_script(TC) == _container_script(JC)


# --- (b) bounding volumes -------------------------------------------------------


def _box_script(B, P, V):
    box = B.BoundingBox3D(P(-1, -2, -3), P(1, 2, 3))
    box.extend(P(4, 0, 0), padding=0.5)
    box.union(B.BoundingBox3D(P(-5, 0, 0), P(0, 6, 1)))
    box.pad_axis(2, 0.25)
    empty = B.BoundingBox3D()
    out = [box.lower.tolist(), box.upper.tolist(), box.surface_area(),
           box.volume(), box.extent(1), box.largest_axis(), box.largest_extent(),
           box.contains(P(4.4, 0, 0)), box.contains(P(4.6, 0, 0)),
           box.contains(P(4.6, 0, 0), tolerance=0.2), empty.is_empty,
           [tuple(map(float, (v.x, v.y, v.z))) for v in box.vertices()],
           tuple(map(float, (box.centre.x, box.centre.y, box.centre.z))),
           box.hit(P(-10, 0.5, 0.5), V(1, 0, 0)),
           box.hit((-10, 50, 0.5), (1, 0, 0)), box.hit((0, 0, 0), (0, 0, 1))]
    s = box.enclosing_sphere()
    s.union(B.BoundingSphere3D(P(20, 0, 0), 1.0))
    s.extend(P(-30, 0, 0), padding=0.5)
    s.pad(0.1)
    out += [s.radius, float(s.centre.x), s.contains(P(0, 0, 0)),
            s.contains((100, 0, 0))]
    b2 = B.BoundingBox2D((0, 0), (1, 2))
    b2.extend((3, -1), padding=0.1)
    b2.union(B.BoundingBox2D((-1, -1), (0, 0)))
    out += [b2.lower.tolist(), b2.upper.tolist(), b2.surface_area(),
            b2.contains((2, 1)), b2.contains((4, 1))]
    with pytest.raises(ValueError):
        B.BoundingBox3D(P(1, 0, 0), P(0, 0, 0))
    with pytest.raises(ValueError):
        B.BoundingSphere3D(P(0, 0, 0), 0.0)
    return out


def test_bounding_volumes_match_jax():
    from source_tpu.core.math.vector import Point3D as JP
    assert _box_script(TB, Point3D, Vector3D) == _box_script(JB, JP, JV)


# --- (c) quaternion ---------------------------------------------------------------


def _quat_values(q):
    if isinstance(q, (TQ, JQ)):
        return [q.x, q.y, q.z, q.s]
    if hasattr(q, "x"):
        return [q.x, q.y, q.z]
    if hasattr(q, "to_array"):
        return np.asarray(q.to_array(np.float64)).ravel().tolist()
    return q


def _quat_script(Q, V, rot):
    a, b = Q(0.1, -0.4, 0.3, 0.8), Q(-0.5, 0.2, 0.7, -0.1)
    m = rot(30, 45, -60)
    out = [a + b, a - b, a * b, 2.5 * a, a * 0.5, a / b, a / 4.0, -a,
           a.conjugate(), a.inverse(), a.normalise(), a.length, a.axis, a.angle,
           a.is_unit(), a.normalise().is_unit(), a == a.copy(), a == b,
           a.quaternion_to(b), a.as_matrix(), Q.from_matrix(m),
           a.transform(m), Q.from_axis_angle(V(1, 2, 3), 75.0)]
    for diag in ((-1, -1, 1), (-1, 1, -1), (1, -1, -1)):
        from_diag = m.__class__(np.diag(list(diag) + [1]).tolist())
        out.append(Q.from_matrix(from_diag))
    with pytest.raises(ZeroDivisionError):
        Q(0, 0, 0, 0).inverse()
    with pytest.raises(ZeroDivisionError):
        a / 0.0
    return [_quat_values(x) for x in out]


def test_quaternion_matches_jax():
    from source_tpu.core.math import rotate as jrotate
    got = _quat_script(TQ, Vector3D, rotate)
    ref = _quat_script(JQ, JV, jrotate)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(r, np.float64), rtol=1e-12,
                                   atol=1e-12)
    assert isinstance(TQ(1, 0, 0, 0).as_matrix(), AffineMatrix3D)


# --- (d) polygon triangulation, (e) kd-trees --------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate2d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 7 + 3 * seed
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.3, 1.0, n)
    poly = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    if seed == 1:
        poly = poly[::-1]  # clockwise
    got = ttriangulate(poly)
    np.testing.assert_array_equal(got, jtriangulate(poly))
    assert got.shape == (n - 2, 3)
    with pytest.raises(ValueError):
        ttriangulate(poly[:2])


def _boxes(rng, n, dim):
    lo = rng.uniform(-1, 1, (n, dim))
    return lo, lo + rng.uniform(0.01, 0.5, (n, dim))


@pytest.mark.parametrize("dim", [2, 3])
def test_kdtree_items_containing_matches_jax(dim, tmp_path):
    rng = np.random.RandomState(dim)
    lo, hi = _boxes(rng, 300, dim)
    if dim == 3:
        tb = [TItem3D(i * 2, TB.BoundingBox3D(Point3D(*a), Point3D(*b)))
              for i, (a, b) in enumerate(zip(lo, hi))]
        jb = [JItem3D(i * 2, JB.BoundingBox3D(a, b))
              for i, (a, b) in enumerate(zip(lo, hi))]
        tree, ref = TKD3(tb), JKD3(jb)
    else:
        tb = [TItem2D(i * 2, TB.BoundingBox2D(a, b))
              for i, (a, b) in enumerate(zip(lo, hi))]
        jb = [JItem2D(i * 2, JB.BoundingBox2D(a, b))
              for i, (a, b) in enumerate(zip(lo, hi))]
        tree, ref = TKD2(tb), JKD2(jb)
    assert tree.n_nodes == ref.n_nodes > 1
    tree.save(tmp_path / "tree.npz")
    loaded = type(tree).load(tmp_path / "tree.npz")
    pts = rng.uniform(-1.2, 1.4, (200, dim))
    found = 0
    for p in pts:
        ids = tree.items_containing(p)
        assert ids == ref.items_containing(p) == loaded.items_containing(p)
        want = sorted(2 * i for i in np.nonzero(
            ((lo <= p) & (p <= hi)).all(1))[0])
        assert sorted(ids) == want
        found += len(ids)
    assert found > 50


# --- (f) triangle helpers -----------------------------------------------------------


def _tri_inputs(rng, n, dim):
    return [rng.uniform(-1, 1, (n, dim)).astype(np.float32) for _ in range(4)]


def test_triangle_helpers_match_jax():
    rng = np.random.RandomState(3)
    v1, v2, v3, p = _tri_inputs(rng, 512, 2)
    v3[:4] = v1[:4]  # degenerate triangles
    for name in ("barycentric_coords", "inside_triangle"):
        got = getattr(ttri, name)(*(torch.from_numpy(x) for x in (v1, v2, v3, p)))
        ref = getattr(jtri, name)(*(jnp.asarray(x) for x in (v1, v2, v3, p)))
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_allclose(_np(g), np.asarray(r), **TOL, err_msg=name)
    a, b, c = ttri.barycentric_coords(*(torch.from_numpy(x) for x in (v1, v2, v3, p)))
    vals = [torch.from_numpy(rng.uniform(size=512).astype(np.float32))
            for _ in range(3)]
    np.testing.assert_allclose(
        ttri.barycentric_interpolation(a, b, c, *vals).numpy(),
        np.asarray(jtri.barycentric_interpolation(
            *(jnp.asarray(_np(x)) for x in (a, b, c, *vals)))), **TOL)

    q = _tri_inputs(rng, 512, 3) + [rng.uniform(-1, 1, (512, 3)).astype(np.float32)]
    got = ttri.barycentric_coords_tetra(*(torch.from_numpy(x) for x in q))
    ref = jtri.barycentric_coords_tetra(*(jnp.asarray(x) for x in q))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    inside = ttri.inside_tetrahedra(*(torch.from_numpy(x) for x in q)).numpy()
    ref_in = np.asarray(jtri.inside_tetrahedra(*(jnp.asarray(x) for x in q)))
    # a point within rounding of a face may fall either side
    margin = np.min(np.stack([np.asarray(r) for r in ref]), axis=0)
    assert ((inside != ref_in) <= (np.abs(margin) < 1e-5)).all()
    assert 0 < inside.sum() < 512
    w = torch.from_numpy(rng.uniform(size=(4, 512)).astype(np.float32))
    np.testing.assert_allclose(
        ttri.barycentric_interpolation_tetra(*got, *w).numpy(),
        np.asarray(jtri.barycentric_interpolation_tetra(
            *ref, *(jnp.asarray(x.numpy()) for x in w))), rtol=1e-4, atol=1e-5)


def test_polygon_helpers_match_jax():
    ang = np.linspace(0, 2 * np.pi, 9, endpoint=False)
    star = np.stack([np.cos(ang), np.sin(ang)], 1) * np.where(
        np.arange(9) % 2, 0.4, 1.0)[:, None]
    star = star.astype(np.float32)
    for poly in (star, star[::-1].copy()):
        assert bool(ttri.winding2d(torch.from_numpy(poly))) == bool(
            jtri.winding2d(jnp.asarray(poly)))
    pts = np.random.RandomState(4).uniform(-1, 1, (2, 256)).astype(np.float32)
    got = ttri.point_inside_polygon(torch.from_numpy(star),
                                    torch.from_numpy(pts[0]),
                                    torch.from_numpy(pts[1])).numpy()
    ref = np.asarray(jtri.point_inside_polygon(jnp.asarray(star), pts[0], pts[1]))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < 256
    assert bool(ttri.point_inside_polygon(torch.from_numpy(star), 0.0, 0.0))


# --- (g) batch gaps, solve_cubic -------------------------------------------------------


def test_batch_helpers_match_jax():
    rng = np.random.RandomState(5)
    v = rng.normal(size=(256, 3)).astype(np.float32)
    v[:3] = [[0, 0, 0], [1, 1, 1], [0, 2, 2]]  # zero length, ties
    for name in ("length", "orthogonal"):
        got = getattr(tbatch, name)(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jbatch, name)(
            jnp.asarray(v))), **TOL, err_msg=name)
    o = tbatch.orthogonal(torch.from_numpy(v)).numpy()
    assert np.abs((o * v).sum(-1)).max() < 1e-5
    a = rng.normal(size=256).astype(np.float32)
    b = rng.normal(size=256).astype(np.float32)
    b[:5] = [0.0, 1e-13, -1e-13, 2.0, 0.0]
    a[:5] = [1.0, 1.0, 1.0, 0.0, -2.0]
    np.testing.assert_allclose(
        tbatch.safe_div(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbatch.safe_div(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        tbatch.safe_pow(torch.from_numpy(a), 1.7).numpy(),
        np.asarray(jbatch.safe_pow(jnp.asarray(a), 1.7)), **TOL)
    # NaN-free backward at the masked lanes, as the reference's
    x = torch.from_numpy(a).requires_grad_()
    (tbatch.safe_pow(x, 1.7) + tbatch.safe_div(x, torch.from_numpy(b))
     + tbatch.length(torch.zeros(4, 3, requires_grad=True)).sum()).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_solve_cubic_matches_jax():
    rng = np.random.RandomState(6)
    roots = np.sort(rng.uniform(-3, 3, (300, 3)), axis=1)
    lead = rng.uniform(0.5, 2.0, 300)
    coeffs = np.stack([lead, -lead * roots.sum(1),
                       lead * (roots[:, 0] * roots[:, 1] + roots[:, 1] * roots[:, 2]
                               + roots[:, 0] * roots[:, 2]),
                       -lead * roots.prod(1)], axis=1)
    # one real root: x^3 + x + c
    one = np.stack([np.ones(100), np.zeros(100), np.ones(100),
                    rng.uniform(-5, 5, 100)], axis=1)
    c = np.concatenate([coeffs, one]).astype(np.float32)
    got_r, got_v = troots.solve_cubic(*(torch.from_numpy(c[:, k]) for k in range(4)))
    ref_r, ref_v = jroots.solve_cubic(*(jnp.asarray(c[:, k]) for k in range(4)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    fin = np.isfinite(np.asarray(ref_r))
    np.testing.assert_allclose(got_r.numpy()[fin], np.asarray(ref_r)[fin],
                               rtol=1e-4, atol=1e-4)
    assert got_v.numpy()[:300].all() and got_v.numpy()[300:].sum() == 100
    np.testing.assert_allclose(got_r.numpy()[:300], roots, atol=2e-2)


# --- (h) samplers on the JAX draws' uniforms ------------------------------------------

N = 512
SAMPLERS = {
    "sphere": lambda M: M.SphereSampler(),
    "hemisphere_uniform": lambda M: M.HemisphereUniformSampler(),
    "hemisphere_cosine": lambda M: M.HemisphereCosineSampler(),
    "cone": lambda M: M.ConeUniformSampler(25.0),
    "disk": lambda M: M.DiskSampler3D(0.7),
    "rectangle": lambda M: M.RectangleSampler3D(2.0, 0.5),
    "triangle": lambda M: M.TriangleSampler3D((0, 0, 0), (1, 0.5, 0), (0.2, 1, 0.3)),
    "targeted_hemisphere": lambda M: M.TargetedHemisphereSampler(
        [((0.5, 0.2, 3.0), 0.4, 1.0), ((-1.0, 0.0, 2.0), 0.2, 3.0)]),
    "targeted_sphere": lambda M: M.TargetedSphereSampler(
        [((0.0, 0.0, -2.0), 0.5, 1.0), ((0.3, 0.1, 0.2), 0.5, 1.0)],
        origin=(0.1, 0.0, 0.0)),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_matches_jax(name):
    js, ts = SAMPLERS[name](JS), SAMPLERS[name](TS)
    key = jax.random.PRNGKey(11)
    ref, ref_pdf = js.samples_with_pdfs(key, N)
    if ts.n_uniforms == 4:  # the targeted samplers draw from a split key
        u = jax.random.uniform(jax.random.split(key)[0], (N, 4))
    else:
        u = jax.random.uniform(key, (N, 2))
    got = ts.from_uniforms(torch.from_numpy(np.array(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(ts.pdf(got).numpy(), np.asarray(ref_pdf), **TOL)
    if name == "triangle":
        assert ts.area == pytest.approx(js.area, rel=1e-6)
    # drawn from a generator, on its device
    g = torch.Generator().manual_seed(3)
    s, p = ts(g, 64, pdf=True)
    assert s.shape == (64, 3) and p.shape == (64,) and s.device.type == "cpu"


def test_sampler_pdf_normalisation():
    """tests/test_samplers.py's check on the port: each direction pdf
    integrates to 1 over the sphere (Monte Carlo over uniform directions),
    and each surface pdf is 1/area."""
    g = torch.Generator().manual_seed(0)
    d = TS.SphereSampler().sample(g, 400_000)
    for name in ("sphere", "hemisphere_uniform", "hemisphere_cosine", "cone",
                 "targeted_hemisphere", "targeted_sphere"):
        integral = float(SAMPLERS[name](TS).pdf(d).double().mean()) * 4 * math.pi
        assert integral == pytest.approx(1.0, abs=0.02), name
    for name in ("disk", "rectangle", "triangle"):
        s = SAMPLERS[name](TS)
        pts = s.sample(g, 8)
        assert torch.allclose(s.pdf(pts), torch.full((8,), 1.0 / s.area))


# --- (i) where the draws land ----------------------------------------------------------


def test_random_draws_default_to_the_card(monkeypatch):
    """With neither a generator nor a device a draw lands on the card, and
    raises where there is none; ``device="cpu"`` draws on the CPU."""
    assert trandom.uniform(None, (3,), device="cpu").device.type == "cpu"
    assert trandom.normal(None, shape=(3,), device="cpu").device.type == "cpu"
    assert trandom.probability(None, 1.0, (3,), device="cpu").all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trandom.uniform(None, (3,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.SphereSampler().sample(None, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert trandom._device(None, None) == torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    assert trandom._device(g, None) == torch.device("cpu")
