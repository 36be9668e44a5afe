"""The port's function framework against source_tpu's, on the CPU.

  (a) every class of ``function.base`` and ``function.vector3d`` (the
      operator algebra, Constant, Arg, PythonFunction, Blend, the math
      wrappers, Atan4Q, autowrap) at seeded points of each arity;
  (b) the array interpolators: every interpolation x extrapolation type in
      1D, 2D and 3D, inside, on the edges, in the extrapolation band and
      beyond it (NaN where the reference gives NaN);
  (c) the mesh interpolators: their candidate grids equal to the JAX
      tables, values at seeded points, and ``Discrete3DMesh`` chunked
      against unchunked;
  (d) ``sample1d``/``sample1d_points``;
  (e) where a Function evaluates: on its tensors' device, else on the card
      unless made with ``device="cpu"``;
  (f) the world of demos/materials/tetrahedra_mesh_emission.py traced once
      against the reference's ``trace_rays`` on its uniforms: 256 rays, 4
      bins, 6 bounces, the ``Discrete3DMesh`` evaluated inside the
      inhomogeneous march of both packages; and
      ``scenes.tet_emission_world(2)`` compiled to the tables of the demo's
      own ``build_world(2)`` (4 bins), the emitter's closure aside: every
      table within rtol 1e-5 / atol 1e-6, the static structure equal, and
      the ``Discrete3DMesh`` each emission closure holds equal table for
      table.

Tolerances: rtol 1e-5 / atol 1e-6 for closed forms and interpolants (XLA
may contract products into FMAs, and its transcendentals round
differently by an ulp); mesh lookups equal except at points within 1e-5 of
a face, where either side's rounding may pick the neighbour.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import source_tpu.core.math.function as JF
from source_tpu.optical.material import (
    InhomogeneousVolumeEmitter as JInhomogeneous,
    NumericalIntegrator as JIntegrator,
)
from source_tpu.tracer.wavefront import (
    RayConfig as JaxRayConfig, init_rays as jax_init_rays,
    trace_rays as jax_trace_rays,
)

import source_tpu_torch as T
import source_tpu_torch.core.math.function as TF
from source_tpu_torch.core.math.function import mesh_interp
from source_tpu_torch import scenes

from test_torch_common import env, jax_compiled, to_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _points(n, arity, seed=0, lo=-1.5, hi=1.5):
    rng = np.random.RandomState(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(arity)]


def _eval_pair(fj, ft, pts):
    """(port, reference) at ``pts``; the reference under one ``jax.jit``
    (its eager autodiff of the edge derivatives compiles op by op). ``fj``
    and ``ft`` may be dicts of functions, evaluated in one call."""
    if isinstance(fj, dict):
        ref = jax.jit(lambda *a: {k: f(*a) for k, f in fj.items()})(
            *(jnp.asarray(p) for p in pts))
        return ({k: f(*(torch.from_numpy(p) for p in pts)).numpy()
                 for k, f in ft.items()},
                {k: np.asarray(v) for k, v in ref.items()})
    ref = np.asarray(jax.jit(lambda *a: fj(*a))(*(jnp.asarray(p) for p in pts)))
    got = ft(*(torch.from_numpy(p) for p in pts))
    return np.asarray(got.detach().numpy()), ref


# --- (a) base and vector3d ------------------------------------------------------


def _expressions(M, n):
    """The same expressions of arity n built from one package's classes."""
    d = f"{n}D"
    Arg = getattr(M, f"Arg{d}")
    x, y = Arg("x"), Arg("y" if n > 1 else "x")
    C = getattr(M, f"Constant{d}")
    Py = getattr(M, f"PythonFunction{d}")
    aw = getattr(M, f"autowrap_function{n}d")
    wrap = {k: getattr(M, f"{k}{d}") for k in
            ("Exp", "Sin", "Cos", "Tan", "Atan", "Erf")}
    out = {
        "arg": x, "const": C(2.5) + 0 * x, "sum": x + y, "rsum": 3.0 + x,
        "sub": x - 2.0 * y, "rsub": 1.0 - x, "mul": x * y, "div": x / (y + 3.0),
        "rdiv": 2.0 / (x * x + 1.0), "mod": x % 0.7, "rmod": 5.0 % (x + 2.0),
        "pow": abs(x) ** 1.5, "rpow": 2.0 ** x, "neg": -x, "pos": +x,
        "abs": abs(x - y), "eq": (x == x), "ne": x != y, "lt": x < y,
        "le": x <= 0.2, "gt": x > y, "ge": x >= 0.2,
        "python": Py(lambda *a: a[0] * a[-1] + 1.0),
        "autowrap": aw(lambda *a: a[0] - 0.5) * aw(3.0),
        "blend": getattr(M, f"Blend{d}")(x, y * 2.0, x + 0.5),
        "asin": getattr(M, f"Asin{d}")(x * 0.5),
        "acos": getattr(M, f"Acos{d}")(y * 0.5),
        "sqrt": getattr(M, f"Sqrt{d}")(abs(x)),
        "atan4q": getattr(M, f"Atan4Q{d}")(x, y - 0.3),
    }
    out.update({k.lower(): f(x * 0.8 + y * 0.1) for k, f in wrap.items()})
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
def test_base_functions_match_jax(n):
    pts = _points(256, n, seed=n)
    got, ref = _eval_pair(_expressions(JF, n), _expressions(TF, n), pts)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-5, atol=2e-6,
                                   err_msg=name)
    et = _expressions(TF, n)
    assert isinstance(et["sum"], getattr(TF, f"Function{n}D"))


def _vector_fields(M, n):
    d = f"{n}D"
    x = getattr(M, f"Arg{d}")("x")
    y = getattr(M, f"Arg{d}")("y" if n > 1 else "x")
    F = getattr(M, f"FloatToVector3DFunction{d}")(x, y * 2.0, 1.5)
    C = getattr(M, f"ConstantVector3D{d}")((0.5, -1.0, 2.0))
    return {
        "float_to": F, "const": C, "add": F + C, "sub": F - C, "neg": -F,
        "mul": F * x, "rmul": 2.0 * F, "div": F / (x * x + 1.0),
        "cross": F.cross(C), "dot": F.dot(C),
        "blend": getattr(M, f"BlendVector3D{d}")(F, C, x + 0.5),
    }


@pytest.mark.parametrize("n", [1, 2, 3])
def test_vector3d_functions_match_jax(n):
    pts = _points(128, n, seed=10 + n)
    got, ref = _eval_pair(_vector_fields(JF, n), _vector_fields(TF, n), pts)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], **TOL, err_msg=name)
    with pytest.raises(ValueError):
        TF.ConstantVector3D1D((1.0, 2.0))


# --- (b) array interpolators --------------------------------------------------------

INTERPS = [(i, e) for i in ("linear", "cubic")
           for e in ("none", "nearest", "linear", "quadratic")
           if e != "quadratic" or i == "cubic"]


def _grid_case(nd, seed):
    rng = np.random.RandomState(seed)
    axes = [np.cumsum(rng.uniform(0.2, 1.0, 6 + k)) - 2.0 for k in range(nd)]
    f = rng.normal(size=tuple(len(a) for a in axes))
    return axes, f


def _queries(axes, n, seed):
    """Points inside, on the edges, in the extrapolation band (0.5) and
    beyond it, per axis."""
    rng = np.random.RandomState(seed)
    out = []
    for a in axes:
        q = rng.uniform(a[0] - 0.9, a[-1] + 0.9, n)
        q[:4] = [a[0], a[-1], a[1], a[0] - 0.2]
        out.append(q.astype(np.float32))
    return out


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("interp,extrap", INTERPS)
def test_array_interpolators_match_jax(nd, interp, extrap):
    if extrap == "quadratic" and nd > 1:
        for M in (JF, TF):
            with pytest.raises(ValueError):
                M.Interpolator2DArray(*_grid_case(2, 0)[0],
                                      _grid_case(2, 0)[1], interp, extrap)
        return
    axes, f = _grid_case(nd, seed=nd)
    name = f"Interpolator{nd}DArray"
    rng_kw = ({"extrapolation_range": 0.5} if nd == 1 else
              {f"extrapolation_range_{c}": 0.5 for c in "xyz"[:nd]})
    fj = getattr(JF, name)(*axes, f, interp, extrap, **rng_kw)
    ft = getattr(TF, name)(*axes, f, interp, extrap, **rng_kw)
    got, ref = _eval_pair(fj, ft, _queries(axes, 400, seed=nd))
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


# --- (c) mesh interpolators ---------------------------------------------------------


def _tri_mesh(seed=0):
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 7))
    v = np.stack([gx.ravel(), gy.ravel()], 1)
    v += rng.uniform(-0.05, 0.05, v.shape)
    tris = []
    for j in range(6):
        for i in range(8):
            a = j * 9 + i
            tris += [[a, a + 1, a + 10], [a, a + 10, a + 9]]
    return v, np.asarray(tris, np.int32)


def _apart_near_faces(got, ref, margin_ok):
    differ = ~((got == ref) | (np.isnan(got) & np.isnan(ref)))
    assert (differ <= margin_ok).all(), np.nonzero(differ & ~margin_ok)
    return int(differ.sum())


def test_mesh_interpolators_2d_match_jax():
    v, t = _tri_mesh()
    vdata = np.random.RandomState(1).normal(size=len(v))
    tdata = np.arange(len(t), dtype=np.float64) * 0.5
    pts = _points(2000, 2, seed=2, lo=-1.2, hi=1.2)
    for limit in (True, False):
        ij = JF.Interpolator2DMesh(v, vdata, t, limit=limit, default_value=-1.0)
        it = TF.Interpolator2DMesh(v, vdata, t, limit=limit, default_value=-1.0,
                                   device="cpu")
        for k in ("cand", "grid_lo", "grid_inv"):
            np.testing.assert_array_equal(it._host[k].numpy(),
                                          np.asarray(getattr(ij, f"_{k}")), err_msg=k)
        got, ref = _eval_pair(ij, it, pts)
        fin = np.isfinite(ref) & np.isfinite(got)
        np.testing.assert_allclose(got[fin], ref[fin], **TOL)
        assert (np.isfinite(got) == np.isfinite(ref)).mean() > 0.999
        dj = JF.Discrete2DMesh(v, t, tdata, limit=limit, default_value=-1.0)
        dt = TF.Discrete2DMesh(v, t, tdata, limit=limit, default_value=-1.0,
                               device="cpu")
        got, ref = _eval_pair(dj, dt, pts)
        assert (~((got == ref) | (np.isnan(got) & np.isnan(ref)))).mean() < 0.002
        # one candidate slot a pass gives the same answer
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mesh_interp, "CHUNK_BYTES", 1)
            np.testing.assert_array_equal(
                dt(*(torch.from_numpy(p) for p in pts)).numpy(), got)


@pytest.fixture(scope="module")
def tet_mesh():
    verts, tets = scenes.icosphere_tets(2)
    data = 1.0 + 4.0 * np.clip(verts[tets].mean(axis=1)[:, 1] + 0.5, 0, 1)
    return verts, tets, data


def _near_a_face(verts, tets, ids, pts, tol=1e-5):
    """Points within ``tol`` of a face of their tetrahedron (float64)."""
    near = np.zeros(len(pts), bool)
    for i in np.nonzero(ids >= 0)[0]:
        p = verts[tets[ids[i]]]
        a, b, c = p[0] - p[3], p[1] - p[3], p[2] - p[3]
        lam = np.linalg.solve(np.stack([a, b, c], 1), pts[i] - p[3])
        near[i] = min(lam.min(), 1.0 - lam.sum()) < tol
    return near


def test_discrete3d_mesh_matches_jax(tet_mesh):
    verts, tets, data = tet_mesh
    fj = JF.Discrete3DMesh(verts, tets, data, limit=False)
    ft = TF.Discrete3DMesh(verts, tets, data, limit=False, device="cpu")
    assert ft._res == fj._res == 4
    for k in ("cand", "grid_lo", "grid_inv"):
        np.testing.assert_array_equal(ft._host[k].numpy(),
                                      np.asarray(getattr(fj, f"_{k}")), err_msg=k)
    assert ft._host["cand"].shape[1] == len(tets)  # one cell holds them all
    pts = np.stack(_points(4000, 3, seed=5, lo=-0.6, hi=0.6), 1)
    got, ref = _eval_pair(fj, ft, list(pts.T))
    ids = ft.locate(*torch.from_numpy(pts).T).numpy()
    _apart_near_faces(got, ref, _near_a_face(verts, tets, ids, pts))
    assert 0.2 < (ids >= 0).mean() < 0.8
    limited = TF.Discrete3DMesh(verts, tets, data, limit=True, device="cpu")
    assert np.isnan(limited(*torch.from_numpy(pts).T).numpy()[ids < 0]).all()


@pytest.mark.parametrize("chunk", [1, 3, 17])
def test_discrete3d_mesh_chunked_equals_unchunked(tet_mesh, chunk, monkeypatch):
    """``chunk`` candidate slots in the first pass (CHUNK_BYTES sized for
    all 1 000 queries; later passes, with fewer queries left, take more)
    against every slot at once, and against the default budget."""
    verts, tets, data = tet_mesh
    ft = TF.Discrete3DMesh(verts, tets, data, limit=False, device="cpu")
    q = torch.from_numpy(np.random.RandomState(chunk).uniform(
        -0.6, 0.6, (2, 3, 500)).astype(np.float32))  # [2, 3, 500]: any shape
    default = ft.locate(q[:, 0], q[:, 1], q[:, 2])
    monkeypatch.setattr(mesh_interp, "CHUNK_BYTES",
                        mesh_interp.SLOT_BYTES * 1000 * len(tets))
    whole = ft.locate(q[:, 0], q[:, 1], q[:, 2])
    whole_val = ft(q[:, 0], q[:, 1], q[:, 2])
    monkeypatch.setattr(mesh_interp, "CHUNK_BYTES",
                        mesh_interp.SLOT_BYTES * 1000 * chunk)
    part = ft.locate(q[:, 0], q[:, 1], q[:, 2])
    assert part.shape == (2, 500)
    assert torch.equal(whole, part)
    assert torch.equal(ft(q[:, 0], q[:, 1], q[:, 2]), whole_val)
    assert torch.equal(default, whole)


# --- (d) sample1d, (e) devices ---------------------------------------------------------


def test_sample1d_matches_jax():
    fj = JF.Sin1D(JF.Arg1D("x")) * 2.0 + 1.0
    ft = TF.Sin1D(TF.Arg1D("x", device="cpu")) * 2.0 + 1.0
    xj, yj = JF.sample1d(fj, -2.0, 3.0, 41)
    xt, yt = TF.sample1d(ft, -2.0, 3.0, 41)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert yt.dtype == np.float64
    np.testing.assert_allclose(TF.sample1d_points(
        TF.PythonFunction1D(lambda x: x * x, device="cpu"), [0.5, 2.0]),
        [0.25, 4.0])
    for bad in ((1.0, 0.0, 5), (0.0, 1.0, 0)):
        with pytest.raises(ValueError):
            TF.sample1d(ft, *bad)


def test_functions_evaluate_where_told(monkeypatch, tet_mesh):
    """Tensors evaluate on their device; numbers and numpy arrays on the
    object's device, the card by default, which raises without one."""
    f = TF.Sin2D(TF.Arg2D("x")) + TF.Arg2D("y")
    cpu = TF.Interpolator1DArray([0, 1, 2], [0, 1, 4], device="cpu")
    mesh = TF.Discrete3DMesh(*tet_mesh, limit=False, device="cpu")
    assert f(torch.tensor([0.5]), torch.tensor([1.0])).device.type == "cpu"
    assert cpu(np.asarray([0.5, 1.5])).tolist() == [0.5, 2.5]
    assert mesh(0.0, 0.1, 0.05).dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: f(0.5, 1.0),
                 lambda: TF.Interpolator1DArray([0, 1], [0, 1])(0.5),
                 lambda: TF.Discrete3DMesh(*tet_mesh)(0.0, 0.0, 0.0),
                 lambda: TF.Constant3D(1.0)()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- (f) the tetrahedral-emission demo traced against the reference --------------------

CFG = dict(max_depth=6, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25, max_iters=6)
B = 4


def _field_of(world, cls):
    """The ``cls`` instance the inhomogeneous emitter's closure holds."""
    (fn,) = [p.material.emission_function for p in world.primitives
             if hasattr(p.material, "emission_function")]
    (field,) = [c.cell_contents for c in fn.__closure__
                if isinstance(c.cell_contents, cls)]
    return field


def test_tet_emission_world_matches_the_demo():
    import source_tpu as S
    from demos.materials import tetrahedra_mesh_emission as demo
    from source_tpu_torch.bridge import ARRAY_FIELDS

    jw, tw = demo.build_world(2), scenes.tet_emission_world(2)
    js = S.compile_scene(jw, S.SpectralConfig(375.0, 740.0, B))
    ts = T.compile_scene(tw, T.SpectralConfig(375.0, 740.0, B), device="cpu")
    for k in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("n_leaves", "n_entities", "mat_types", "type_slices",
              "csg_entities", "mesh_entities"):
        assert getattr(ts, k) == getattr(js, k), k
    # the volume rows, the emitter object (index 3) aside
    (trow,), (jrow,) = ts.volume_entities, js.volume_entities
    assert trow[:3] + trow[4:] == jrow[:3] + jrow[4:]
    assert (trow[3].integrator.max_samples == jrow[3].integrator.max_samples
            == 24)
    ft = _field_of(tw, TF.Discrete3DMesh)
    fj = _field_of(jw, JF.Discrete3DMesh)
    assert ft._res == fj._res and (ft.limit, ft.default_value) == (
        fj.limit, fj.default_value) == (False, 0.0)
    for k in ("v", "t", "data", "cand", "grid_lo", "grid_inv"):
        np.testing.assert_array_equal(ft._host[k].numpy(),
                                      np.asarray(getattr(fj, f"_{k}")), err_msg=k)


def test_tet_emission_world_trace_matches_jax(tet_mesh):
    """The port's compiled scene handed to the JAX tracer with the JAX
    package's emitter in the volume's row (its own Discrete3DMesh closure in
    jnp); 16x16 camera rays of the demo."""
    verts, tets, data = tet_mesh
    ts = T.compile_scene(scenes.tet_emission_world(2),
                         T.SpectralConfig(375.0, 740.0, B), device="cpu")
    (row,) = ts.volume_entities
    field = JF.Discrete3DMesh(verts, tets, data, limit=False, default_value=0.0)

    def emission(p, direction, wavelengths):
        dens = field(p[..., 0], p[..., 1], p[..., 2])
        return jnp.broadcast_to(dens[..., None],
                                dens.shape + (wavelengths.shape[0],))

    jmat = JInhomogeneous(emission, integrator=JIntegrator(max_samples=24))
    js = dataclasses.replace(to_jax(ts), volume_entities=(
        row[:3] + (jmat,) + row[4:],))
    o, d = scenes.camera_rays(16, 16, **scenes.TET_CAMERA)
    key = jax.random.PRNGKey(13)
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
    a, b = np.asarray(ref.radiance), got.radiance.numpy()
    same = ((got.alive.numpy() == np.asarray(ref.alive))
            & (got.depth.numpy() == np.asarray(ref.depth))
            & np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1))
    assert np.isfinite(b).all()
    assert (~same).sum() <= 1, np.nonzero(~same)
    assert int(got.segments) == int(ref.segments)
    # the volume glows: lanes through the box gather emission
    assert (b.sum(-1) > 0).mean() > 0.2
