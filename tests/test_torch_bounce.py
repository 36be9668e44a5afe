"""``bounce_core`` and its closed forms: source_tpu_torch against source_tpu.

The same inputs, made from a numpy seed, go through the JAX function and its
PyTorch counterpart on the CPU.

* Closed forms (``_hit_*``, ``_n_*``, ``_contains``, the quartic, the
  sampling helpers) run eagerly on both sides. Values agree to rtol 1e-5 /
  atol 1e-6: both are float32 with the same association, only libm-level
  functions (pow, sin, cos) differ in the last digit. Boolean outputs and
  hit/miss may flip on a lane within rounding of a threshold: at most 0.2 %.
  The torus and the quartic are held to atol 5e-3 instead: the float32
  Ferrari solve on coefficients that grow like |o|^4 is ill-conditioned, and
  the reference itself moves by up to 4e-3 in hit distance between its jitted
  and its eager evaluation.
* ``bounce_core`` runs against ``_bounce_core`` evaluated eagerly (under
  ``jax.disable_jit()``: no XLA compile of the whole bounce, which took most
  of this file's time) on flat [N] arrays (no Pallas needed), N = 512, 5
  bins, over 5 bounces of the glass Cornell box and of the zoo scene. Decide
  mode: the fraction of lanes whose bitfield differs is bounded by 0.5 % (a
  lane at a threshold may choose differently: libm-level functions differ in
  the last digit, and under ``jax.jit`` XLA also contracts a*b+c into FMAs,
  which PyTorch does not). Replay
  mode, with the reference's bits: o, d, thr, rad_delta, depth at rtol 1e-4 /
  atol 1e-5, except lanes that hit the torus (5e-2, as above).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world
import source_tpu as S
from source_tpu.core.math import polyroots as JP
from source_tpu.tracer import pallas_fused as PF
from source_tpu.tracer.wavefront import RayConfig as JaxRayConfig

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.core.math import polyroots as TP
from source_tpu_torch.tracer import fused

from test_torch_common import B, CFG, carry_scene, jax_zoo

N = 512
STEPS = 5
MISS = 1e30


# --- closed forms ---------------------------------------------------------------


def _rays_local(rng, n):
    """Ray origins round a unit-scale solid, aimed at it with scatter; a few
    axis-aligned and degenerate directions exercise the guards."""
    o = rng.uniform(-2.0, 2.0, (3, n))
    target = rng.uniform(-0.4, 0.4, (3, n))
    d = target - o
    d /= np.linalg.norm(d, axis=0)
    d[:, :8] = np.eye(3)[:, [0, 1, 2, 0, 1, 2, 0, 1]] * np.array(
        [1, 1, 1, -1, -1, -1, 1, 1])
    d[:, 8] = 0.0  # dead-lane direction
    return o.astype(np.float32), d.astype(np.float32)


_PARAMS = {
    "sphere": [0.5], "box": [-0.4, -0.3, -0.2, 0.4, 0.3, 0.2],
    "cylinder": [0.35, 0.7], "cone": [0.35, 0.6], "parabola": [0.35, 0.5],
    "torus": [0.8, 0.25],
}
_TYPE = {"sphere": 0, "box": 1, "cylinder": 2, "cone": 3, "parabola": 4,
         "torus": 5}


def _pp(name, mod):
    p = (_PARAMS[name] + [0.0] * 8)[:8]
    if mod is jnp:
        return [jnp.float32(x) for x in p]
    return [torch.tensor(x, dtype=torch.float32) for x in p]


def _both(fn_name, make_args):
    """Outputs of PF.<fn> on jnp arrays and fused.<fn> on tensors, flattened
    to lists of numpy arrays."""
    def flat(out):
        out = out if isinstance(out, (tuple, list)) else (out,)
        res = []
        for x in out:
            res.extend(flat(x) if isinstance(x, (tuple, list)) else [np.asarray(x)])
        return res

    j = getattr(PF, fn_name)(*make_args(jnp, lambda a: jnp.asarray(a)))
    t = getattr(fused, fn_name)(*make_args(torch, lambda a: torch.from_numpy(a)))
    return flat(j), flat(t)


def _compare(j, t, rtol=1e-5, atol=1e-6, max_flip=0.002):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.shape == b.shape
        if a.dtype == bool:
            assert np.mean(a != b) <= max_flip
            continue
        miss_a, miss_b = a >= MISS, b >= MISS
        assert np.mean(miss_a != miss_b) <= max_flip
        both = ~miss_a & ~miss_b
        bad = np.abs(a - b)[both] > atol + rtol * np.abs(a)[both]
        assert np.mean(bad) <= max_flip, float(np.abs(a - b)[both].max())


@pytest.mark.parametrize("name", list(_PARAMS))
def test_hit_closed_form(name):
    rng = np.random.RandomState(_TYPE[name])
    o, d = _rays_local(rng, 2048)
    tmin = np.full(2048, 1e-4, np.float32)

    def args(mod, conv):
        return (tuple(conv(o)), tuple(conv(d)), _pp(name, mod), conv(tmin))

    j, t = _both(f"_hit_{name}", args)
    assert np.isfinite(t[0]).all()
    tol = dict(atol=5e-3) if name == "torus" else {}
    _compare(j, t, **tol)
    assert 0.2 < np.mean(t[0] < MISS) <= 1.0  # the solid is actually hit


@pytest.mark.parametrize("name", list(_PARAMS))
def test_normal_closed_form(name):
    rng = np.random.RandomState(10 + _TYPE[name])
    p = rng.uniform(-0.8, 0.8, (3, 1024)).astype(np.float32)

    def args(mod, conv):
        return (tuple(conv(p)), _pp(name, mod))

    # a face pick flips where two faces are equidistant within rounding
    _compare(*_both(f"_n_{name}", args), max_flip=0.005)


@pytest.mark.parametrize("name", list(_PARAMS))
def test_contains_closed_form(name):
    rng = np.random.RandomState(20 + _TYPE[name])
    p = rng.uniform(-1.0, 1.0, (3, 1024)).astype(np.float32)
    j = np.asarray(PF._contains(_TYPE[name], tuple(jnp.asarray(p)), _pp(name, jnp)))
    t = fused._contains(_TYPE[name], tuple(torch.from_numpy(p)),
                        _pp(name, torch)).numpy()
    assert np.mean(j != t) <= 0.002
    assert 0.0 < t.mean() < 1.0


def test_quartic_components():
    """Ferrari + Newton against the JAX solver on random quartics with four
    real roots; dead lanes (a == 0) report no root."""
    rng = np.random.RandomState(31)
    roots = np.sort(rng.uniform(-3.0, 3.0, (4, 1024)), axis=0)
    c = [np.ones(1024)]
    for r in roots:  # expand prod (x - r)
        c = [c[0]] + [c[i] - r * c[i - 1] for i in range(1, len(c))] + [-r * c[-1]]
    coef = [x.astype(np.float32) for x in c]
    coef[0][:4] = 0.0
    j = JP.solve_quartic_components(*[jnp.asarray(x) for x in coef], 3)
    t = TP.solve_quartic_components(*[torch.from_numpy(x) for x in coef], 3)
    for (jx, jv), (tx, tv) in zip(j, t):
        jv, tv = np.asarray(jv), tv.numpy()
        assert not tv[:4].any()
        assert np.mean(jv != tv) <= 0.01
        both = jv & tv
        assert np.mean(np.abs(np.asarray(jx) - tx.numpy())[both] > 5e-3) <= 0.01


@pytest.mark.parametrize("fn_name", [
    "_quad", "_make_frame", "_hemisphere_cosine", "_cone_uniform",
    "_conductor_fresnel", "_norm3", "_reflect", "_inv_dir", "_spow"])
def test_component_math(fn_name):
    rng = np.random.RandomState(41)
    n = 1024
    u = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    v = rng.normal(size=(3, n)).astype(np.float32)
    v[:, :4] = 0.0  # zero vectors and zero coefficients hit the guards
    unit = (v / np.maximum(np.linalg.norm(v, axis=0), 1e-9)).astype(np.float32)
    unit[:, :4] = np.asarray([[0, 0, 0, 0], [0, 0, 0, 0], [1, -1, 1, -1]])
    inputs = {
        "_quad": lambda c: (c(v[0]), c(v[1]), c(v[2])),
        "_make_frame": lambda c: (c(unit[0]), c(unit[1]), c(unit[2])),
        "_hemisphere_cosine": lambda c: (c(u[0]), c(u[1])),
        "_cone_uniform": lambda c: (c(u[0]), c(u[1]), c(2 * u[2] - 1)),
        "_conductor_fresnel": lambda c: (c(u[0]), c(1 + v[1] ** 2), c(3 * u[2])),
        "_norm3": lambda c: (c(v[0]), c(v[1]), c(v[2])),
        "_reflect": lambda c: (tuple(c(v)), tuple(c(unit))),
        "_inv_dir": lambda c: (c(v[0] * 1e-3),),
        "_spow": lambda c: (c(v[0]), c(3 * u[1])),
    }[fn_name]
    j, t = _both(fn_name, lambda mod, conv: inputs(conv))
    for x in t:
        assert np.isfinite(x[np.abs(x) < MISS]).all()
    _compare(j, t)


# --- the whole bounce -------------------------------------------------------------


def _np_state(o, d, thr, alive, depth):
    return dict(o=np.asarray(o), d=np.asarray(d), thr=np.asarray(thr),
                alive=np.asarray(alive), depth=np.asarray(depth))


def _run_scene(js):
    """STEPS bounces of ``js`` through the eager JAX ``_bounce_core`` and, on
    the same per-bounce inputs, through the port's ``bounce_core`` in decide
    and in replay mode. Returns one record per bounce."""
    ts = carry_scene(js)
    jspec = PF.fused_spec(js, JaxRayConfig(**CFG))
    tspec = fused.fused_spec(ts, T.RayConfig(**CFG))
    jtab = PF.pack_tabvec(js, jspec)
    ttab = fused.pack_tabvec(ts, tspec)
    np.testing.assert_array_equal(np.asarray(jtab), ttab.numpy())
    tget = ttab.unbind(0).__getitem__

    def jbounce(tab, o, d, thr, alive, depth, u):
        with jax.disable_jit():
            return PF._bounce_core(
                jspec, lambda k: tab[k],
                dict(o=tuple(jnp.asarray(o)), d=tuple(jnp.asarray(d)),
                     thr=tuple(jnp.asarray(thr)), alive=jnp.asarray(alive),
                     depth=jnp.asarray(depth)), tuple(jnp.asarray(u)), None)

    o, d = scenes.scatter_rays(N, seed=1)
    st = _np_state(o.T, d.T, np.ones((B, N), np.float32), np.ones(N, bool),
                   np.zeros(N, np.float32))
    rng = np.random.RandomState(3)
    records = []
    for _ in range(STEPS):
        u = rng.uniform(size=(10, N)).astype(np.float32)
        jo = jbounce(jtab, st["o"], st["d"], st["thr"], st["alive"],
                     st["depth"], u)
        tst = dict(o=tuple(torch.from_numpy(st["o"].copy())),
                   d=tuple(torch.from_numpy(st["d"].copy())),
                   thr=tuple(torch.from_numpy(st["thr"].copy())),
                   alive=torch.from_numpy(st["alive"].copy()),
                   depth=torch.from_numpy(st["depth"].copy()))
        tu = tuple(torch.from_numpy(u))
        jbits = np.asarray(jo["bits"])
        decide = fused.bounce_core(tspec, tget, tst, tu, None)
        replay = fused.bounce_core(tspec, tget, tst, tu,
                                   torch.from_numpy(jbits.copy()))
        records.append(dict(jax=jo, decide=decide, replay=replay, bits=jbits,
                            alive=st["alive"].copy()))
        st = _np_state(np.stack(jo["o"]), np.stack(jo["d"]),
                       np.stack(jo["thr"]), jo["alive_next"], jo["depth"])
    return tspec, records


@pytest.fixture(scope="module")
def runs():
    return {
        "cornell": _run_scene(S.compile_scene(
            build_world(glass=True), S.SpectralConfig(375.0, 740.0, B))),
        "zoo": _run_scene(jax_zoo()),
    }


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_bounce_decide_bits(runs, name):
    """Decide mode: the port makes the same discrete choices as the reference
    on all but a bounded fraction of lanes."""
    _, records = runs[name]
    differ = sum(int((r["bits"] != r["decide"]["bits"].numpy()).sum())
                 for r in records)
    lanes = STEPS * N
    print(f"{name}: {differ} of {lanes} bitfields differ "
          f"({100.0 * differ / lanes:.3f} %)")
    assert differ / lanes <= 0.005
    assert sum(int((r["bits"] & 1).sum()) for r in records) > N  # real work


@pytest.mark.parametrize("name", ["cornell", "zoo"])
@pytest.mark.parametrize("field", ["o", "d", "thr", "rad_delta", "depth",
                                   "alive_next", "bits"])
def test_bounce_replay(runs, name, field):
    """Replay mode with the reference's bits reproduces its state."""
    tspec, records = runs[name]
    torus = [g for g, leaf in enumerate(tspec.leaves) if leaf[0] == 5]
    for r in records:
        got, ref = r["replay"][field], r["jax"][field]
        if isinstance(got, tuple):
            got = torch.stack(got).numpy()
            ref = np.stack([np.asarray(x) for x in ref])
        else:
            got, ref = got.numpy(), np.asarray(ref)
        if field in ("alive_next", "bits"):
            np.testing.assert_array_equal(got, ref)
            continue
        assert np.isfinite(got).all()
        on_torus = np.isin((r["bits"] >> 16) & 0x1FF, torus) & ((r["bits"] & 3) == 3)
        np.testing.assert_allclose(got[..., ~on_torus], ref[..., ~on_torus],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[..., on_torus], ref[..., on_torus],
                                   rtol=5e-2, atol=5e-2)


def test_plain_kernel_versions_agree_with_core():
    """The plain versions the CUDA kernels are held against: one bounce and a
    span of bounces on the packed SoA state, bits zeroed where the ray is not
    alive, and the span equal to the loop of single bounces."""
    ts = T.compile_scene(scenes.zoo(), T.SpectralConfig(375.0, 740.0, B),
                         device="cpu")
    spec = fused.fused_spec(ts, T.RayConfig(**CFG))
    tab = fused.pack_tabvec(ts, spec)
    desc = torch.as_tensor(fused.spec_descriptor(spec))
    o, d = scenes.scatter_rays(256, seed=2)
    st = fused.pack_state(T.init_rays(torch.from_numpy(o), torch.from_numpy(d), B))
    u = torch.from_numpy(
        np.random.RandomState(4).uniform(size=(4, 10, 256)).astype(np.float32))
    span_st, span_bits = fused.fused_span_fwd(spec, tab, desc, st, u)
    cur = st
    for i in range(4):
        cur, bits = fused.fused_bounce_fwd(spec, tab, desc, cur, u[i])
        assert torch.equal(bits, span_bits[i])
        assert bool(((bits & 1) > 0).eq(bits != 0).all())
    for k in ("o", "d", "thr", "rad", "aux"):
        assert torch.equal(cur[k], span_st[k])
    assert fused.fused_bounce_fwd.launches == 0  # CPU tensors launch nothing
    assert fused.fused_span_fwd.launches == 0
    with pytest.raises(ValueError):
        fused.fused_bounce_fwd(spec, tab, desc, st, u[0][:9])
