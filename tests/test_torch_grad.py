"""The differentiable path: ``render_loss_and_grads`` of source_tpu_torch
against source_tpu, plus the checks the port's adjoint stands on alone.

The step as a whole, glass Cornell box: the reference is
``source_tpu.parallel.engine.render_loss_and_grads`` with SOURCE_TPU_FUSED=0,
that is XLA autodiff of ``trace_step``, which
tests/test_fused.py::test_gradient_parity holds equal to the Pallas backward;
256 rays, 5 bins, 8 iterations, no compaction, target 0. The port traces the
SAME compiled scene (carried across with ``carry_scene``), the same rays and
the reference's uniforms ``uniform(fold_in(key, 0x7A000 + start),
(n_steps, N, 10))`` on the CPU, where its kernels' wrappers take the plain
versions: ``bounce_bwd_plain`` is ``torch.autograd.grad`` of ``bounce_core``.
Tolerance: loss rtol 1e-5; every float field of the scene finite and within
atol 2e-4 of the reference after dividing both by max(|reference|, 1e-6):
the tolerance tests/test_fused.py allows between the reference's own two
backward routes.

The zoo scene has no such reference: on it that route returns NaN in
``leaf_w2l``, ``leaf_params``, ``mat_params``, ``imp_centre`` and
``imp_radius`` (same rays and key, with and without the compaction stage of
tests/test_fused.py), and XLA autodiff of a scan over the reference's
``_bounce_core`` takes minutes to compile. So the zoo scene is held bounce by
bounce instead: ``bounce_bwd_plain`` against ``jax.vjp`` of the reference's
``_bounce_core`` in replay mode, evaluated eagerly, under random cotangents
(the function of the reference's backward kernel; the first bounce, which
reaches every solid and material: an eager vjp takes 19 s), rtol 1e-3 / atol 1e-4
times the cotangents' magnitude per lane, lanes that hit the torus apart;
and as a whole by what needs no reference (both span modes agree, Euler's
identity over every emission row, nothing NaN).

torch and JAX differ where a maximum, minimum or clamp sits exactly on a tie
(torch.clamp passes the whole gradient on its closed interval, jnp.maximum
splits a tie in half); no lane of these inputs sits on one. Compaction's
gradient is covered on the port's side only (Euler identity below); a
compacted reference would need another XLA compile.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demos.cornell_box import build_world
import source_tpu as S
from source_tpu.parallel.engine import render_loss_and_grads as jax_loss_and_grads
from source_tpu.tracer import pallas_fused as PF
from source_tpu.tracer.wavefront import RayConfig as JaxRayConfig

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.tracer import fused

from test_torch_common import (
    B, CFG, carry_scene, euler_ratio, jax_zoo, uniform_streams,
)

N = 256
FIELDS = ("leaf_w2l", "leaf_params", "mat_params", "mat_spectra", "mat_scalars",
          "imp_centre", "imp_radius", "imp_weight", "imp_cdf", "entity_w2l")
SPANS = ("perbounce", "multi")
KEY = 13


@pytest.fixture(scope="module")
def pairs():
    return {
        "cornell": S.compile_scene(build_world(glass=True),
                                   S.SpectralConfig(375.0, 740.0, B)),
        "zoo": jax_zoo(),
    }


@pytest.fixture(scope="module")
def steps(pairs):
    """Per scene the port's (loss, grads) per span mode, and for the Cornell
    box the reference's, on the same rays and uniforms."""
    out = {}
    prev = os.environ.get("SOURCE_TPU_FUSED")
    os.environ["SOURCE_TPU_FUSED"] = "0"
    try:
        for name, js in pairs.items():
            o, d = scenes.scatter_rays(N, seed=2)
            key = jax.random.PRNGKey(KEY)
            target = np.zeros((N, B), np.float32)
            ref = None
            if name == "cornell":
                loss, g = jax_loss_and_grads(
                    js, JaxRayConfig(**CFG), jnp.asarray(o), jnp.asarray(d), key,
                    jnp.asarray(target))
                ref = (float(loss), {f: np.asarray(getattr(g, f), np.float64)
                                     for f in FIELDS})
            ts = carry_scene(js)
            got = {span: T.render_loss_and_grads(
                ts, T.RayConfig(**CFG), o, d, target,
                u_all=uniform_streams(key)[0],
                span=span, device="cpu") for span in SPANS}
            out[name] = (ts, ref, got)
    finally:
        if prev is None:
            os.environ.pop("SOURCE_TPU_FUSED", None)
        else:
            os.environ["SOURCE_TPU_FUSED"] = prev
    return out


@pytest.mark.parametrize("span", SPANS)
def test_loss_matches_jax(steps, span):
    _, (ref_loss, _), got = steps["cornell"]
    loss, grads = got[span]
    assert np.isfinite(ref_loss) and ref_loss > 0.0
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert not loss.requires_grad
    assert set(grads) == set(FIELDS)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("span", SPANS)
def test_gradient_matches_jax(steps, span, field):
    ts, (_, ref), got = steps["cornell"]
    a = ref[field]
    b = got[span][1][field].double().numpy()
    assert b.shape == a.shape == tuple(getattr(ts, field).shape)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    scale = max(np.abs(a).max(), 1e-6)
    print(f"cornell/{span}/{field}: largest |ref| {np.abs(a).max():.4g}, "
          f"largest deviation {np.abs(a - b).max() / scale:.3g} of it")
    np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_both_span_modes_are_one_function(steps, name):
    """One kernel per span or one per bounce each way: the same gradients to
    f32 summation noise, finite in every field, and the fields the trace
    reads are not all zero."""
    ts, _, got = steps[name]
    for f in FIELDS:
        a, b = got["multi"][1][f], got["perbounce"][1][f]
        assert a.shape == getattr(ts, f).shape and torch.isfinite(a).all(), f
        scale = max(float(a.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-5 * scale, f
    for f in ("leaf_w2l", "leaf_params", "mat_spectra"):
        assert bool((got["multi"][1][f] != 0).any()), f
    assert float(got["multi"][0]) == float(got["perbounce"][0])


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_euler_identity_on_emission_rows(steps, name, span):
    """Radiance is homogeneous of degree 1 in the emission rows, so against a
    zero target sum(value * gradient) over them equals 2 loss: a check of the
    gradient that needs no reference. On the zoo scene it runs through every
    kind of emitter (uniform, anisotropic, checkerboard, volume) behind
    mirrors, conductors and a null surface."""
    ts, _, got = steps[name]
    assert abs(euler_ratio(ts, *got[span]) - 1.0) <= 1e-4


def test_euler_identity_through_compaction(steps):
    """The same identity with compaction stages that overflow: gathers,
    reweighting and the scatter into the full-batch radiance carry the
    gradient (a lane compacted away keeps the gradient of the radiance it
    had)."""
    ts = steps["cornell"][0]
    cfg = T.RayConfig(**dict(CFG, compact_schedule=((2, 2), (3, 2))))
    o, d = scenes.scatter_rays(N, seed=4)
    target = np.zeros((N, B), np.float32)
    final = T.render_batch(ts, cfg, o, d, torch.Generator().manual_seed(3),
                           differentiable=True, device="cpu")
    assert int(final.overflow) > 0
    loss, grads = T.render_loss_and_grads(
        ts, cfg, o, d, target, torch.Generator().manual_seed(3), device="cpu")
    np.testing.assert_allclose(
        float(loss), float(torch.mean(final.radiance ** 2)), rtol=1e-6)
    assert abs(euler_ratio(ts, loss, grads) - 1.0) <= 1e-4


def test_differentiable_route_matches_forward_route(steps):
    """``render_batch(differentiable=True)`` on the general spec returns the
    forward route's radiance on the same uniforms (fast records and general
    records are one function in value), runs every bounce, and leaves the
    caller's scene without ``requires_grad``."""
    ts = steps["cornell"][0]
    o, d = scenes.scatter_rays(N, seed=2)
    u_all = uniform_streams(jax.random.PRNGKey(KEY))[0]
    cfg = T.RayConfig(**CFG)
    fwd = T.render_batch(ts, cfg, o, d, u_all=u_all, device="cpu")
    for span in SPANS:
        dif = T.render_batch(ts, cfg, o, d, u_all=u_all, span=span,
                             differentiable=True, device="cpu")
        np.testing.assert_allclose(dif.radiance.numpy(), fwd.radiance.numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert int(dif.segments) == int(fwd.segments)
        assert not dif.radiance.requires_grad  # the scene requires none
    assert not any(getattr(ts, f).requires_grad for f in FIELDS)
    with pytest.raises(ValueError):
        T.render_batch(ts, cfg, o, d, u_all=u_all, span="both",
                       differentiable=True, device="cpu")


def test_entry_points_default_to_the_card(steps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ts = steps["cornell"][0]
    o, d = scenes.scatter_rays(8, seed=2)
    with pytest.raises(RuntimeError):
        T.render_loss_and_grads(ts, T.RayConfig(**CFG), o, d,
                                np.zeros((8, B), np.float32))
    with pytest.raises(RuntimeError):
        T.render_batch(ts, T.RayConfig(**CFG), o, d, differentiable=True)


# --- one bounce against jax.vjp of the reference's bounce core -------------------

BOUNCES = {"zoo": (0,)}
N_BOUNCE = 384


@pytest.fixture(scope="module")
def bounce_adjoints(pairs):
    """Per (scene, bounce): the port's ``bounce_bwd_plain`` and the eager
    ``jax.vjp`` of the reference's replayed ``_bounce_core`` on the lanes
    that took part, on the same entry state, uniforms, bits and cotangents."""
    out = {}
    rng = np.random.RandomState(17)
    for name, ks in BOUNCES.items():
        js = pairs[name]
        ts = carry_scene(js)
        jspec = PF.general_spec(PF.fused_spec(js, JaxRayConfig(**CFG)))
        tspec = fused.general_spec(fused.fused_spec(ts, T.RayConfig(**CFG)))
        jtab = PF.pack_tabvec(js, jspec)
        ttab = fused.pack_tabvec(ts, tspec).detach()
        o, d = scenes.scatter_rays(N_BOUNCE, seed=5)
        st = fused.pack_state(T.init_rays(torch.from_numpy(o),
                                          torch.from_numpy(d), B))
        for k in range(max(ks) + 1):
            u = torch.from_numpy(
                rng.uniform(size=(10, N_BOUNCE)).astype(np.float32))
            new, bits = fused.bounce_fwd_plain(tspec, ttab, st, u)
            if k in ks:
                cots = [torch.from_numpy(rng.normal(size=c).astype(np.float32))
                        for c in ((3, N_BOUNCE), (3, N_BOUNCE), (B, N_BOUNCE),
                                  (B, N_BOUNCE))]
                got = fused.bounce_bwd_plain(
                    tspec, ttab, st["o"], st["d"], st["thr"], st["aux"], u, bits,
                    *cots)
                idx = (bits != 0).nonzero().squeeze(1)
                sel = lambda x: tuple(jnp.asarray(x[:, idx].numpy()))
                jbits = jnp.asarray(bits[idx].numpy())
                alive = jnp.asarray((st["aux"][0, idx] > 0.5).numpy())
                depth = jnp.asarray(st["aux"][1, idx].numpy())
                uu = sel(u)

                def f(o3, d3, thr, tab):
                    res = PF._bounce_core(
                        jspec, lambda i: tab[i],
                        dict(o=o3, d=d3, thr=thr, alive=alive, depth=depth),
                        uu, jbits)
                    return res["o"], res["d"], res["thr"], res["rad_delta"]

                with jax.disable_jit():
                    _, vjp = jax.vjp(f, sel(st["o"]), sel(st["d"]),
                                     sel(st["thr"]), jtab)
                    ref = vjp(tuple(sel(c) for c in cots))
                ref = [np.stack([np.asarray(x) for x in r]) for r in ref[:3]] + [
                    np.asarray(ref[3])]
                out[(name, k)] = dict(spec=tspec, bits=bits, idx=idx, got=got,
                                      ref=ref, cots=cots)
            st = new
    return out


@pytest.mark.parametrize("which", ["go", "gd", "gthr"])
@pytest.mark.parametrize("case", [(n, k) for n, ks in BOUNCES.items() for k in ks],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_bounce_adjoint_matches_jax_vjp(bounce_adjoints, case, which):
    r = bounce_adjoints[case]
    i = ("go", "gd", "gthr").index(which)
    idx, bits = r["idx"], r["bits"]
    got, ref = r["got"][i][:, idx].numpy(), r["ref"][i]
    scale = max(float(c.abs().max()) for c in r["cots"])
    assert idx.numel() > N_BOUNCE // 8 and np.isfinite(got).all()
    torus = [g for g, leaf in enumerate(r["spec"].leaves) if leaf[0] == 5]
    b = bits[idx].numpy()
    on_torus = np.isin((b >> 16) & 0x1FF, torus) & ((b & 3) == 3)
    bad = (np.abs(got - ref) > 1e-4 * scale + 1e-3 * np.abs(ref)).any(0)
    print(f"{case}/{which}: {int(bad[~on_torus].sum())} of {int((~on_torus).sum())} "
          f"lanes beyond tolerance, {int(bad[on_torus].sum())} of "
          f"{int(on_torus.sum())} torus lanes; largest deviation "
          f"{np.abs(got - ref)[:, ~on_torus].max():.3g}")
    # a lane within rounding of a choice the bitfield does not store (which
    # root, which face) may reverse another branch
    assert bad[~on_torus].mean() <= 0.005
    # torus lanes: the f32 quartic's cotangent grows like 1 / P'(root); both
    # differentiate the same Ferrari seed and Newton steps, so most agree
    if on_torus.any():
        assert bad[on_torus].mean() <= 0.1
    # lanes that took no part are a pass-through
    off = (bits == 0)
    assert torch.equal(r["got"][i][:, off], r["cots"][i][:, off])


@pytest.mark.parametrize("case", [(n, k) for n, ks in BOUNCES.items() for k in ks],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_bounce_table_cotangent_matches_jax_vjp(bounce_adjoints, case):
    """The table cotangent of one bounce, within 2e-4 of the largest entry
    (1e-2 on the zoo scene, where single torus lanes carry cotangents of
    1e2 to 1e3 times the others' into the leaf and importance sections)."""
    r = bounce_adjoints[case]
    got, ref = r["got"][3].numpy(), r["ref"][3]
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    scale = np.abs(ref).max()
    dev = np.abs(got - ref).max() / scale
    print(f"{case}: table cotangent deviates by {dev:.3g} of its largest entry")
    assert scale > 0 and dev <= (1e-2 if case[0] == "zoo" else 2e-4)


# --- the module that holds the kernels ---------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "zoo"])
def test_general_spec_and_table_match_jax(pairs, name):
    js = pairs[name]
    ts = carry_scene(js)
    jspec = PF.general_spec(PF.fused_spec(js, JaxRayConfig(**CFG)))
    tspec = fused.general_spec(fused.fused_spec(ts, T.RayConfig(**CFG)))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert all(k == 0 for (_t, _e, _m, k) in tspec.leaves)
    np.testing.assert_array_equal(
        fused.pack_tabvec(ts, tspec).numpy(),
        np.asarray(PF.pack_tabvec(js, jspec)))


@pytest.mark.parametrize("name,general", [
    ("cornell", False), ("cornell", True), ("zoo", True)])
def test_pack_tabvec_gradient_matches_jax(pairs, name, general):
    """A random table cotangent pulled back to the scene's tensors through
    ``pack_tabvec``: torch.autograd against jax.grad, fast records (the
    inverse and the 8-corner product of the world AABB) and general ones."""
    js = pairs[name]
    jspec = PF.fused_spec(js, JaxRayConfig(**CFG))
    ts = carry_scene(js)
    tspec = fused.fused_spec(ts, T.RayConfig(**CFG))
    if general:
        jspec, tspec = PF.general_spec(jspec), fused.general_spec(tspec)
    cot = np.random.RandomState(7).normal(size=fused.tab_size(tspec)).astype(
        np.float32)
    jg = jax.grad(lambda s: jnp.sum(PF.pack_tabvec(s, jspec) * cot),
                  allow_int=True)(js)
    leaves = {f: getattr(ts, f).clone().requires_grad_(True) for f in FIELDS}
    tab = fused.pack_tabvec(dataclasses.replace(ts, **leaves), tspec)
    tg = torch.autograd.grad(tab, list(leaves.values()), torch.from_numpy(cot),
                             allow_unused=True)
    for f, g in zip(FIELDS, tg):
        ref = np.asarray(getattr(jg, f), np.float32)
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=f)


def test_tables_are_cached_and_follow_in_place_edits(steps):
    """The spec, the descriptor and the forward table are kept on the scene;
    an in-place edit of a scene tensor (an optimiser's step) is seen by the
    next ``render_batch``, and so is a replaced tensor."""
    ts0 = steps["cornell"][0]
    ts = dataclasses.replace(ts0, mat_spectra=ts0.mat_spectra.clone())
    assert ts.fused_cache == {} and ts.fused_cache is not ts0.fused_cache
    cfg = T.RayConfig(**CFG)
    o, d = scenes.scatter_rays(N, seed=2)
    u_all = uniform_streams(jax.random.PRNGKey(KEY))[0]
    first = T.render_batch(ts, cfg, o, d, u_all=u_all, device="cpu")
    spec, entry = fused.scene_tables(ts, cfg)
    tab = entry["tab"]
    assert fused.scene_tables(ts, cfg)[1] is entry
    assert fused.scene_tables(ts, cfg)[0] is spec
    again = T.render_batch(ts, cfg, o, d, u_all=u_all, device="cpu")
    assert entry["tab"] is tab  # not packed again
    assert torch.equal(again.radiance, first.radiance)
    with torch.no_grad():
        ts.mat_spectra.mul_(2.0)
    edited = T.render_batch(ts, cfg, o, d, u_all=u_all, device="cpu")
    assert entry["tab"] is not tab
    assert not torch.equal(edited.radiance, first.radiance)
    assert float(edited.radiance.sum()) > float(first.radiance.sum())
    ts.mat_spectra = ts.mat_spectra * 0.5
    back = T.render_batch(ts, cfg, o, d, u_all=u_all, device="cpu")
    assert torch.equal(back.radiance, first.radiance)
    # the differentiable route packs its table anew: it is a graph node
    general, gentry = fused.scene_tables(ts, cfg, general=True)
    T.render_batch(ts, cfg, o, d, u_all=u_all, differentiable=True, device="cpu")
    assert gentry["tab"] is None and gentry["desc"].dtype == torch.int32


@pytest.fixture(scope="module")
def zoo_span():
    """The zoo scene over a span long enough that most lanes are dead:
    entry state, uniforms, the forward's bits and random cotangents."""
    ts = T.compile_scene(scenes.zoo(), T.SpectralConfig(375.0, 740.0, B),
                         device="cpu")
    spec = fused.general_spec(fused.fused_spec(ts, T.RayConfig(**CFG)))
    tab = fused.pack_tabvec(ts, spec).detach()
    desc = torch.as_tensor(fused.spec_descriptor(spec))
    n, n_steps = 192, 10
    o, d = scenes.scatter_rays(n, seed=8)
    st0 = fused.pack_state(T.init_rays(torch.from_numpy(o), torch.from_numpy(d), B))
    rng = np.random.RandomState(9)
    u = torch.from_numpy(rng.uniform(size=(n_steps, 10, n)).astype(np.float32))
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((3, n), (3, n), (B, n), (B, n))]
    out, bits = fused.fused_span_fwd(spec, tab, desc, st0, u)
    return spec, tab, desc, st0, u, bits, cots, out


def test_span_adjoints_agree_and_dead_lanes_pass_through(zoo_span):
    """``fused_span_bwd`` equals the reverse chain of ``fused_bounce_bwd``
    over the saved entry states; a lane with a zero bitfield gets exactly its
    incoming cotangent back and adds nothing to the table; nothing is NaN."""
    spec, tab, desc, st0, u, bits, cots, out = zoo_span
    n_steps = u.shape[0]
    assert float((bits[-1] != 0).float().mean()) < 0.2  # most lanes are dead
    go, gd, gthr, gtab, replay = fused.fused_span_bwd(
        spec, tab, desc, st0, u, bits, *cots, return_replay=True)
    # the plain replay runs the lanes that took part gathered together, and
    # PyTorch's vectorised CPU math rounds a lane by its position: equal to an
    # ulp here; bit for bit is what the kernel's replay is held to on the card
    np.testing.assert_allclose(
        replay.numpy(),
        torch.cat([out["o"], out["d"], out["thr"], out["aux"]]).numpy(),
        rtol=1e-6, atol=1e-7)
    entries, st = [], st0
    for k in range(n_steps):
        new, b = fused.fused_bounce_fwd(spec, tab, desc, st, u[k])
        assert torch.equal(b, bits[k])
        entries.append(st)
        st = new
    c, chain_tab = cots[:3], torch.zeros_like(tab)
    for k in range(n_steps - 1, -1, -1):
        e = entries[k]
        before = c
        *c, gt = fused.fused_bounce_bwd(spec, tab, desc, e["o"], e["d"], e["thr"],
                                        e["aux"], u[k], bits[k], *c, cots[3])
        dead = bits[k] == 0
        for new, old in zip(c, before):
            assert torch.equal(new[:, dead], old[:, dead])
        chain_tab += gt
    for a, b in zip((go, gd, gthr), c):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    scale = float(chain_tab.abs().max())
    assert scale > 0.0 and torch.isfinite(gtab).all()
    assert float((gtab - chain_tab).abs().max()) <= 1e-5 * scale
    never = ~(bits != 0).any(0)
    assert torch.equal(go[:, never], cots[0][:, never])
    assert fused.fused_bounce_bwd.launches == 0  # CPU tensors launch nothing
    assert fused.fused_span_bwd.launches == 0


def test_zero_bitfield_is_the_identity(zoo_span):
    """``bounce_bwd_plain`` on a state whose bitfields are all 0 returns the
    cotangents it was given and a zero table cotangent, and never evaluates
    the bounce there (NaN inputs on those lanes do no harm)."""
    spec, tab, desc, st0, u, bits, cots, _ = zoo_span
    nan = {k: torch.full_like(st0[k], float("nan")) for k in ("o", "d", "thr")}
    zero = torch.zeros_like(bits[0])
    go, gd, gthr, gtab = fused.bounce_bwd_plain(
        spec, tab, nan["o"], nan["d"], nan["thr"], st0["aux"], u[0], zero, *cots)
    for got, want in zip((go, gd, gthr), cots):
        assert torch.equal(got, want)
    assert not bool(gtab.any())
    # half the lanes live: the other half still passes through exactly
    half = torch.where(torch.arange(bits.shape[1]) % 2 == 0, bits[0], zero)
    got = fused.bounce_bwd_plain(spec, tab, st0["o"], st0["d"], st0["thr"],
                                 st0["aux"], u[0], half, *cots)
    off = half == 0
    for g, want in zip(got[:3], cots):
        assert torch.equal(g[:, off], want[:, off]) and torch.isfinite(g).all()
    assert bool(got[3].any())


def test_adjoint_wrappers_refuse_what_the_kernels_do_not_take(zoo_span):
    spec, tab, desc, st0, u, bits, cots, _ = zoo_span
    with pytest.raises(ValueError):
        fused.fused_bounce_bwd(spec, tab, desc, st0["o"], st0["d"], st0["thr"],
                               st0["aux"], u[0][:9], bits[0], *cots)
    with pytest.raises(ValueError):
        fused.fused_span_bwd(spec, tab, desc, st0, u[:, :9], bits, *cots)
    fast = fused.fused_spec(
        T.compile_scene(scenes.cornell_box(glass=True),
                        T.SpectralConfig(375.0, 740.0, B), device="cpu"),
        T.RayConfig(**CFG))
    assert any(k for (_t, _e, _m, k) in fast.leaves)  # it has fast records
    assert fused.bounce_bwd_flops(fast) > 0
