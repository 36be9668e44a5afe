"""The adjoint kernels' schedule in source_tpu_torch: live lanes binned by
code path.

``fused_bounce_bwd`` runs its kernel over the live lanes of a bounce sorted
by a code-path key (``bin_live_lanes``, a counting sort on the card), and
``fused_span_bwd`` walks a span step by step with each step's live lanes
regrouped by the same key. Only the schedule changes: the per-lane adjoint
is ``bounce_bwd_plain``'s, which tests/test_torch_grad.py holds against the
JAX reference's ``jax.vjp`` of its bounce. These tests close the chain on the
plain versions, on the CPU, with no JAX: the binning is a stable sort of
exactly the live lanes; one key means one code path; the adjoint over the
binned lanes, scattered back, is the adjoint in lane order (state cotangents
exactly, each lane's arithmetic is the same, except where PyTorch's CPU loop
rounds a lane by its position, see SIMD_TAIL; the table cotangent is a sum
in another order, rtol 1e-6); and the step-aligned chain of binned adjoints
is ``span_bwd_plain``.

Inputs: the glass Cornell box and the zoo scene, 512 rays, 5 bins, 5
bounces, uniforms and cotangents from numpy seeds.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.primitive.analytic import TYPE_TORUS
from source_tpu_torch.tracer import fused

N, B, STEPS = 512, 5, 5
CFG = dict(max_depth=6, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25,
           max_iters=STEPS)
WORLDS = {"cornell": lambda: scenes.cornell_box(glass=True),
          "zoo": scenes.zoo}
# the stored choices a key holds beside the winner leaf
BRANCH = ((1 << fused.B_TRANSMIT) | (1 << fused.B_TIR)
          | (1 << fused.B_PICKLIGHT) | (1 << fused.B_EXIT)
          | (1 << fused.B_PARITY))


@pytest.fixture(scope="module", params=sorted(WORLDS))
def span(request):
    """One scene's span: spec, table, every bounce's entry state (by the
    forward chain), the bitfields and random cotangents."""
    scene = T.compile_scene(WORLDS[request.param](),
                            T.SpectralConfig(375.0, 740.0, B), device="cpu")
    spec = fused.general_spec(fused.fused_spec(scene, T.RayConfig(**CFG)))
    tab = fused.pack_tabvec(scene, spec).detach()
    desc = torch.as_tensor(fused.spec_descriptor(spec))
    o, d = scenes.scatter_rays(N, seed=31)
    st0 = fused.pack_state(T.init_rays(torch.from_numpy(o),
                                       torch.from_numpy(d), B))
    rng = np.random.RandomState(32)
    u = torch.from_numpy(rng.uniform(size=(STEPS, 10, N)).astype(np.float32))
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((3, N), (3, N), (B, N), (B, N))]
    entries, bits, cur = [], [], st0
    for k in range(STEPS):
        new, b = fused.fused_bounce_fwd(spec, tab, desc, cur, u[k])
        entries.append(cur)
        bits.append(b)
        cur = new
    return dict(name=request.param, spec=spec, tab=tab, st0=st0, u=u,
                cots=cots, entries=entries, bits=torch.stack(bits),
                cot_scale=float(max(c.abs().max() for c in cots)))


def check_binning(bits):
    """``bin_live_lanes_plain`` of ``bits``: a stable permutation of exactly
    the live lanes with non-decreasing keys; returns (perm, count, key)."""
    perm, count = fused.bin_live_lanes_plain(bits)
    key = fused.adjoint_key_plain(bits)
    n = int(count[0])
    live = perm[:n].long()
    assert perm.dtype == torch.int32 and count.dtype == torch.int32
    assert n == int((bits != 0).sum())
    assert torch.equal(torch.sort(live).values, (bits != 0).nonzero().squeeze(1))
    assert bool((perm[n:] == -1).all())
    k = key[live]
    assert bool((k >= 0).all()) and bool((k[1:] >= k[:-1]).all())
    same = k[1:] == k[:-1]
    assert bool((live[1:][same] > live[:-1][same]).all())  # stable
    assert bool((key[bits == 0] == -1).all())
    return perm, count, key


@pytest.mark.parametrize("k", range(STEPS))
def test_binning_is_a_stable_sort_of_the_live_lanes(span, k):
    bits = span["bits"][k]
    assert int((bits != 0).sum()) > 0
    perm, count = fused.bin_live_lanes(span["spec"], bits)
    assert fused.bin_live_lanes.launches == 0  # CPU tensors launch nothing
    ref = check_binning(bits)
    assert torch.equal(perm, ref[0]) and torch.equal(count, ref[1])


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.tuples(st.booleans(), st.booleans(),
                          st.integers(0, 47), st.integers(0, (1 << 16) - 1)),
                min_size=1, max_size=300))
def test_binning_of_random_bitfields(lanes):
    """Random bitfields: dead lanes (0), misses (B_ALIVE without B_HIT) and
    hits on any of 48 leaves with any low bits set."""
    bits = torch.tensor([
        0 if not alive else (1 | (low & ~2) if not hit
                             else (low | 3 | (win << fused.WIN_SHIFT)))
        for alive, hit, win, low in lanes], dtype=torch.int32)
    check_binning(bits)


def test_one_key_is_one_code_path(span):
    """Lanes share a key exactly when they share what the reverse pass
    branches on: a miss, or the winner leaf (its solid type and material
    type from ``spec``, its table entries) and the stored choices."""
    spec = span["spec"]
    tid = torch.tensor([t for (t, _e, _m, _k) in spec.leaves])
    mtype = torch.tensor([spec.mat_types[m] for (_t, _e, m, _k) in spec.leaves])
    seen = 0
    for bits in span["bits"]:
        key = fused.adjoint_key_plain(bits)
        live = bits != 0
        hit = ((bits >> fused.B_HIT) & 1) == 1
        win = ((bits >> fused.WIN_SHIFT) & 0x1FF).long().clamp(max=len(tid) - 1)
        path = torch.where(hit[:, None], torch.stack(
            [torch.ones_like(win), tid[win], mtype[win], win,
             (bits & BRANCH).long()], 1), 0)
        pairs = torch.cat([path, key[:, None].long()], 1)[live].unique(dim=0)
        assert pairs[:, :-1].unique(dim=0).shape[0] == pairs.shape[0]
        assert pairs[:, -1].unique().shape[0] == pairs.shape[0]
        assert int(key.max()) < fused.n_adjoint_keys(spec)
        seen += pairs.shape[0]
    assert seen > 2 * STEPS


# PyTorch's CPU loops run the elementwise math of a contiguous tensor in
# SIMD blocks (SLEEF) and its last few elements as scalars (libm), which may
# round a transcendental an ulp apart: the plain version rounds a lane by its
# position among the lanes it evaluates. A lane is held bit for bit where it
# sits in the SIMD body of both evaluations (at most 2 x 32 floats of a loop
# are scalar); elsewhere to an ulp (rtol 1e-6), and where such a lane hit a
# torus, whose f32 quartic amplifies an ulp (ROADMAP.md, queue 3), to the
# kernels' per-lane tolerance, rtol 1e-3 / atol 1e-4 of the largest
# cotangent. The kernels have no such dependence: chip_smoke.py holds
# fused_span_bwd to the chain of fused_bounce_bwd on every lane.
SIMD_TAIL = 64


def remainder_lanes(order, n, N):
    """Lanes whose position in ``order`` (of n lanes) may be a scalar one."""
    on = torch.zeros(N, dtype=torch.bool)
    on[order[n - n % SIMD_TAIL:n].long()] = True
    return on


def binned_bounce_bwd(spec, tab, e, u, bits, go, gd, gthr, g_rad):
    """``bounce_bwd_plain`` over the live lanes in binned order, scattered
    back: the schedule of the adjoint kernels on the plain version. Also
    returns the lanes that sit in the scalar remainder of this evaluation or
    of ``bounce_bwd_plain``'s in lane order."""
    perm, count = fused.bin_live_lanes_plain(bits)
    n = int(count[0])
    idx = perm[:n].long()
    got = fused.bounce_bwd_plain(
        spec, tab, *[x[:, idx] for x in (e["o"], e["d"], e["thr"], e["aux"],
                                         u)],
        bits[idx], *[g[:, idx] for g in (go, gd, gthr, g_rad)])
    out = []
    for full, part in zip((go, gd, gthr), got[:3]):
        new = full.clone()
        new[:, idx] = part
        out.append(new)
    N = bits.shape[0]
    scalar = (remainder_lanes(idx, n, N)
              | remainder_lanes((bits != 0).nonzero().squeeze(1), n, N))
    torus = torch.tensor([t == TYPE_TORUS for (t, _e, _m, _k) in spec.leaves])
    hit = ((bits >> fused.B_HIT) & 1) == 1
    on_torus = scalar & hit & torus[((bits >> fused.WIN_SHIFT) & 0x1FF).long()
                                    .clamp(max=len(torus) - 1)]
    return (out[0], out[1], out[2], got[3]), (scalar, on_torus)


def assert_same(got, want, lanes, cot_scale):
    """State cotangents bit for bit on every lane outside the scalar lanes
    ``lanes[0]``, to an ulp on those but the torus hits ``lanes[1]``; the
    table cotangent to rtol 1e-6 of its largest entry (the same terms summed
    in another order)."""
    scalar, on_torus = lanes
    ulp = scalar & ~on_torus
    for g, w in zip(got[:3], want[:3]):
        assert torch.isfinite(w).all()
        assert torch.equal(g[:, ~scalar], w[:, ~scalar])
        np.testing.assert_allclose(g[:, ulp].numpy(), w[:, ulp].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g[:, on_torus].numpy(),
                                   w[:, on_torus].numpy(),
                                   rtol=1e-3, atol=1e-4 * cot_scale)
    scale = float(want[3].abs().max())
    assert scale > 0.0
    assert float((got[3] - want[3]).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("k", range(STEPS))
def test_binned_adjoint_is_the_adjoint(span, k):
    spec, tab, u, bits = span["spec"], span["tab"], span["u"], span["bits"]
    e, cots = span["entries"][k], span["cots"]
    want = fused.bounce_bwd_plain(spec, tab, e["o"], e["d"], e["thr"], e["aux"],
                                  u[k], bits[k], *cots)
    got, lanes = binned_bounce_bwd(spec, tab, e, u[k], bits[k], *cots)
    assert_same(got, want, lanes, span["cot_scale"])


def test_step_aligned_chain_is_the_span_adjoint(span):
    """The schedule of ``fused_span_bwd``: step n_steps - 1 .. 0, at each the
    lanes that entered the step and have a bitfield there, binned; equal to
    ``span_bwd_plain`` (a lane rounded as a scalar at one step carries that
    ulp into the steps before it)."""
    spec, tab, u, bits = span["spec"], span["tab"], span["u"], span["bits"]
    entries, (go, gd, gthr, g_rad) = span["entries"], span["cots"]
    entered = sum((e["aux"][0] > 0.5).int() for e in entries)
    assert 0 < int((bits[-1] != 0).sum()) < int((bits[0] != 0).sum())
    gtab = torch.zeros_like(tab)
    scalar = torch.zeros(N, dtype=torch.bool)
    on_torus = torch.zeros(N, dtype=torch.bool)
    for s in range(STEPS - 1, -1, -1):
        b = torch.where(entered > s, bits[s], 0)
        (go, gd, gthr, gt), sc = binned_bounce_bwd(spec, tab, entries[s], u[s],
                                                   b, go, gd, gthr, g_rad)
        gtab = gtab + gt
        scalar |= sc[0]
        on_torus |= sc[1]
    st0 = {k: span["st0"][k] for k in ("o", "d", "thr", "aux")}
    want = fused.span_bwd_plain(spec, tab, st0, u, bits, *span["cots"])
    assert_same((go, gd, gthr, gtab), want, (scalar, on_torus),
                span["cot_scale"])
    never = ~(bits != 0).any(0)
    assert torch.equal(go[:, never], span["cots"][0][:, never])


def test_cpu_adjoint_takes_the_plain_version_with_or_without_bins(span):
    """On CPU tensors the wrapper is ``bounce_bwd_plain`` and the binning is
    its plain version: neither launches anything."""
    spec, tab, u, bits = span["spec"], span["tab"], span["u"], span["bits"]
    e, cots = span["entries"][1], span["cots"]
    desc = torch.as_tensor(fused.spec_descriptor(spec))
    args = (e["o"], e["d"], e["thr"], e["aux"], u[1], bits[1], *cots)
    plain = fused.bounce_bwd_plain(spec, tab, *args)
    got = fused.fused_bounce_bwd(spec, tab, desc, *args)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    perm, count = fused.bin_live_lanes(spec, bits[1])
    ref_perm, ref_count = fused.bin_live_lanes_plain(bits[1])
    assert torch.equal(perm, ref_perm) and torch.equal(count, ref_count)
    assert fused.fused_bounce_bwd.launches == 0
    assert fused.bin_live_lanes.launches == 0
