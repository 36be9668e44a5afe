"""The forward kernels' schedule in source_tpu_torch: live lanes, dense warps.

``fused_span_fwd`` walks each warp's 32 lanes in registers while at least
``fused.SPILL_AT`` of them are alive (the head), then hands the survivors to
lane-major rows and runs them step by step, each step's lanes dense over
the grid (the tail); ``fused_bounce_fwd`` runs only the lanes the previous
bounce left alive, from a list that bounce wrote. Only the schedule
changes: a lane's arithmetic, uniforms and bitfields are its own. These
tests hold the schedule's plain model, ``span_fwd_scheduled_plain``, to
``span_fwd_plain`` at both ends of SPILL_AT and between, and the per-bounce
chain with live lists to the chain without, on the CPU with no JAX.

Tolerance: bitfields equal on every lane whose winner is never a torus;
states to rtol 1e-6 / atol 1e-7: PyTorch's CPU loops round a lane's
transcendentals by its position in the tensor (a SIMD body with SLEEF, a
scalar tail with libm), and the schedule gathers lanes to other positions.
On torus lanes, whose f32 quartic amplifies that ulp (ROADMAP.md, queue 3),
as tests/test_torch_bvh_records.py holds them: where the scheduled walk and
the plain version agree on every bitfield and so does a float64 evaluation,
the scheduled walk is at most F64_FACTOR times as far from float64 as the
plain version, plus F64_ATOL; other choices on at most MAX_FLIP of lanes.

Inputs: the glass Cornell box and the zoo scene, 512 rays, 5 bins, 8
bounces, uniforms from a numpy seed or Philox (``philox_uniforms``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import source_tpu_torch as T
from source_tpu_torch import scenes
from source_tpu_torch.primitive.analytic import TYPE_TORUS
from source_tpu_torch.tracer import fused

N, B, STEPS = 512, 5, 8
CFG = dict(max_depth=16, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25,
           max_iters=STEPS)
WORLDS = {"cornell": lambda: scenes.cornell_box(glass=True),
          "zoo": scenes.zoo}
RTOL, ATOL = 1e-6, 1e-7
F64_FACTOR, F64_ATOL = 2.0, 1e-4
MAX_FLIP = 0.005


@pytest.fixture(scope="module", params=sorted(WORLDS))
def scene(request):
    """One scene's forward tables and entry state."""
    sc = T.compile_scene(WORLDS[request.param](),
                         T.SpectralConfig(375.0, 740.0, B), device="cpu")
    spec, entry = fused.scene_tables(sc, T.RayConfig(**CFG))
    o, d = scenes.scatter_rays(N, seed=41)
    st0 = fused.pack_state(T.init_rays(torch.from_numpy(o),
                                       torch.from_numpy(d), B))
    return dict(name=request.param, spec=spec, desc=entry["desc"],
                tab=fused.forward_table(sc, spec, entry), st0=st0)


def uniforms(rng):
    if rng == "host":
        return torch.from_numpy(np.random.RandomState(42).uniform(
            size=(STEPS, fused.N_UNIFORMS, N)).astype(np.float32))
    return fused.philox_uniforms(torch.tensor([0x5EED, 43], dtype=torch.int32),
                                 N, 0, STEPS)


_REF = {}


def reference(scene, rng):
    """``span_fwd_plain`` on one scene's inputs, once: in f32, and in f64
    where a torus can be hit (else None)."""
    key = (scene["name"], rng)
    if key not in _REF:
        spec, tab, st0 = scene["spec"], scene["tab"], scene["st0"]
        u = uniforms(rng)
        ref = fused.span_fwd_plain(spec, tab, st0, u)
        r64 = None
        if any(t == TYPE_TORUS for (t, _e, _m, _k) in spec.leaves):
            r64 = fused.span_fwd_plain(
                spec, tab.double(), {k: v.double() for k, v in st0.items()},
                u.double())
        _REF[key] = (u, ref, r64)
    return _REF[key]


def torus_lanes(spec, bits):
    """Lanes whose winner is a torus in any bounce of ``bits``."""
    torus = torch.tensor([t == TYPE_TORUS for (t, _e, _m, _k) in spec.leaves])
    win = ((bits >> fused.WIN_SHIFT) & 0x1FF).long().clamp(max=len(torus) - 1)
    hit = ((bits >> fused.B_HIT) & 1) == 1
    return (hit & torus[win]).any(0)


@pytest.mark.parametrize("spill_at", [0, 8, 32])
@pytest.mark.parametrize("rng", ["host", "philox"])
def test_scheduled_walk_is_the_span(scene, rng, spill_at):
    spec, tab, st0 = scene["spec"], scene["tab"], scene["st0"]
    u, (ref, ref_bits), r64 = reference(scene, rng)
    got, bits = fused.span_fwd_scheduled_plain(spec, tab, st0, u, spill_at)
    # lanes died while others went on: warps thinned
    live = (ref_bits != 0).sum(1)
    assert int(live[0]) > int(live[3]) > 0
    torus = torus_lanes(spec, ref_bits) | torus_lanes(spec, bits)
    assert (scene["name"] == "zoo") == bool(torus.any())
    same = (bits == ref_bits).all(0)
    assert bool(same[~torus].all())
    assert int((~same).sum()) <= MAX_FLIP * N
    off = ~torus
    for k in fused._STATE_KEYS:
        assert torch.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k][:, off].numpy(),
                                   ref[k][:, off].numpy(), rtol=RTOL, atol=ATOL)
    if r64 is None:
        return
    on = torus & same & (r64[1] == ref_bits).all(0)
    if bool(on.any()):
        for k in ("o", "d", "thr", "rad"):
            w = r64[0][k][:, on]
            dev_got = float((got[k][:, on].double() - w).abs().max())
            dev_ref = float((ref[k][:, on].double() - w).abs().max())
            assert dev_got <= F64_FACTOR * dev_ref + F64_ATOL, k


def test_spill_at_ends(scene):
    """SPILL_AT = 0 never hands a lane off (the lane-order kernel); SPILL_AT =
    32 hands a warp's survivors off at its first death: the tail then runs
    every bounce after the first death of a warp. Counted on the plain
    model's queues through its gathers of the rows."""
    spec, tab, st0 = scene["spec"], scene["tab"], scene["st0"]
    u, (ref, ref_bits), _ = reference(scene, "host")
    calls = []
    real = fused._state_of_rows

    def counting(rows, bins):
        calls.append(rows.shape[0])
        return real(rows, bins)

    fused._state_of_rows = counting
    try:
        for spill_at in (0, 32):
            calls.clear()
            fused.span_fwd_scheduled_plain(spec, tab, st0, u, spill_at)
            tail = sum(calls[:-1])  # the last call reads the final rows
            if spill_at == 0:
                assert tail == 0 and calls[-1] == 0
            else:
                # a warp is full until its first death; every later bounce
                # of its lanes is the tail's
                entered = torch.cat([
                    st0["aux"][:1] > 0.5,
                    ((ref_bits[:-1] >> fused.B_ALIVENEXT) & 1) == 1])
                full = entered.reshape(STEPS, N // 32, 32).all(2)
                first = torch.where(full.all(0), STEPS,
                                    (~full).int().argmax(0))
                late = (torch.arange(STEPS)[:, None]
                        >= first[torch.arange(N) // 32][None])
                assert tail == int((entered & late).sum()) > 0
    finally:
        fused._state_of_rows = real


def test_live_lanes_plain(scene):
    st0 = scene["st0"]
    aux = st0["aux"].clone()
    aux[0, ::3] = 0.0
    live = fused.live_lanes_plain(aux)
    assert live.dtype == torch.int32
    assert torch.equal(live.long(), (aux[0] > 0.5).nonzero().squeeze(1))
    lanes, count = fused._live_list_plain(aux)
    assert int(count[0]) == live.numel() == N - len(range(0, N, 3))
    assert torch.equal(lanes[:live.numel()], live)
    assert bool((lanes[live.numel():] == -1).all())


# the per-bounce kernels on the forward route's schedule: K1, K9 (given the
# chain's bits) and K10; K1's cases are named by in_place alone, as
# before K9 and K10 joined them
PER_BOUNCE = ("fused_bounce_fwd", "fused_bounce_replay", "fused_bounce_io")


@pytest.mark.parametrize("kernel,in_place", [
    pytest.param(k, p, id=str(p) if k == PER_BOUNCE[0]
                 else f"{k.removeprefix('fused_bounce_')}-{p}")
    for k in PER_BOUNCE for p in (False, True)])
def test_perbounce_chain_with_live_lists(scene, kernel, in_place):
    """Along the chain of ``fused_bounce_fwd``, each bounce's kernel handed
    the list of the lanes alive on entry (the previous bounce's survivors),
    ``survivors=True`` and ``in_place`` returns the state (and bitfield) it
    returns without them (on CPU tensors the plain version: the list changes
    nothing), and lists exactly the lanes alive after its bounce (for
    ``fused_bounce_io``, which changes no lane, those alive on entry).
    ``fused_bounce_replay`` replays the chain's own bits. No kernel
    launches."""
    spec, tab, desc, st0 = (scene[k] for k in ("spec", "tab", "desc", "st0"))
    u, _, _ = reference(scene, "host")
    wrapper = getattr(fused, kernel)
    plain, live = st0, None
    thinned = False
    for k in range(STEPS):
        entry = plain
        plain, want = fused.fused_bounce_fwd(spec, tab, desc, entry, u[k])
        extra = (want,) if kernel == "fused_bounce_replay" else ()
        ref = wrapper(spec, tab, desc, entry, u[k], *extra)
        ref = ref if isinstance(ref, tuple) else (ref,)
        *got, (lanes, count) = wrapper(
            spec, tab, desc, {key: v.clone() for key, v in entry.items()},
            u[k], *extra, live=live, survivors=True, in_place=in_place)
        assert len(got) == len(ref)
        for key in fused._STATE_KEYS:
            assert torch.equal(got[0][key], ref[0][key])
        if len(ref) > 1:
            assert torch.equal(got[1], ref[1])
        after = entry if kernel == "fused_bounce_io" else got[0]
        n = int(count[0])
        assert torch.equal(lanes[:n], fused.live_lanes_plain(after["aux"]))
        thinned = thinned or 0 < n < N
        live = (lanes, count) if kernel != "fused_bounce_io" \
            else fused._live_list_plain(plain["aux"])
    assert thinned
    assert all(getattr(fused, w).launches == 0 for w in PER_BOUNCE)


def test_python_spill_at_is_the_kernels():
    src = (Path(fused.__file__).parents[1] / "csrc"
           / "fused_kernels.cu").read_text()
    assert int(re.search(r"constexpr int SPILL_AT = (\d+);", src).group(1)) \
        == fused.SPILL_AT
    assert 0 <= fused.SPILL_AT <= fused.WARP
