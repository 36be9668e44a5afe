"""The frozen work counts on a hand-worked case."""

from __future__ import annotations

import pytest

from portbench.reference.tables import Spec, general
from portbench.roofline import work

# one world sphere (kind 1), one world box (kind 2), one local box (kind
# 0); a Lambert, an emitter and a dielectric with its volume; two bins
SPEC = Spec(leaves=((0, 0, 0, 1), (1, 1, 1, 2), (1, 2, 2, 0)),
            mat_types=(1, 2, 6), volumes=((2, 2, 1, 2),), n_imp=2,
            has_importance=True, bins=2, max_depth=4, extinction_prob=0.1,
            extinction_min_depth=3, importance_sampling=True,
            important_path_weight=0.25)


def test_bounce_flops_by_hand():
    # 40 + 2B | leaves 45 + 60 + (33 + 70) | 90 | volume 30 + 12B
    # | importance 2 * 70 + 80 | dielectric 120 | 80 + 6B
    fwd = (40 + 4) + (45 + 60 + 103) + 90 + (30 + 24) + 220 + 120 + 92
    assert work.bounce_flops(SPEC) == fwd == 828
    # replayed winner: 40 + 2B + 33 + 90 + mean(60, 70, 70) = 66
    rep = 44 + 33 + 90 + 66 + 54 + 220 + 120 + 92
    assert work.bounce_bwd_flops(general(SPEC)) == 3 * rep + 16 == 2173


def test_forward_work_and_least_time_by_hand():
    w = work.Work()
    w.span_fwd(SPEC, lanes=100, segments=250)
    table = 20 * 3 + 3 * (10 + 4) + 6 * 2
    assert work.table_floats(SPEC) == table == 114
    state = 3 + 3 + 4 + 2
    assert w.bytes == 4 * (table + 2 * 100 * state + 10 * 250)
    assert w.ops == 250 * 828
    peak = {"hbm_bytes_per_s": 1e9, "f32_flops": 1e8}
    assert w.least_s(peak) == pytest.approx(max(w.bytes / 1e9,
                                                w.ops / 1e8))


def test_backward_work_by_hand():
    w = work.Work()
    w.span_bwd(general(SPEC), lanes=10, segments=30)
    entry, cot_in, cot_out = 3 + 3 + 2 + 2, 6 + 4, 6 + 2
    assert w.bytes == 4 * (2 * 114 + 10 * (entry + cot_in + cot_out)
                           + 10 * 30)
    assert w.ops == 30 * (work.bounce_flops(general(SPEC)) + 2173)


def test_peaks_of_the_named_card_only():
    assert work.peak_of("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    assert work.peak_of("some other card") is None
