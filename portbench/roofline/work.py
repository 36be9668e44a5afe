"""The frozen work counts of the fused kernels and the table of peaks.

A kernel's share of its roofline is the least time the card could take for
the work the algorithm needs on these inputs, over the kernel's measured
device time. The work is counted whatever implements it: the scene's table
read once a launch, each ray's state read once and written once, the
uniforms that the traced segments consume, and operations equal to traced
segments times a per-bounce count of the scene. No bitfield, live list or
workspace is counted. The per-bounce counts are a frozen copy of the
port's ``fused.bounce_flops`` and ``fused.bounce_bwd_flops`` (hand counts
of the bounce's closed forms: adds, multiplies, compares and selects 1;
divide, sqrt, sin/cos and pow about 8), kept here so that the program
cannot change its own yardstick. The peaks are the published ones of the
card the run names; on a card not in the table no share is computed.
"""

from __future__ import annotations

import json
from pathlib import Path

TYPE_SPHERE, TYPE_BOX, TYPE_CYLINDER = 0, 1, 2
TYPE_CONE, TYPE_PARABOLA, TYPE_TORUS = 3, 4, 5
MAT_DIELECTRIC = 6
VOL_BEER = 1
N_UNIFORMS = 10
F32 = 4

_PER_TYPE = {TYPE_SPHERE: 60, TYPE_BOX: 70, TYPE_CYLINDER: 110,
             TYPE_CONE: 130, TYPE_PARABOLA: 140, TYPE_TORUS: 520}


def _material_and_volume_ops(spec, B):
    ops = 0
    for (_e, _m, kind, _leaf) in spec.volumes:
        ops += 30 + (12 * B if kind == VOL_BEER else 3 * B)
    present = {spec.mat_types[m] for (_t, _e, m, _k) in spec.leaves}
    if spec.importance_sampling and spec.has_importance:
        ops += spec.n_imp * 70 + 80
    if MAT_DIELECTRIC in present:
        ops += 120
    return ops + 80 + 6 * B


def bounce_flops(spec):
    """f32 operations of one live ray's forward bounce: every leaf tested
    (world-sphere 45, world-box 60, local-frame 33 + the solid's)."""
    B = spec.bins
    ops = 40 + 2 * B
    ops += sum(45 if kind == 1 else 60 if kind == 2 else 33 + _PER_TYPE[t]
               for (t, _e, _m, kind) in spec.leaves)
    ops += 90
    return ops + _material_and_volume_ops(spec, B)


def bounce_bwd_flops(spec):
    """f32 operations of one live ray's adjoint bounce: the winner's side
    replayed (the mean leaf), then the reverse pass at about twice it, and
    the cotangent update of the spectral rows."""
    B = spec.bins
    L = len(spec.leaves)
    fwd = 40 + 2 * B + 33 + 90
    fwd += sum(_PER_TYPE[t] for (t, _e, _m, _k) in spec.leaves) // max(L, 1)
    fwd += _material_and_volume_ops(spec, B)
    return 3 * fwd + 8 * B


def table_floats(spec):
    """Floats of the flat table the bounce reads."""
    return (20 * len(spec.leaves) + len(spec.mat_types) * (10 + 2 * spec.bins)
            + 6 * spec.n_imp)


def state_floats(spec):
    """Floats of one ray's state: origin, direction, throughput, radiance,
    alive and depth."""
    return 3 + 3 + 2 * spec.bins + 2


class Work:
    """Bytes and f32 operations, summed over launches."""

    def __init__(self):
        self.bytes = 0.0
        self.ops = 0.0

    def span_fwd(self, spec, lanes, segments):
        """One forward span launch (K3) over ``lanes`` rays that traced
        ``segments`` segments."""
        self.bytes += F32 * (table_floats(spec) + 2 * lanes * state_floats(spec)
                             + N_UNIFORMS * segments)
        self.ops += segments * bounce_flops(spec)

    def span_bwd(self, spec, lanes, segments):
        """One adjoint span launch (K4): the table read and its cotangent
        written, the entry state and the cotangents in read, the
        cotangents out written, the segments' uniforms; the forward
        replayed and reversed for every segment."""
        B = spec.bins
        entry = 3 + 3 + B + 2
        cot_in = 3 + 3 + B + B
        cot_out = 3 + 3 + B
        self.bytes += F32 * (2 * table_floats(spec) + lanes * (
            entry + cot_in + cot_out) + N_UNIFORMS * segments)
        self.ops += segments * (bounce_flops(spec) + bounce_bwd_flops(spec))

    def least_s(self, peak):
        """The least time on a card of ``peak`` (bytes/s, f32 flop/s)."""
        return max(self.bytes / peak["hbm_bytes_per_s"],
                   self.ops / peak["f32_flops"])


def peak_of(kind):
    """The published peaks of the card named ``kind``, or None."""
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)["cards"].get(kind)
