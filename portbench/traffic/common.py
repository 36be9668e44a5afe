"""Helpers the kinds of traffic share: the cell's inputs made from the
seed, the streams of uniforms handed to both sides, and the comparisons."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import mix_seed

N_UNIFORMS = 10


def grid_rays(p, device):
    """A pinhole grid of rays through the pixel centres (the repository's
    flagship batch): ``width`` x ``height`` directions (x, y) * ``spread``
    + (0, 0, 1) normalised, all from ``position``; f32 [N, 3] each."""
    w, h = int(p["width"]), int(p["height"])
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w - 0.5
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h - 0.5
    px, py = np.meshgrid(xs, ys, indexing="ij")
    s = np.float32(p["spread"])
    d = np.stack([px.ravel() * s, py.ravel() * s,
                  np.ones(w * h, np.float32)], axis=-1).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(p["position"], np.float32), d.shape)
    return (torch.as_tensor(np.ascontiguousarray(o)).to(device),
            torch.as_tensor(d.astype(np.float32)).to(device))


class Streams:
    """Uniforms keyed by a tuple of whole numbers: the same key, the same
    draw, on any run. One generator on the device, seeded a draw."""

    def __init__(self, seed, device):
        self.seed = int(seed)
        self.device = device
        self.gen = torch.Generator(device=device)

    def rand(self, shape, *key):
        self.gen.manual_seed(mix_seed(self.seed, *key))
        return torch.rand(shape, generator=self.gen, dtype=torch.float32,
                          device=self.device)

    def bounce_u(self, *key):
        """``u_all(start, n_steps, n_lanes)`` of the call keyed ``key``."""
        def u_all(start, n_steps, n_lanes):
            return self.rand((n_steps, n_lanes, N_UNIFORMS), *key, start)
        return u_all


def sampled(seed, count, below, salt):
    """``count`` distinct indices in [1, below) drawn from the seed, after
    index 0, which is always checked (the start)."""
    rng = np.random.default_rng(mix_seed(seed, salt))
    pick = rng.choice(np.arange(1, below), size=min(count, below - 1),
                      replace=False)
    return [0] + sorted(int(x) for x in pick)


# an element is off where it differs from the reference by more than this
# share of itself plus this share of the mean reference element: float32
# rounding of one evaluation order against another stays far below it, a
# bfloat16 rounding (a relative step of 2**-9) far above it. The mean, not
# the largest element, scales the floor: a frame's few emitter pixels are
# thousands of times brighter than its others
RTOL, ATOL_OF_MEAN = 1e-5, 1e-6


def off_pct(got, ref):
    """The percentage of rows (rays, pixels) of [rows, k] arrays that hold
    an element off the reference."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    tol = RTOL * np.abs(ref) + ATOL_OF_MEAN * float(np.abs(ref).mean())
    off = (np.abs(got - ref) > tol).reshape(ref.shape[0], -1).any(axis=1)
    return 100.0 * float(off.mean())


def worst_field_gap(got, ref):
    """The worst table field's gap: ||got - ref|| over the larger of the
    reference field's norm and the median field norm, so that a field
    whose reference gradient is all but zero is judged on the common
    scale."""
    norms = {f: float(torch.linalg.vector_norm(ref[f].double()))
             for f in ref}
    med = float(np.median(list(norms.values())))
    gaps = {}
    for f in ref:
        diff = float(torch.linalg.vector_norm(
            got[f].double().cpu() - ref[f].double().cpu()))
        scale = max(norms[f], med)
        gaps[f] = diff / scale if scale > 0 else (0.0 if diff == 0 else
                                                  math.inf)
    return max(gaps.values())


class Traffic:
    """One kind of traffic. ``setup`` builds the system under test from
    the cell and warms every shape it will use; ``step(i)`` is one call of
    the window; ``finish`` waits for the device; ``e2e`` gives the
    end-to-end metrics; ``spans`` the benchmark-side spans of a traced
    run; ``counts`` what the per-layer readers need; ``release`` frees the
    program's state; ``check`` compares what the window produced with the
    plain reference: a list of (name, value, limit)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.dev = torch.device(ctx.device)
        self.streams = Streams(ctx.seed, self.dev)
        self.kept = {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def finish(self):
        self.sync()

    def spans(self):
        return []

    def counts(self):
        return {}

    def release(self):
        pass
