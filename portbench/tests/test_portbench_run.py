"""Whole runs of each cell on the CPU at a small size, past the harness's
look for a card: a sound run is correct; the control (the port's bfloat16
spectral state) and each fault planted under the timed path are not.

The faults a cell can have: a step that returns its state unchanged, half
of the batch left out (the mean taken over the rest), and an answer altered
where it is produced. The cells run on one card, so none has an exchange
between cards to leave out.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from portbench import harness
from portbench.run import Context, execute, make_traffic

from conftest import SMALL

# every workload file, also one the manifest does not list yet
CELLS = sorted(SMALL)


def _run(cell, precision=None, fault=None, seed=2 ** 31 + 11):
    ctx = Context(cell, seed, device="cpu", precision=precision,
                  overrides=SMALL[cell])
    cls = type(make_traffic(ctx))
    step = cls.step
    if fault is not None:
        def broken(self, i):
            with fault():
                step(self, i)
        cls.step = broken
    try:
        result, rows = execute(ctx, 0.05, 1, harness.manifest(),
                               harness.build_snapshot())
    finally:
        cls.step = step
    return result, {n: v for n, v, _l in rows}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, compared = _run(cell)
    assert result["correct"], compared
    assert result["attempted"] >= 1
    bench = harness.manifest()
    if cell in {w["name"] for w in bench["workloads"]}:
        e2e, _layer = harness.cell_metrics(bench, cell)
        assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result, compared = _run(cell, precision="bfloat16")
    assert not result["correct"], compared


@contextlib.contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def _unchanged(cell):
    """The trace hands back the state it was given (no radiance)."""
    from source_tpu_torch.optical.observer import pipelines
    from source_tpu_torch.parallel import engine
    if cell.endswith(".observe"):
        return lambda: _patched(pipelines.RGBPipeline2D, "update",
                                lambda old: lambda self, *a: None)
    if cell.endswith(".fit"):
        def make(old):
            def tracer(scene, cfg, state, *a, **kw):
                keep = scene.leaf_w2l.sum() * 0.0
                state.radiance = state.radiance + keep
                return state
            return tracer
        return lambda: _patched(engine, "trace_rays_diff", make)
    return lambda: _patched(engine, "trace_rays",
                            lambda old: lambda scene, cfg, state, *a, **kw:
                            state)


def _half(cell):
    """Half of the batch left out: the loss's mean over the first half of
    the rays; half of the rays (render) or tiles (observe) not traced."""
    from source_tpu_torch.optical.observer import base
    from source_tpu_torch.parallel import engine
    if cell.endswith(".fit"):
        return lambda: _patched(
            torch, "mean",
            lambda old: lambda x, *a, **kw: old(x[: x.shape[0] // 2], *a,
                                                **kw))
    if cell.endswith(".observe"):
        def make(old):
            def tiles(self, tasks, *a, **kw):
                return old(self, tasks[: tasks.shape[0] // 2], *a, **kw)
            return tiles
        return lambda: _patched(base.ObserverBase, "_observe_tiles", make)

    def make(old):
        def tracer(scene, cfg, state, *a, **kw):
            out = old(scene, cfg, state, *a, **kw)
            out.radiance[out.radiance.shape[0] // 2:] = 0.0
            return out
        return tracer
    return lambda: _patched(engine, "trace_rays", make)


def _altered(cell):
    """Every ray's radiance off by one part in a thousand where the trace
    produces it."""
    from source_tpu_torch.optical.observer import base
    from source_tpu_torch.parallel import engine
    owner, name = ((base, "trace_rays") if cell.endswith(".observe")
                   else (engine, "render_batch"))

    def make(old):
        def traced(*a, **kw):
            out = old(*a, **kw)
            out.radiance = out.radiance * 1.001
            return out
        return traced
    return lambda: _patched(owner, name, make)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_caught(cell, fault):
    result, compared = _run(cell, fault=fault(cell))
    assert not result["correct"], compared


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    ctx = Context(cell, 2 ** 31 + 5, device=card)
    result, compared = execute(ctx, 5.0, 1, harness.manifest(),
                               harness.build_snapshot())
    assert result["correct"], compared
