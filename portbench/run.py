"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
(``workloads/<cell>.json``) names its configuration (``configs/``), its
traffic kind (``traffic/<kind>.py``) and that traffic's parameters. The run
builds the system under test from the seed, warms up every shape it will
use (set-up, ``setup_s``: from the process's start to the first timed
call), measures ``--seconds`` of back-to-back calls, reads the peak device
memory, frees the program's state and compares what the window produced
with the plain reference (``reference/``). With ``--trace 0`` the result
holds the cell's end-to-end metrics; with ``--trace 1`` the window runs
under the profiler with the benchmark's spans and the result holds the
cell's per-layer metrics (``metrics/<name>.py``), the device's busy time
and a breakdown. The last line of standard output is the result, as JSON;
each number compared is printed beside its limit as the last lines of
standard error and as the result's last key. Without enough CUDA cards, or
without the program in the checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


class Context:
    """What a kind of traffic is given: the cell, its configuration and parameters,
    the seed, the device, whether the window is traced, the precision the
    program runs in (the configuration's, or a control's) and the limits
    of the comparison."""

    def __init__(self, cell, seed, device="cuda", trace=False,
                 precision=None, overrides=None):
        self.cell = cell
        self.workload = harness.load_json("workloads", f"{cell}.json")
        self.config = harness.load_json(
            "configs", f"{self.workload['config']}.json")
        self.params = dict(self.workload["params"], **(overrides or {}))
        self.limits = self.workload["limits"]
        self.seed = int(seed)
        self.device = device
        self.trace = bool(trace)
        self.precision = precision or self.config["precision"]


def make_traffic(ctx):
    return harness.load_module("traffic", ctx.workload["traffic"]).TRAFFIC(ctx)


def check_lines(rows):
    """Each number compared beside its limit, and whether all hold."""
    ok = all(v <= lim for _n, v, lim in rows)
    return ok, {n: {"value": v, "limit": lim} for n, v, lim in rows}


def run(args):
    harness.set_cache_dirs()
    import torch

    bench = harness.manifest()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    before = harness.build_snapshot()
    import source_tpu_torch
    where = Path(source_tpu_torch.__file__).resolve()
    if harness.ROOT not in where.parents:
        print(f"the program was found outside the checkout: {where}",
              file=sys.stderr)
        return 2

    ctx = Context(args.workload, args.seed, trace=bool(args.trace))
    result, rows = execute(ctx, args.seconds, cell["chips"], bench, before)
    if result is None:
        return 3
    for name, v, lim in rows:
        print(f"compared {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def execute(ctx, seconds, chips, bench, before):
    """Set-up, the window, the metrics and the check of one run: (result,
    compared rows), or (None, rows) where a forbidden module was loaded."""
    import torch

    from portbench import tracing

    cuda = torch.device(ctx.device).type == "cuda"
    traffic = make_traffic(ctx)
    traffic.setup()
    setup_s = harness.process_age_s()
    built = harness.built_since(before)
    print(f"kernel libraries built during set-up: {built or 'none'} "
          f"(source_tpu_torch/_build/ mtimes before and after)",
          file=sys.stderr)

    seconds = min(seconds, harness.TRACE_SECONDS) if ctx.trace else seconds
    targets = traffic.spans() if ctx.trace else []
    with tracing.profiled(torch, ctx.trace, [t[2] for t in targets]) as prof:
        with tracing.Spans(targets):
            if ctx.trace:
                from torch.profiler import record_function
                with record_function("window"):
                    calls, secs, times = harness.measure(
                        seconds, traffic.step, traffic.finish)
            else:
                calls, secs, times = harness.measure(seconds, traffic.step,
                                                     traffic.finish)
    e2e = traffic.e2e(calls, secs, times)
    q = sorted(times)
    print(f"window: {calls} calls in {secs:.3f} s; host ms a call min "
          f"{1e3 * q[0]:.3f}, median {1e3 * q[len(q) // 2]:.3f}, max "
          f"{1e3 * q[-1]:.3f}", file=sys.stderr)
    device = (harness.device_info(torch, chips) if cuda else
              {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0})
    if harness.forbidden_modules():
        print(f"modules that no run may load were loaded: "
              f"{harness.forbidden_modules()}", file=sys.stderr)
        return None, []
    e2e_defs, layer_defs = harness.cell_metrics(bench, ctx.cell)
    metrics = {}
    breakdown = None
    if ctx.trace:
        from portbench.roofline import work
        trace = prof.trace
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        read = dict(trace=trace, counts=traffic.counts(), cell=ctx,
                    peak=work.peak_of(device["kind"]), work=work)
        for m in layer_defs:
            value = harness.load_module("metrics", m["name"]).read(read)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": trace.top_device_ops(),
                     "idle_gaps": trace.idle_gaps(
                         prefix=ctx.workload["traffic"] + ".")}
    else:
        for m in e2e_defs:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    traffic.release()
    if cuda:
        torch.cuda.empty_cache()
    rows = traffic.check()
    ok, compared = check_lines(rows)
    if harness.forbidden_modules():
        print(f"modules that no run may load were loaded: "
              f"{harness.forbidden_modules()}", file=sys.stderr)
        return None, rows
    result = {"correct": ok, "attempted": calls, "failed": 0,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if cuda:
        result["power_limit"] = harness.power_limit()
    result["compared"] = compared
    return result, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
