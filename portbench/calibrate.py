"""Readings for the limits of a cell's comparison, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds 4 \
        --seeds 11,12,... --control-seeds 21,22,23

For each of ``--seeds`` it drives the cell's traffic at its own load for a
short window, as a run does, and reads each number the check compares
(sound runs: the lower readings). For each of ``--control-seeds`` it does
the same with the control: the program with its path of the nearest
lower precision switched on (the port's bfloat16 spectral state, below the
configuration's float32), whose readings have to fail (the upper
readings). One JSON line a run on standard output. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.run import Context, execute  # noqa: E402

# the port's own path of the nearest precision below the configurations'
# float32: its bfloat16 spectral state
CONTROL = "bfloat16"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.manifest()
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + [
        (int(s), CONTROL) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t = time.time()
        ctx = Context(args.workload, seed, precision=control)
        result, rows = execute(ctx, args.seconds, 1, bench,
                               harness.build_snapshot())
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "run": "control" if control else "sound",
            "precision": ctx.precision, "wall_s": time.time() - t,
            "compared": {n: v for n, v, _lim in rows},
            "correct": None if result is None else result["correct"]}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
