"""What every run of the benchmark shares: the checkout's paths and caches,
set-up accounting, the import guard, seeds, the measured window, the
profiler's trace and the result line.

A run is ``run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``. The cell's file (``workloads/<cell>.json``) names its
configuration and its traffic kind; the traffic module
(``traffic/<kind>.py``) builds the system under test, warms it up, runs one
unit of work a call and checks what the window produced against the plain
reference (``reference/``). The readers of the per-layer metrics
(``metrics/<name>.py``) take their numbers from the traced window.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "source_tpu_torch" / "_build"
CACHE = HERE / "_cache"
# the longest window a traced run profiles: the reduction of a longer trace
# would take most of a run's time limit
TRACE_SECONDS = 8.0
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "source_tpu")


def process_age_s():
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    CACHE.mkdir(exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def build_snapshot():
    """{library file: mtime} of the program's kernel build directory."""
    if not BUILD.is_dir():
        return {}
    return {p.name: p.stat().st_mtime for p in BUILD.iterdir()
            if p.is_file()}


def built_since(before):
    """Library files made or rewritten since ``before``."""
    after = build_snapshot()
    return sorted(k for k, v in after.items() if before.get(k) != v)


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``<kind>/<name>.py`` under the benchmark as a module, loaded once a
    process (a name may hold dots, so the file is loaded by its path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    key = f"portbench_{kind}_{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def manifest():
    return load_json("..", "BENCHMARK.json")


def cell_metrics(bench, cell):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    def reports(m):
        return cell in m.get("workloads", [cell])
    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in names and reports(m)]
    return e2e, layer


_MASK64 = (1 << 64) - 1


def mix_seed(*parts):
    """A 63-bit seed of a tuple of whole numbers (splitmix64 chain), for
    ``torch.Generator.manual_seed``: the same parts, the same stream."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def measure(seconds, step, finish):
    """The measured window: calls ``step(i)`` back to back until
    ``seconds`` have passed since the first call began, then ``finish()``
    (a synchronise). Returns (calls, seconds from the first call's start
    to the end of ``finish``, per-call host seconds)."""
    times = []
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        step(i)
        times.append(time.perf_counter() - a)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    finish()
    return i, time.perf_counter() - t0, times


def device_info(torch, count):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count),
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
