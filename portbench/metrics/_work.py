"""The work counts the roofline readers share: the fused kernels'
launches of a traced window, from the cell's parameters and the port's
counters, on the reference's spec of the configuration."""

from __future__ import annotations

from portbench.reference import tables


def spec_of(r, general=False):
    spec = tables.compile_config(r["cell"].config)[1]
    return tables.general(spec) if general else spec


def forward(r):
    """Work of every forward span launch (K3) of the window."""
    w, c = r["work"].Work(), r["counts"]
    spec = spec_of(r)
    if "schedule" in c:
        n = c["tile_rays"]
        lanes = [n]
        for _steps, div in c["schedule"]:
            n = max(1, n // div)
            lanes.append(n)
        for k, n in enumerate(lanes):
            w.span_fwd(spec, n * c["tiles"] * c["passes"],
                       c["segments"] if k == 0 else 0)
            w.bytes += 4 * (c["tiles"] * c["passes"] - 1) * \
                r["work"].table_floats(spec)
    else:
        w.span_fwd(spec, c["lanes"] * c["calls"], c["segments"])
        w.bytes += 4 * (c["calls"] - 1) * r["work"].table_floats(spec)
    return w


def backward(r):
    """Work of every adjoint span launch (K4) of the window."""
    w, c = r["work"].Work(), r["counts"]
    spec = spec_of(r, general=True)
    w.span_bwd(spec, c["lanes"] * c["calls"], c["segments"])
    w.bytes += 4 * 2 * (c["calls"] - 1) * r["work"].table_floats(spec)
    return w


def share(least_s, device_s):
    """A share of the roofline in %, or None where nothing ran."""
    if least_s is None or not device_s:
        return None
    return 100.0 * least_s / device_s
