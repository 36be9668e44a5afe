"""K3's share of its roofline in the render cell, counted as in
``k3_roofline_pct.observe``: one whole-span launch a call.
"""

from __future__ import annotations

from portbench.metrics import _work


def read(r):
    if r["peak"] is None:
        return None
    least = _work.forward(r).least_s(r["peak"])
    return _work.share(least, r["trace"].device_s("k_span_fwd"))
