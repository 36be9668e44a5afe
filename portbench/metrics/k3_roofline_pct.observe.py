"""K3's share of its roofline in the observe cells: the least time of the
work that every span launch of the window needs (``metrics/_work.py``)
over K3's summed device time by name (``k_span_fwd``) in the trace.
"""

from __future__ import annotations

from portbench.metrics import _work


def read(r):
    if r["peak"] is None:
        return None
    least = _work.forward(r).least_s(r["peak"])
    return _work.share(least, r["trace"].device_s("k_span_fwd"))
