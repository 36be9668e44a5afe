"""K4's share of its roofline in the fit cell: the least time of the work of
every adjoint span launch of the window (the forward replayed and
reversed, ``metrics/_work.py``) over K4's summed device time by name
(``k_span_bwd``).
"""

from __future__ import annotations

from portbench.metrics import _work


def read(r):
    if r["peak"] is None:
        return None
    least = _work.backward(r).least_s(r["peak"])
    return _work.share(least, r["trace"].device_s("k_span_bwd"))
