"""The share of the traced window in which the card ran no kernel, copy or
memset, from the profiler's device timeline.
"""

from __future__ import annotations


def read(r):
    t = r["trace"]
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
