"""Host milliseconds a pass spends in the RGB pipeline's fold (``update``,
the Welford merge after the pull), from the benchmark's span
"observe.fold" around each call.
"""

from __future__ import annotations


def read(r):
    span = r["trace"].span_s("observe.fold")
    passes = r["counts"]["passes"]
    return 1e3 * span / passes if passes and r["trace"].span_count("observe.fold") else None
