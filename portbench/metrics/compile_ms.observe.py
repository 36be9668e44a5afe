"""Host milliseconds a pass spends in ``compile_scene``, which ``observe()``
calls for each spectral slice of every pass, from the benchmark's span
"observe.compile_scene".
"""

from __future__ import annotations


def read(r):
    span = r["trace"].span_s("observe.compile_scene")
    passes = r["counts"]["passes"]
    return 1e3 * span / passes if passes and r["trace"].span_count("observe.compile_scene") else None
