"""The traced run: benchmark-side spans around the program's layers, the
profiler over the window, and the reduction of its trace.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
puts around calls into the port, by wrapping a module attribute for the
length of the traced window only; the untraced runs call the port as it
is. The trace gives the device timeline (every kernel, copy and memset)
and the host's spans and operations, from which ``Trace`` works out the
busy time, each kernel's device time by name, each span's host time, the
top device operations and the idle gaps labelled by what the host was
doing.
"""

from __future__ import annotations

import contextlib
import functools


class Spans:
    """Wraps ``(owner, attribute, span name)`` triples in record_function
    ranges while open; restores the attributes on close."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for owner, attr, name in self.targets:
            fn = getattr(owner, attr)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                with record_function(_name):
                    return _fn(*a, **kw)

            functools.update_wrapper(wrapped, fn)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []


@contextlib.contextmanager
def profiled(torch, enabled, annotations=()):
    """The profiler over CPU and CUDA while ``enabled``; yields a holder
    whose ``trace`` is set on exit. ``annotations`` are the names of the
    benchmark's spans, whose copies on the device timeline are no device
    work."""
    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder.trace = Trace.of(prof, set(annotations) | {"window"})


def _union_s(intervals):
    """Total length in seconds of the union of (start_ns, end_ns)."""
    total = 0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-9


class Trace:
    """The reduced trace of one window: device intervals by name, host
    events (spans and operations) on the main thread, and the window."""

    def __init__(self, device, host, window):
        self.device = device      # [(name, start_ns, end_ns)]
        self.host = host          # [(name, start_ns, end_ns)]
        self.window = window      # (start_ns, end_ns) of the span "window"

    @classmethod
    def of(cls, prof, annotations=frozenset({"window"})):
        try:
            events = prof.profiler.kineto_results.events()
            rows = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     str(e.device_type()).endswith("CUDA"),
                     e.start_thread_id(), _annotation(e)) for e in events]
        except AttributeError:
            rows = [(e.name, int(e.time_range.start * 1000),
                     int(e.time_range.end * 1000),
                     str(e.device_type).endswith("CUDA"), e.thread, False)
                    for e in prof.events()]
        # a record_function range is mirrored on the device timeline as a
        # user annotation: it is no device work
        device = [(n, a, b) for (n, a, b, dev, _t, ann) in rows
                  if dev and b > a and not ann and n not in annotations]
        rows = [r[:5] for r in rows]
        host_rows = [(n, a, b, t) for (n, a, b, dev, t) in rows if not dev]
        window = next(((a, b) for (n, a, b, _t) in host_rows
                       if n == "window"), None)
        main = next((t for (n, a, b, t) in host_rows if n == "window"), None)
        host = [(n, a, b) for (n, a, b, t) in host_rows if t == main]
        if window is None:
            starts = [a for _n, a, _b in device] or [0]
            ends = [b for _n, _a, b in device] or [0]
            window = (min(starts), max(ends))
        return cls(device, host, window)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self, intervals):
        lo, hi = self.window
        return [(max(a, lo), min(b, hi)) for a, b in intervals
                if b > lo and a < hi]

    @property
    def busy_s(self):
        """Seconds of the window in which the device ran any operation."""
        return _union_s(self._clipped([(a, b) for _n, a, b in self.device]))

    def device_s(self, substring):
        """Summed device seconds of the operations whose name holds
        ``substring``, inside the window."""
        return sum(b - a for n, a, b in self.device if substring in n
                   and a >= self.window[0] and b <= self.window[1]) * 1e-9

    def span_s(self, name):
        """Summed host seconds of the spans called ``name``."""
        return sum(b - a for n, a, b in self.host if n == name) * 1e-9

    def span_count(self, name):
        return sum(1 for n, _a, _b in self.host if n == name)

    def top_device_ops(self, k=10):
        per = {}
        for n, a, b in self.device:
            if a >= self.window[0] and b <= self.window[1]:
                per[_short(n)] = per.get(_short(n), 0) + (b - a) * 1e-9
        return sorted(([n, s] for n, s in per.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k=10, prefix=None):
        """Idle time of the device summed by what the host was doing at
        each gap's middle: the innermost benchmark span there (names that
        start with ``prefix``) and the innermost operation inside it; the
        largest ``k``."""
        busy = sorted(self._clipped([(a, b) for _n, a, b in self.device]))
        gaps = []
        end = self.window[0]
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        host = sorted(self.host, key=lambda r: r[1])
        starts = [a for _n, a, _b in host]
        import bisect
        per = {}
        for a, b in gaps:
            mid = (a + b) // 2
            label = "(no host span)"
            best = None
            i = bisect.bisect_right(starts, mid)
            # events sorted by start: walking back from ``mid``, the first
            # one still open is the innermost; go on to the innermost span
            for j in range(i - 1, max(-1, i - 4000), -1):
                n, s, e = host[j]
                if e < mid or n == "window":
                    continue
                if best is None:
                    best = n
                if prefix is None or n.startswith(prefix):
                    label = n if n == best else f"{n} > {best}"
                    break
            else:
                if best is not None:
                    label = best
            per[label] = per.get(label, 0.0) + (b - a) * 1e-9
        return sorted(([n, s] for n, s in per.items()),
                      key=lambda r: -r[1])[:k]


def _annotation(e):
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


def _short(name):
    """A kernel's name without its argument list and return type."""
    n = name.replace("(anonymous namespace)", "{anon}").split("(", 1)[0]
    if n.startswith("void "):
        n = n[5:]
    return n[:120]
