"""The port's own spans in a traced window (``lb2d_tpu_torch.utils.
tracing``: ``lb2d.run``, ``lb2d.launch.<wrapper>``, ``lb2d.readout.<what>``,
``lb2d.wait.<site>``, ...), as sorted disjoint ``(start, end)`` intervals in
microseconds of the trace's clock, and the measures the span metrics take
of them. A trace of a program without these spans has none."""

import bisect


def named(trace, prefix: str) -> list:
    """The union of the spans whose name starts with ``prefix`` and that
    start inside the window, cut to the window."""
    if trace.window is None:
        return []
    lo, hi = trace.window
    return union((t0, min(t1, hi)) for name, spans in trace.spans.items()
                 if name.startswith(prefix)
                 for t0, t1 in spans if lo <= t0 <= hi)


def union(intervals) -> list:
    """Sorted disjoint ``(start, end)`` covering ``intervals``."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def length(intervals) -> float:
    return sum(t1 - t0 for t0, t1 in intervals)


def intersect(a, b) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        t0, t1 = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t0 < t1:
            out.append((t0, t1))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(trace) -> list:
    """The window less its kernel and copy intervals (``busy_intervals``)."""
    lo, hi = trace.window
    out, t = [], lo
    for t0, t1 in trace.busy_intervals():
        if t0 > t:
            out.append((t, t0))
        t = max(t, t1)
    if hi > t:
        out.append((t, hi))
    return out


def count_inside(times, intervals) -> int:
    """How many of the sorted ``times`` fall inside ``intervals``."""
    return sum(bisect.bisect_right(times, t1) - bisect.bisect_left(times, t0)
               for t0, t1 in intervals)


def idle_share(ctx, prefix: str):
    """100 times the share of the window in which neither a kernel nor a
    copy runs and the host is inside a span named ``prefix...``; None
    where the window holds no such span or no kernel ran."""
    tr = ctx.trace
    spans = named(tr, prefix)
    if not spans or not tr.inside(tr.kernels):
        return None
    lo, hi = tr.window
    return 100.0 * length(intersect(idle(tr), spans)) / (hi - lo)
