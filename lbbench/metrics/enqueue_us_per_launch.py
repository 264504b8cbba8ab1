"""``enqueue_us_per_launch``: host microseconds inside the benchmark's
``run()`` spans per kernel launch they issued. The launches issued inside
``run()`` are the window's kernels less the launches the trace shows the
host making outside those spans (the readouts'), so that launches the
trace's host side does not show are still counted."""

from lbbench.trace import RUN


def read(ctx):
    tr = ctx.trace
    runs = tr.spans.get(RUN, [])
    kernels = tr.inside(tr.kernels)
    if not runs or not kernels:
        return None
    lo, hi = tr.window
    runs = sorted(runs)
    outside, k = 0, 0
    for t in tr.launches:
        if not lo <= t <= hi:
            continue
        while k < len(runs) and runs[k][1] < t:
            k += 1
        if not (k < len(runs) and runs[k][0] <= t):
            outside += 1
    issued = len(kernels) - outside
    if issued <= 0:
        return None
    return sum(t1 - t0 for t0, t1 in runs) / issued
