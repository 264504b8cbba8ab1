"""``run_wait_ms``: the host milliseconds per interval that the port's
``run`` (the ``lb2d.run`` spans in the traced window) spends in its wait
spans (``lb2d.wait.<site>``: a synchronize, a device value read on the
host, a device tensor built from host lists). Nothing where the window
holds no ``lb2d.run`` span (a program without the port's spans)."""

from lbbench import spans


def read(ctx):
    tr = ctx.trace
    runs = spans.named(tr, "lb2d.run")
    if not runs or not ctx.intervals:
        return None
    waits = spans.intersect(spans.named(tr, "lb2d.wait."), runs)
    return spans.length(waits) / ctx.intervals * 1e-3
