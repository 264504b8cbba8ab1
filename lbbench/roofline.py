"""A kernel family's share of its roofline (``roofline_pct.<family>``)."""

from lbbench import peaks


def share(ctx, family):
    """100 times the least time of the window's steps that ``family``
    advanced (the cell's configuration gives their work, ``ctx.work``),
    over the family's device time; None where the configuration gives no
    work for the family or none of its kernels ran."""
    work = ctx.work.get(family)
    seconds = ctx.family_seconds(family)
    if work is None or seconds <= 0:
        return None
    per = {"interval": ctx.intervals, "step": ctx.steps}[work.per]
    return 100.0 * peaks.least_seconds(
        work.ops * ctx.cells * ctx.steps,
        work.bytes * ctx.cells * per) / seconds
