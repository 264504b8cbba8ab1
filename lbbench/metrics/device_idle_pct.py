"""``device_idle_pct``: the share of the traced window in which neither a
kernel nor a copy ran on the card (``torch.profiler``'s device activity)."""


def read(ctx):
    if ctx.trace.window is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
