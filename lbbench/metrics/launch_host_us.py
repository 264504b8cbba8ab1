"""``launch_host_us``: the host microseconds inside the port's kernel
wrapper spans (``lb2d.launch.<wrapper>``: checks, plan, argument packing and
the C call) that start in the traced window, over the kernel launches the
trace shows the host making inside them. Nothing where the window holds
no such span (a program without them) or no launch inside one."""

from lbbench import spans


def read(ctx):
    tr = ctx.trace
    launch = spans.named(tr, "lb2d.launch.")
    issued = spans.count_inside(tr.launches, launch)
    if not issued:
        return None
    return spans.length(launch) / issued
