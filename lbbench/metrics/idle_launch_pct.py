"""``idle_launch_pct``: the share of the traced window in which neither a
kernel nor a copy runs on the card and the host is inside one of the
port's kernel wrapper spans (``lb2d.launch.<wrapper>``). Nothing where the
window holds no such span (a program without them) or no kernel ran."""

from lbbench import spans


def read(ctx):
    return spans.idle_share(ctx, "lb2d.launch.")
