"""``roofline_pct.k2v``: the least time the steps that the k2v family
(``lbbench/kernels/k2v.py``) advanced in the traced window need, the
larger of their operations over 67 TFLOP/s and their bytes over
3.35 TB/s, over the family's summed device time. Nothing where none of the
family's kernels ran."""

from lbbench.roofline import share


def read(ctx):
    return share(ctx, "k2v")
