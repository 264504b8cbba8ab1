"""``launches_per_step``: the kernels that ran on the card in the traced
window, per simulated step (the step's own and the readouts')."""


def read(ctx):
    kernels = ctx.trace.inside(ctx.trace.kernels)
    if not kernels or not ctx.steps:
        return None
    return len(kernels) / ctx.steps
