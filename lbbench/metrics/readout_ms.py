"""``readout_ms``: the mean over the window's intervals, on the device
timeline, from the end of the interval's last step kernel (a kernel of a
family in ``lbbench/kernels``) to the end of its last device-to-host copy.
An interval starts at the first step kernel after a device-to-host copy."""


def _to_host(name):
    return "DtoH" in name or "Device -> P" in name


def read(ctx):
    tr = ctx.trace
    events = sorted(tr.inside(tr.kernels) + tr.inside(tr.copies),
                    key=lambda e: e[1])
    gaps, last_step, last_copy = [], None, None
    for name, t0, t1 in events:
        if not _to_host(name) and ctx.step_kernel(name):
            if last_copy is not None and last_step is not None:
                gaps.append(last_copy - last_step)
                last_copy = None
            last_step = t1
        elif _to_host(name) and last_step is not None:
            last_copy = t1
    if last_copy is not None and last_step is not None:
        gaps.append(last_copy - last_step)
    if not gaps:
        return None
    return sum(gaps) / len(gaps) * 1e-3
