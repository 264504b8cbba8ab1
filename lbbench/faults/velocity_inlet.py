"""Faults of ``velocity_inlet``: the inlet at rest, the obstacle ignored,
the outlet not copied. Each puts the float32 reference, its step broken,
in the program's place (``program(cell)``: each interval runs the
reference's M steps on the cell's state), so that ``harness.run_cell``
runs it as it runs the program, readouts included. Each has to fail one
of the numbers it names."""

import contextlib

import torch


@contextlib.contextmanager
def _step_with(ref, inlet_at_rest=False, obstacle=True, outlet=True):
    """``ref``'s step with the inlet's velocity 0 in place of u_w, without
    the obstacle's bounce-back and zeroed velocity, or without the outlet's
    copy (the east column keeps what streaming wrapped in from the west)."""
    def step(f, u, mask=None):
        f = ref._stream(f)
        ref._inlet(f, 0.0 if inlet_at_rest else u["u_w"])
        if outlet:
            ref._outlet(f)
        return ref._collide(f, u["omega"], mask if obstacle else None)

    original = ref.step
    ref.step = step
    try:
        yield
    finally:
        ref.step = original


def reference_in_place(dtype=torch.float32, **broken):
    """A ``program(cell)`` fault: each interval runs the reference's M steps
    in ``dtype`` on the cell's state, with its step broken as ``broken``
    says (``_step_with``'s keywords; none: the sound reference)."""
    def program(cell):
        from lbbench.reference import velocity_inlet as ref

        def run():
            f = cell.sim.state.to(dtype)
            with _step_with(ref, **broken):
                f = ref.advance(f, cell.mix, cell.steps_per_interval)
            cell.sim.state = f.to(torch.float32).contiguous()

        cell.run = run

    return program


FAULTS = {
    "inlet_at_rest": {
        "program": reference_in_place(inlet_at_rest=True),
        "fails": ["f_warm", "uv_win", "mon_win"]},
    "obstacle_ignored": {
        "program": reference_in_place(obstacle=False),
        "fails": ["f_warm", "uv_win", "mon_win"]},
    "outlet_not_copied": {
        "program": reference_in_place(outlet=False),
        "fails": ["f_warm", "rho_win", "uv_win"]},
}
