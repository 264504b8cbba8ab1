"""Faults planted in the timed path, to read at a cell's own size on the
card that the check fails them (``lbbench/calibrate.py --faults``).

A fault breaks either the program (``program(cell)``, given to
``harness.run_cell`` as its ``fault``) or the plain reference put in the
program's place (``reference(ref)``, a context in which the reference's
step is broken; ``check.control_outputs`` in float32 then stands for the
program). The CPU tests plant their own faults at a tiny size.
"""

import contextlib

import torch


def _k8_writes_nothing(cell):
    """K8 never writes the force planes that ``mc_step`` reads (they keep
    the runner's zeros)."""
    cell.sim._solve_screened = lambda rho, ext, plain: None


@contextlib.contextmanager
def _flow_step_with(ref, velocity):
    """``ref``'s flow step with the equilibrium's velocity replaced by
    ``velocity(ux, uy)``; the moments read out stay right."""
    def step(f, u, mask=None):
        f = ref._pressure_bcs(ref._stream(f), u["rho_in"], u["rho_out"])
        if mask is not None:
            f = torch.where(mask[None], f[list(ref.OPP)], f)
        rho, ux, uy = ref.moments(f)
        ux, uy = velocity(ux, uy)
        usq = ux * ux + uy * uy
        for j in range(9):
            cu = ref.CX[j] * ux + ref.CY[j] * uy
            feq = ref.W[j] * rho * (1.0 + cu / ref.CS2
                                    + cu * cu / (2 * ref.CS2 * ref.CS2)
                                    - usq / (2 * ref.CS2))
            f[j] += u["omega"] * (feq - f[j])
        return f

    original = ref.step
    ref.step = step
    try:
        yield
    finally:
        ref.step = original


FAULTS = {
    "k8_writes_nothing": {"config": "porous_two_fluid",
                          "program": _k8_writes_nothing},
    "feq_without_velocity": {
        "config": "pipe_flow",
        "reference": lambda ref: _flow_step_with(
            ref, lambda ux, uy: (torch.zeros_like(ux), torch.zeros_like(uy)))},
    "feq_velocity_swapped": {
        "config": "pipe_flow",
        "reference": lambda ref: _flow_step_with(ref, lambda ux, uy: (uy, ux))},
}
