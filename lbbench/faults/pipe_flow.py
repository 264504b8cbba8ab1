"""Faults of ``pipe_flow``: the flow equilibrium without its velocity, or
with u and v swapped, in the float32 reference put in the program's place.
Each has to fail the snapshot's velocities or the monitoring readout."""

import contextlib

import torch


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
    "feq_without_velocity": {
        "reference": lambda ref: _flow_step_with(
            ref, lambda ux, uy: (torch.zeros_like(ux), torch.zeros_like(uy))),
        "fails": ["uv_win", "mon_win"]},
    "feq_velocity_swapped": {
        "reference": lambda ref: _flow_step_with(ref, lambda ux, uy: (uy, ux)),
        "fails": ["uv_win", "mon_win"]},
}
