"""Each cell at a size a CPU test run holds: the same configuration and
traffic with a smaller grid and fewer steps per interval."""

import math

from lbbench import harness

TINY = {
    "pipe_flow.open_4096": {
        "physical": {"diameter": 1.0, "rho": 1.0, "viscosity": 0.1,
                     "pressure_grad": -0.01, "pipe_length": 1.0, "N": 31},
        "steps_per_interval": 8},
    "pipe_flow.cylinder_n125": {
        "physical": {"diameter": 1.0, "rho": 1.0, "viscosity": 1.0,
                     "pressure_grad": -10.0, "pipe_length": 3.0, "N": 10},
        "steps_per_interval": 8},
    "pipe_flow.poiseuille_32x256": {"steps_per_interval": 20},
    "porous_two_fluid.8192": {"grid": [24, 32], "steps_per_interval": 3},
}
SEED = 2**31 + 4321   # more than 32 signed bits hold


# numbers that only the card's path gives: the runner's eager step on the
# CPU solves the screened-Poisson force inside the step and holds no planes
CARD_ONLY = {"force_win"}


def limits(workload, card_only=False):
    """The cell's limits, without ``CARD_ONLY``'s unless ``card_only``."""
    lim = harness.load_limits(workload)
    return lim if card_only else {k: v for k, v in lim.items()
                                  if k not in CARD_ONLY}


def run(workload, seed=SEED, seconds=0.0, trace=False, fault=None,
        card_only=False):
    return harness.run_cell(workload, seed, seconds, trace=trace,
                            device="cpu", mix_override=TINY[workload],
                            fault=fault, limits=limits(workload, card_only))


def mix(workload):
    spec = harness.cell_spec(workload)
    return dict(harness.load_mix(spec["traffic"]), **TINY[workload])


def failing(checks):
    """The names of the numbers over their limits."""
    return sorted(k for k, c in checks.items()
                  if not (math.isfinite(c["value"]) and c["value"] <= c["limit"]))
