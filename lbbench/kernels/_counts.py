"""The work a simulated step needs, counted from the algorithm and not
from any kernel, so that the count is the same whatever kernel, or how
many steps a launch, implements the steps.

Operations: each add, subtract and multiply counts one (a fused
multiply-add two, as the card's peak counts it); a division, square root
or transcendental counts one. Where two formulas share a term (the
opposite directions of a pair share ``(c.u)^2``; the two fluids share the
barycentric velocity) it is counted once, and cells on the edges (the
Zou-He and wall formulas) are left out: the counts are lower bounds.

Bytes: the state read once and written once, per interval where nothing
couples every cell to every other within a step (flow: a kernel may keep
cells on chip for all the steps of an interval), and per step where a step
does (the screened-Poisson solve needs every density of a step before any
cell takes the next step).
"""

import math
from typing import NamedTuple

FLOAT = 4


class Work(NamedTuple):
    """What the steps of one kernel family need: ``ops`` operations a
    cell-step, and ``bytes`` a cell once each ``per`` (``"interval"`` or
    ``"step"``). A configuration gives one for each family that advances
    its steps (``configs/<config>.py``'s ``work``)."""
    ops: float
    bytes: float
    per: str

# D2Q9 BGK with the quadratic equilibrium, one cell-step:
#   density 8 adds; momentum 5 + 5; velocity 2 divisions;
#   equilibrium: u^2, v^2, their sum 3; 1.5 |u|^2 1; the diagonals' u + v,
#   u - v 2; per opposite pair A = 1 + 4.5 (c.u)^2 - 1.5 |u|^2 (4 with the
#   square), B = 3 c.u (1), A + B and A - B (2): 7 x 4 pairs; the rest
#   direction's 1 - 1.5 |u|^2 1; w rho for the three weights 3 and times
#   the nine brackets 9;
#   BGK f + omega (feq - f) 3 x 9.
FLOW_OPS = 8 + 10 + 2 + (3 + 1 + 2 + 7 * 4 + 1 + 3 + 9) + 3 * 9
FLOW_STATE_BYTES = 9 * FLOAT      # the populations of one cell
MASK_BYTES = 1                    # an obstacle flag a cell, where there is one


def flow_work(obstacle: bool) -> Work:
    """Flow steps: the populations read and written once, and the obstacle
    flag read once, per interval."""
    return Work(FLOW_OPS, 2 * FLOW_STATE_BYTES + (MASK_BYTES if obstacle
                                                  else 0), "interval")


# The porous two-fluid Shan-Chen step of BASELINE config 5 (2 fluids, D2Q9,
# first-belt interaction with the shan_chen pseudopotential, Darcy and
# Forchheimer drag, porosity equilibrium with Guo forcing), one cell-step,
# the screened-Poisson solve apart (K8):
#   per fluid density and momentum 18, velocity 2 divisions: 2 x 20;
#   psi = rho0 (1 - exp(-rho / rho0)) 3 a fluid: 6;
#   the neighbour sums of the other fluid's psi, 7 a component: 2 x 14;
#   -G psi times the sums 3, over rho 2 divisions: 2 x 5;
#   the held screened force added 2;
#   drag |u| 4, eps G - a u - b |u| u 6 + 5: 2 x 15;
#   barycentric velocity 1 + 6 + 6 + 2 divisions 15;
#   shared by the fluids: |u|^2 3, diagonals 2, (c.u)^2 4, 3 c.u 4: 13;
#   per fluid: equilibrium 30 (its constant 2, per pair 4 x 4, w rho 3,
#   times the brackets 9), Guo 42 (c.F 2, u.F 3, u.F term 1, per pair 6 x 4,
#   the weights 3 + 9), f + omega (feq - f) + F 4 x 9: 2 x 108.
MC_OPS = 2 * 20 + 6 + 2 * 14 + 2 * 5 + 2 + 2 * 15 + 15 + 13 + 2 * 108
MC_FLUIDS = 2
MC_STATE_BYTES = 9 * MC_FLUIDS * FLOAT


def screened_solve_ops(ny: int, nx: int) -> float:
    """The screened-gradient solve of one real ``ny x nx`` plane: a real
    forward 2-D transform (17/9 n log2 n, half the 34/9 of the best known
    complex count), the screen and the two gradient multipliers on the half
    spectrum (8 a coefficient, n / 2 of them) and one complex inverse
    transform that gives both gradients as its real and imaginary parts
    (34/9 n log2 n)."""
    n = ny * nx
    return (17 / 9 + 34 / 9) * n * math.log2(n) + 8 * n / 2


# the solve's input (the source density) read once and its two gradient
# planes written once
SCREENED_SOLVE_BYTES = 3 * FLOAT


def porous_two_fluid_work(ny: int, nx: int) -> dict:
    """Config 5's steps by family: K6's step (the populations read and
    written once a step) and K8's solve (its density in and two force
    planes out once a step, its operations spread over the cells)."""
    return {"k6": Work(MC_OPS, 2 * MC_STATE_BYTES, "step"),
            "k8": Work(screened_solve_ops(ny, nx) / (ny * nx),
                       SCREENED_SOLVE_BYTES, "step")}
