"""The seven multicomponent configurations that K6's checks run.

``chip_smoke.py`` and ``tests/test_torch_kernel_cuda.py`` hold K6 to its
plain step in each; ``tests/test_torch_multicomponent.py`` builds each with
the JAX package's classes too (``runner``, ``fluid``, ``d2q25``), so the
port and JAX start from the same arguments and state.
"""

from __future__ import annotations

import numpy as np

from .core import D2Q25
from .models.multicomponent import Fluid, SimulationRunner

__all__ = ["MC_CASES", "mc_case"]

MC_CASES = "abcdefg"


def mc_case(case, ny, nx, seed=3, runner=SimulationRunner, fluid=Fluid,
            d2q25=D2Q25, **runner_kw):
    """A runner of configuration ``case``: (a) porous + Shan-Chen belt 1 +
    constant force + eating; (b) non-porous second belt, linear, + growth +
    g force + static radial force; (c) no forces; (d) D2Q25, 2 fluids,
    Shan-Chen + eating; (e) zero-gradient fluids + clamped interaction +
    radial g force; (f) the pow and vdw potentials; (g) 3 fluids, two
    interactions. Densities about 0.5 with 5% noise (numpy ``seed``), f
    perturbed by 1%. ``runner_kw`` go to ``runner`` (``device``,
    ``backend``, ``dtype``)."""
    porous = case in ("a", "e")
    C = 3 if case == "g" else 2
    if case == "d":
        runner_kw["lattice"] = d2q25
    sim = runner(nx=nx, ny=ny, L_lb=nx, num_populations=C, porous=porous,
                 **runner_kw)
    bc = "zero_gradient" if case == "e" else "periodic"
    for i in range(C):
        sim.add_fluid(fluid(sim, i, nu_e=0.5, epsilon=0.8 if porous else 1.0,
                            nu_fluid=0.4, K=2.0, Fe=0.5, bc=bc))
    sim.complete_setup()
    rng = np.random.RandomState(seed)
    base = 0.5 + 0.05 * rng.rand(ny, nx)
    rhos = [base, 1.0 - base, 0.3 + 0.05 * rng.rand(ny, nx)][:C]
    for i, rho in enumerate(rhos):
        sim.fluid_list[i].initialize(rho, f_amp=0.01)
    sc = dict(potential="shan_chen", potential_parameters=[1.0])
    if case == "a":
        sim.add_interaction_force(0, 1, G_int=1.5, **sc)
        sim.add_constant_body_force(0, 1e-5, 0.0)
        sim.add_eating_rate(0, 1, 0.01)
    elif case == "b":
        sim.add_interaction_force_second_belt(0, 1, G_int=1.5)
        sim.add_growth(0, 0.1, 2.0, 1e-4)
        sim.add_constant_g_force(1, 0.0, 2e-6)
        sim.add_radial_body_force(0, nx / 2, ny / 3, 1e-5, 1.0)
    elif case == "d":
        sim.add_interaction_force(0, 1, G_int=1.5, **sc)
        sim.add_eating_rate(0, 1, 0.005)
    elif case == "e":
        sim.add_interaction_force(0, 1, G_int=1.5, bc="zero_gradient", **sc)
        sim.add_radial_g_force(1, nx / 3, ny / 2, 1e-6, 1.0)
    elif case == "f":
        sim.add_interaction_force(0, 1, G_int=0.5, potential="pow",
                                  potential_parameters=[1.5])
        sim.add_interaction_force(0, 1, G_int=1.0, potential="vdw",
                                  potential_parameters=[0.1, 0.1, 1.0,
                                                        1.0 / np.sqrt(3.0)])
    elif case == "g":
        sim.add_interaction_force(0, 1, G_int=1.5, **sc)
        sim.add_interaction_force_second_belt(1, 2, G_int=0.9)
        sim.add_eating_rate(2, 0, 0.01)
    return sim
