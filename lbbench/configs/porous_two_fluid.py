"""``porous_two_fluid``: BASELINE config 5 whole, the reference's headline
workload, through the port's ``SimulationRunner``: two fluids in a porous
medium (Darcy and Forchheimer drag, porosity equilibrium, Guo forcing), a
first-belt Shan-Chen interaction with the ``shan_chen`` pseudopotential,
and the screened-Poisson repulsion of fluid 0's density on fluid 1, solved
every step (no ``stale_force``). On the card each step is K6's
``mc_density``, K8 and K6's ``mc_step``. The parameters are those of
``chip_smoke.py``'s ``_porous_runner`` with ``screened=True``
(``benchmarks/run_all.py:113-140`` and its screened hook).

One interval: ``run(M)``, then every interval ``conservation_report``'s
sums of ``f`` and ``rho`` (scalars back to the host), every
``snapshot_every``-th interval each fluid's density into pinned host
buffers. For the check, the force planes that K8 wrote in the interval's
last step, which ``mc_step`` read, are copied once on the card
(``held``). The port is imported only when a cell is built.
"""

import numpy as np
import torch

SOURCE = ("https://github.com/latticeboltzmann/2d-lb/tree/master/LB_D2Q9/"
          "multicomponent_multiphase")
FLUIDS = 2
FLUID = {"nu_e": 1.0 / 6.0, "epsilon": 0.8, "nu_fluid": 1.0 / 6.0,
         "K": 10.0, "Fe": 0.1}
G_INT = 1.5
PSI = ("shan_chen", [1.0])
SCREEN_LENGTH = 10.0
SCREEN_AMPLITUDE = 1e-4
BASE_MEAN, BASE_SPREAD = 0.5, 0.05   # fluid 0: mean + spread U(0, 1)
ZERO_DENSITY = 1e-6                  # the porous runner's (single_component.cl:9)
ASSUMED = {
    "dtype": "float32",
    "backend": "auto",
    "L_lb": "the grid's width",
    "base_density": "0.5 + 0.05 U(0,1) from torch.Generator(device).manual_seed"
                    "(seed) in place of RandomState(0); fluid 1 gets 1 - base",
}


def work(mix) -> dict:
    """The work of the steps by kernel family (``lbbench/kernels``)."""
    from lbbench.kernels import _counts
    return _counts.porous_two_fluid_work(*mix["grid"])


def inputs(mix, seed, device) -> dict:
    """The raw input both sides read: fluid 0's initial density, drawn on
    ``device`` from ``seed``."""
    ny, nx = mix["grid"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand((ny, nx), generator=g, device=device, dtype=torch.float32)
    return {"base": BASE_MEAN + BASE_SPREAD * u}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Cell:
    """The port's runner for one traffic mix, and one interval of it."""

    def __init__(self, mix, seed, device):
        from lb2d_tpu_torch.models import Fluid, SimulationRunner
        from lb2d_tpu_torch.utils import conservation_report

        self.device = torch.device(device)
        self.ny, self.nx = mix["grid"]
        sim = SimulationRunner(nx=self.nx, ny=self.ny, L_lb=self.nx,
                               num_populations=FLUIDS, porous=True,
                               device=self.device)
        for i in range(FLUIDS):
            sim.add_fluid(Fluid(sim, i, **FLUID))
        sim.complete_setup()
        self.inputs = inputs(mix, seed, self.device)
        host = self.inputs["base"].cpu()
        sim.fluid_list[0].initialize(host)
        sim.fluid_list[1].initialize(1.0 - host)
        sim.add_interaction_force(0, 1, G_int=G_INT, potential=PSI[0],
                                  potential_parameters=PSI[1])
        sim.add_screened_poisson_force(0, 1,
                                       interaction_length=SCREEN_LENGTH,
                                       amplitude=SCREEN_AMPLITUDE)
        self.sim = sim
        self.steps_per_interval = int(mix["steps_per_interval"])
        self.cells = self.ny * self.nx
        self.backend = sim.backend
        self._pin = self.device.type == "cuda"
        self._report = conservation_report

    def state(self) -> torch.Tensor:
        return self.sim.f

    def run(self):
        self.sim.run(self.steps_per_interval)

    def monitor(self) -> np.ndarray:
        r = self._report(self.sim.f, rho=self.sim.rho)
        return np.array([r["sum_f"], r["sum_rho"]])

    def snapshot_buffers(self) -> dict:
        return {f"rho{i}": torch.empty((self.ny, self.nx),
                                       dtype=torch.float32,
                                       pin_memory=self._pin)
                for i in range(FLUIDS)}

    def snapshot(self, out: dict):
        """Each fluid's density into the host buffers ``out``, on the host
        when this returns."""
        rho = self.sim.rho
        for i in range(FLUIDS):
            out[f"rho{i}"].copy_(rho[i], non_blocking=True)
        _sync(self.device)

    def held_buffers(self) -> dict:
        """Device buffers for ``held``; none where the runner holds no force
        planes (its eager step on the CPU solves inside the step)."""
        if self.backend != "kernel":
            return {}
        return {name: torch.empty((self.ny, self.nx), dtype=torch.float32,
                                  device=self.device)
                for name in ("fx", "fy")}

    def held(self, out: dict):
        """The screened-Poisson force the runner holds after ``run``: the
        ext pair that K8 wrote at the last step, ``amplitude (d/dx, d/dy)``
        of the screened density, copied into ``out`` on the card."""
        cfg, ext, _ = self.sim._plan
        (_, _, pair, _, _, _), = cfg.screened
        out["fx"].copy_(ext[2 * pair])
        out["fy"].copy_(ext[2 * pair + 1])

    def close(self):
        self.sim = None
