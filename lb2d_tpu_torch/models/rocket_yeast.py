"""Rocket-yeast models: a population propelled by its own surfactant
(counterpart of ``lb2d_tpu.models.rocket_yeast``).

* :class:`RocketYeast` (``rocket_yeast.py:60-482``): population (logistic
  growth, negativity clip) + surfactant (produced at rate ``Gc rho``); the
  advection velocity is the surfactant's gradient, ``(u, v) =
  -(epsilon/cs^2) sum_j w_j c_j c(x + c_j)`` (``rocket_yeast.cl:316-399``),
  plus a Shan-Chen pseudo-force of ``psi(rho_pop)`` in the population's
  collision (``rocket_yeast.cl:74-151``).
* :class:`RocketYeastForcesOnly` (``rocket_yeast_forces_only.py``): the
  velocity is the sum of the force fields, surface tension ``-(epsilon /
  cs^2) grad S``, ``S = (1 - exp(-c/c_o))^alpha``, and pressure ``-G_chen
  (rho - rho_o) grad rho / cs^2``; no force term in the collision.

The whole step is local (one-belt stencils, periodic), so on CUDA K7
runs ``COUPLED_TEMPORAL_K`` steps per launch, the densities computed
inside (physics ``rocket_yeast`` / ``rocket_yeast_forces_only``), as JAX
fuses K steps per sweep; backends and state as
:class:`~lb2d_tpu_torch.models.waves.CoupledModel`. The diffusion constant
of the surfactant carries the reference's ``Dc / 4`` (``rocket_yeast.py:79``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops.fused_coupled import (
    CoupledConfig,
    coupled_feq,
    rocket_yeast_velocity,
    stencil_gradient,
)
from .base import resolve_device
from .waves import CoupledModel

__all__ = ["RocketYeast", "RocketYeastForcesOnly", "stencil_gradient"]


class RocketYeast(CoupledModel):
    """Dimensionless units (L = T = 1); fields: population (0), surfactant
    (1). State ``f[9, 2, ny, nx]``. Arguments as in the JAX class, plus
    ``backend`` and ``device``; the initial condition is the same numpy
    ``RandomState(seed)`` draw, so both packages start from the same f."""

    POP, SURF = 0, 1
    _forces_only = False

    def __init__(self, Lx=1.0, Ly=1.0, R0=5.0, epsilon=1.0, Dc=1.0 / 4.0,
                 Gc=2.0, rho_o=1.0, G_chen=-1.0, time_prefactor=1.0, N=10,
                 seed=0, check_max_ulb=False, mach_tolerance=0.1,
                 dtype=torch.float32, backend="auto", device="cuda"):
        self.Lx, self.Ly = Lx, Ly
        self.D, self.G = 1.0 / 4.0, 1.0
        self.Dc = (1.0 / 4.0) * Dc          # rocket_yeast.py:79 quirk: Dc/4
        self.Gc = Gc
        self.epsilon = epsilon
        self.R0 = R0
        self.rho_o, self.G_chen = rho_o, G_chen
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.device = resolve_device(device)
        self.check_max_ulb = check_max_ulb
        self.mach_tolerance = mach_tolerance

        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        cs2 = self.lattice.cs2
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / cs2))
        self.lb_G = np.float32(self.G * self.delta_t)
        self.lb_Dc = np.float32(self.Dc * self.delta_t / self.delta_x**2)
        self.omega_c = np.float32(1.0 / (0.5 + self.lb_Dc / cs2))
        self.lb_Gc = np.float32(self.Gc * self.delta_t)
        if not (self.omega < 2.0 and self.omega_c < 2.0):
            raise ValueError(f"omega = {self.omega}, omega_c = "
                             f"{self.omega_c}: >= 2 is unstable")

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))
        self.backend = self._pick_backend(backend)

        rng = np.random.RandomState(seed)
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        # rocket_yeast.py:305-308
        pop0 = np.exp(-(Xd**2 + Yd**2) / R0**2) * (
            1.0 + 0.05 * rng.randn(self.ny, self.nx))
        surf0 = np.zeros((self.ny, self.nx), np.float32)
        rho0 = torch.tensor(np.stack([pop0, surf0]), dtype=dtype,
                            device=self.device)
        u, v = self._rocket_velocity(rho0)
        self.state = coupled_feq(rho0, u, v).contiguous()
        self._finish_setup()

    def coupled_config(self) -> CoupledConfig:
        kw = {}
        if self._forces_only:
            kw = dict(c_o=self.c_o, alpha=self.alpha)
        return CoupledConfig(
            "rocket_yeast_forces_only" if self._forces_only
            else "rocket_yeast", omega=float(self.omega),
            lb_G=float(self.lb_G), omega2=float(self.omega_c),
            lb_G2=float(self.lb_Gc), epsilon=self.epsilon, rho_o=self.rho_o,
            G_chen=self.G_chen, **kw)

    def _rocket_velocity(self, rho):
        """(u, v) of the densities ``rho[2, ny, nx]``
        (``rocket_yeast.py:401-410``)."""
        return rocket_yeast_velocity(rho, self.coupled_config())

    def _velocity_fields(self):
        return self._rocket_velocity(self.state.sum(dim=0))

    def device_field(self, name):
        if name == "rho":
            return self.state[:, self.POP].sum(dim=0)
        if name == "surfactant":
            return self.state[:, self.SURF].sum(dim=0)
        return None

    def get_fields(self):
        f = self.state
        rho = f.sum(dim=0)
        u, v = self._rocket_velocity(rho)
        feq = coupled_feq(rho, u, v)

        def host(t):
            return t.detach().cpu().numpy()

        return {
            "f": np.transpose(host(f), (3, 2, 1, 0)),
            "feq": np.transpose(host(feq), (3, 2, 1, 0)),
            "rho": np.transpose(host(rho), (2, 1, 0)),
            "u": host(u).T,
            "v": host(v).T,
        }


class RocketYeastForcesOnly(RocketYeast):
    """Velocity = surface-tension + pressure force fields directly
    (``rocket_yeast_forces_only.py``); no force term in the collision."""

    _forces_only = True

    def __init__(self, c_o=0.25, alpha=2.0, **kwargs):
        self.c_o = c_o
        self.alpha = alpha
        super().__init__(**kwargs)
