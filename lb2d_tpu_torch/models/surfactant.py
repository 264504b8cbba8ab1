"""Surfactant-nutrient wave models (counterpart of
``lb2d_tpu.models.surfactant``): population + nutrient sharing one velocity.

* :class:`SurfactantNutrientWave`: the two fields share ``(u, v)`` from a
  screened-Poisson solve of the population density every step
  (``surfactant_nutrient_waves.py:373-397``); growth ``G rho n`` feeds the
  population and depletes the nutrient
  (``surfactant_nutrient_waves.cl:74-128``).
* :class:`ClumpySurfactantNutrientWave`: adds Shan-Chen self-attraction of
  the population, the pseudo-force of ``psi = rho_o (1 - exp(-rho /
  rho_o))`` (``:130-199, 242-364``).

On CUDA each sweep of ``stale_velocity`` steps is K6's density pass, K8
and K7 launches of up to ``COUPLED_TEMPORAL_K`` steps (physics
``surfactant`` / ``clumpy_surfactant``); backends, ``stale_velocity`` and
state as :class:`~lb2d_tpu_torch.models.waves.CoupledModel`. The stencils
(:func:`psi_shan_chen`, :func:`psi_sticky_repulsive`,
:func:`pseudo_force`) live in :mod:`lb2d_tpu_torch.ops.fused_coupled`,
beside the plain steps that use them, and are re-exported here, where the
JAX package keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops.fused_coupled import (
    CoupledConfig,
    coupled_feq,
    pseudo_force,
    psi_shan_chen,
    psi_sticky_repulsive,
)
from ..utils.tracing import traced, traced_field
from .base import resolve_device
from .waves import CoupledModel, _ScreenedVelocity

__all__ = [
    "SurfactantNutrientWave",
    "ClumpySurfactantNutrientWave",
    "psi_shan_chen",
    "psi_sticky_repulsive",
    "pseudo_force",
]


class SurfactantNutrientWave(CoupledModel):
    """Dimensionless two-field wave (``surfactant_nutrient_waves.py:60-135``):
    D = 1/4 (population), Dn (nutrient), G = 1; state ``f[9, 2, ny, nx]``
    with field 0 the population and field 1 the nutrient. Arguments as in
    the JAX class, plus ``backend`` and ``device``."""

    POP, NUT = 0, 1
    _clumpy = False

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, lam=1.0, Dn=1.0 / 4.0, R0=5.0,
                 time_prefactor=1.0, N=50, seed=0, check_max_ulb=False,
                 mach_tolerance=0.1, dtype=torch.float32, method="auto",
                 stale_velocity=1, solve_precision="highest", backend="auto",
                 device="cuda"):
        self.stale_velocity = stale_velocity
        self.Lx, self.Ly = Lx, Ly
        self.D, self.Dn, self.G = 1.0 / 4.0, Dn, 1.0
        self.vc, self.lam, self.R0 = vc, lam, R0
        self.L = self.T = 1.0
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
        self.lb_Dn = np.float32(self.Dn * self.delta_t / self.delta_x**2)
        self.omega_n = np.float32(1.0 / (0.5 + self.lb_Dn / cs2))
        if not (self.omega < 2.0 and self.omega_n < 2.0):
            raise ValueError(f"omega = {self.omega}, omega_n = "
                             f"{self.omega_n}: >= 2 is unstable")
        self.lb_G = np.float32(self.G * self.delta_t)

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        self.backend = self._pick_backend(backend)
        self._velocity = _ScreenedVelocity(
            self.ny, self.nx, lam, self.delta_x, vc, self.ulb, method,
            mm=solve_precision, plain=self.backend == "eager")

        rng = np.random.RandomState(seed)
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        # surfactant_nutrient_waves.py:283-288
        pop0 = 1.2 * np.exp(-(Xd**2 + Yd**2) / R0**2) * (
            1.0 + 0.05 * rng.randn(self.ny, self.nx))
        nut0 = np.ones((self.ny, self.nx), np.float32)
        rho0 = torch.tensor(np.stack([pop0, nut0]), dtype=dtype,
                            device=self.device)
        self.state = self._state_from_rho(rho0)
        self._finish_setup()

    def coupled_config(self) -> CoupledConfig:
        kw = {}
        if self._clumpy:
            kw = dict(rho_o=self.rho_o, G_chen=self.G_chen)
        return CoupledConfig(
            "clumpy_surfactant" if self._clumpy else "surfactant",
            omega=float(self.omega), lb_G=float(self.lb_G),
            omega2=float(self.omega_n), **kw)

    def _state_from_rho(self, rho):
        u, v = self._velocity(rho[self.POP])
        return coupled_feq(rho, u, v).contiguous()

    def redo_initial_condition(self, rho_field):
        """Re-seed from user densities ``[2, ny, nx]`` (population,
        nutrient)."""
        self.state = self._state_from_rho(torch.as_tensor(
            np.asarray(rho_field), dtype=self.dtype, device=self.device))
        return self

    @traced_field
    def device_field(self, name):
        if name == "rho":
            return self.state[:, self.POP].sum(dim=0)
        if name == "nutrient":
            return self.state[:, self.NUT].sum(dim=0)
        return None

    @traced("lb2d.readout.get_fields")
    def get_fields(self):
        f = self.state
        rho = f.sum(dim=0)
        u, v = self._velocity(rho[self.POP])
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


class ClumpySurfactantNutrientWave(SurfactantNutrientWave):
    """Adds Shan-Chen clumping to the population field
    (``surfactant_nutrient_waves.py:437-521``)."""

    _clumpy = True

    def __init__(self, rho_o=1.0, G_chen=-1.0, **kwargs):
        self.rho_o = float(rho_o)
        self.G_chen = float(G_chen)
        super().__init__(**kwargs)

