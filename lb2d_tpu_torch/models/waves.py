"""Coupled Fisher-wave models (counterpart of ``lb2d_tpu.models.waves``).

Ported so far: :class:`NoisyAdvectedFisherWave`. ``ScreenedFisherWave`` and
``RepellingFisherWave`` come with the spectral and Poisson slices
(ROADMAP.md queue 1 items 6-7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from .base import resolve_device
from .diffusion import PeriodicScalarModel

__all__ = ["NoisyAdvectedFisherWave"]


class NoisyAdvectedFisherWave(PeriodicScalarModel):
    """Stochastic Fisher wave in a uniform imposed flow
    (``reaction_diffusion/noisy_fisher_wave.py:54-480``): multiplicative
    demographic noise ``sqrt(Dg rho (1-rho)) eta`` and the negativity clip
    (``D2Q9_diffusion.cl:126-167``), fresh normals every step. Scaling:
    L = z, T = z^2/D, ``Pe = z vc / D``, ``Gd_lb = (g z^2/D) dt``,
    ``Dg_lb = (z/(Nc D)) dt/dx`` (``noisy_fisher_wave.py:188-207``);
    ``Nc = inf`` switches the noise off.

    Arguments as in the JAX class, plus ``backend`` and ``device``. Backends,
    noise and state as in :mod:`lb2d_tpu_torch.models.diffusion`: the
    normals are keyed by ``rng_seed`` and ``steps_taken``; JAX's
    ``jax.random`` key is not carried.
    """

    noisy = True

    def __init__(self, Lx=1.0, Ly=1.0, D=1.0, z=0.1, vx=0.0, vy=0.0, vc=0.0,
                 g=1.0, Nc=10.0, time_prefactor=1.0, N=50, seed=0,
                 rng_seed=0, dtype=torch.float32, backend="auto",
                 device="cuda"):
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_D, self.phys_z = D, z
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.phys_g, self.phys_Nc = g, Nc
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.device = resolve_device(device)
        self.rng_seed = int(rng_seed)

        self.L = z
        self.T = z**2 / D
        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x

        # noisy_fisher_wave.py:188-207
        self.Pe = z * vc / D
        self.dim_Gd = g * z**2 / D
        self.lb_Gd = np.float32(self.dim_Gd * self.delta_t)
        self.Dg = (1.0 / Nc) * (z / D)
        self.lb_Dg = np.float32(self.Dg * self.delta_t / self.delta_x)
        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")

        self.lx = N * int(Lx / self.L)
        self.ly = N * int(Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        if vc != 0:
            dim_vx, dim_vy = self.Pe * vx / vc, self.Pe * vy / vc
        else:
            dim_vx = dim_vy = 0.0
        self._set_velocity(self.ulb * dim_vx, self.ulb * dim_vy)

        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        self._setup(np.exp(-(Xd**2 + Yd**2)), seed, backend)

    def _lb_G(self):
        return float(self.lb_Gd)

    def _lb_Dg(self):
        return float(self.lb_Dg)
