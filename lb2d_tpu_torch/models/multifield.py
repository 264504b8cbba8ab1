"""Multifield range-expansion models (counterpart of
``lb2d_tpu.models.multifield``).

* :class:`FisherExpansion`: F competing populations with logistic growth
  against the total density ``G_p rho_p (1 - rho_tot)`` and no-flux walls
  on all four sides (``D2Q9_multifield_fisher.cl``).
* :class:`Expansion`: P populations and one nutrient, growth ``G_p rho_p
  c`` that consumes the nutrient, the Milstein noise ``sqrt(Dg rho c) eta +
  (Dg c / 4)(eta^2 - 1)`` and the zero/negative/NaN clips
  (``D2Q9_multifield_diffusion.cl``), fully periodic.

Both use the Fisher scaling ``L = 2 sqrt(D_std / mu_std)``, ``T = 1 /
mu_std``; the JAX module's docstring gives the reference lines and the
zero-velocity rule, which hold here too. The state is ``f[9, F, ny, nx]``
(F fields; for Expansion the nutrient is the last), contiguous, so that as
``[9F, ny, nx]`` plane ``j F + p`` is direction j of field p, the TPU
kernel's layout.

Backends, each on a CUDA device a hand-written kernel of
:mod:`lb2d_tpu_torch.ops.fused`, at any ``ny x nx``:

* ``"temporal"`` (K4, :func:`~lb2d_tpu_torch.ops.fused.temporal_multifield_step`):
  ``temporal_k`` steps per launch and one shorter launch for the rest of
  ``run(n)``. ``"auto"`` picks it on CUDA for up to
  ``MAX_MULTIFIELD_FIELDS`` fields. The kernel applies the walls by global
  coordinates and wraps the periodic domain exactly, so it equals the
  plain steps and the JAX models' wall and seam patches (and K5's band
  step on the Expansion's y-wrap) are not needed.
* ``"eager"`` (the default on the CPU, JAX's XLA step; ``"xla"`` is
  taken as an alias): the plain PyTorch step. On a CUDA device it runs
  only when asked for by name; ``"auto"``
  there raises for more fields than the kernel takes or a dtype other than
  float32.

JAX's TPU gates (``supports_temporal_multifield``, ``ny >= 24 K``) have no
counterpart.

Noise. :class:`Expansion` keeps ``state`` as the populations tensor alone.
Population p's normal at a cell and step is the Philox normal of
(``rng_seed``, global step, cell, p)
(:func:`~lb2d_tpu_torch.ops.random.population_normals_reference`), and the
global step is ``steps_taken``, so ``run(a); run(b)`` equals ``run(a + b)``
bit for bit and the kernel follows the plain step with noise on. JAX's
``jax.random`` key (the second half of its ``(f, key)`` state) has no
counterpart and is not carried: state crosses between the packages as the
populations only (``load_numpy_state(np.asarray(jax_sim.state[0]))``),
and the two packages draw different noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops import _build
from ..ops.equilibrium import feq_linear
from ..ops.fused import (
    MAX_MULTIFIELD_FIELDS,
    multifield_max_k,
    multifield_run_reference,
    noflux_walls_reference,
    temporal_multifield_step,
)
from ..ops.moments import density
from .base import LBModel, plain_backend, resolve_device

__all__ = ["FisherExpansion", "Expansion", "noflux_bcs_multifield",
           "FISHER_TEMPORAL_K", "EXPANSION_TEMPORAL_K"]

# steps per K4 launch: the fastest K of each physics on an H100 at the
# reference's sizes, 2048^2 with F = 2 and 1024^2 with F = 3 (PERF.md, the
# K sweep of chip_smoke.py)
FISHER_TEMPORAL_K = 8
EXPANSION_TEMPORAL_K = 4
_BACKENDS = ("auto", "temporal", "eager")


# JAX's name for the no-flux walls of every field (masked selects,
# D2Q9_multifield_fisher.cl:184-289)
noflux_bcs_multifield = noflux_walls_reference


class _MultifieldBase(LBModel):
    """Shared scaffolding: Fisher scaling, grid, imposed velocity, linear feq
    over all fields, backends and getters.

    Arguments as in the JAX class, plus ``backend`` and ``device`` (default
    ``"cuda"``; a machine without CUDA raises).
    """

    physics = "fisher"

    def __init__(self, Lx=1.0, Ly=1.0, vx=0.0, vy=0.0, vc=0.0,
                 mu_standard=1.0, mu_list=None, D_standard=1.0, D_list=None,
                 time_prefactor=1.0, N=50, rho_amp=1.0,
                 concentration_amp=1.0, seed=0, dtype=torch.float32,
                 backend="auto", device="cuda", **kw):
        if mu_list is None or D_list is None:
            raise ValueError("mu_list and D_list are required")
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.phys_mu_standard = mu_standard
        self.phys_mu_list = np.asarray(mu_list, np.float64)
        self.D_standard = D_standard
        self.phys_D_list = np.asarray(D_list, np.float64)
        self.num_populations = len(self.phys_mu_list)
        self.rho_amp = rho_amp
        self.concentration_amp = concentration_amp
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.device = resolve_device(device)
        self._extra_init(**kw)

        # Fisher scaling (stochastic_nutrients.py:252-261)
        self.L = 2.0 * np.sqrt(self.D_standard / self.phys_mu_standard)
        self.T = 1.0 / self.phys_mu_standard
        self.vf = self.L / self.T
        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2

        # field constants, float32 as in JAX (stochastic_nutrients.py:204-250)
        self.dim_vel_ratio = self.phys_vc / self.vf
        self.dim_G = self.phys_mu_list / self.phys_mu_standard
        self.lb_G = (self.dim_G * self.delta_t).astype(np.float32)
        self.dim_D_population = self.phys_D_list / (4.0 * self.D_standard)
        self.lb_D_population = (
            self.dim_D_population * self.delta_t / self.delta_x**2
        ).astype(np.float32)
        self.omega = ((0.5 + self.lb_D_population / self.lattice.cs2) ** -1.0
                      ).astype(np.float32)
        if not (self.omega < 2.0).all():
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")

        # grid (stochastic_nutrients.py:263-273): +2 boundary ring
        self.lx = self.N * int(self.phys_Lx / self.L)
        self.ly = self.N * int(self.phys_Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        # imposed velocity (stochastic_nutrients.py:390-402); vc = 0 -> zero
        if self.phys_vc != 0:
            dim_vx = self.dim_vel_ratio * self.phys_vx / self.phys_vc
            dim_vy = self.dim_vel_ratio * self.phys_vy / self.phys_vc
        else:
            dim_vx = dim_vy = 0.0
        self.lb_vx = (self.delta_t / self.delta_x) * dim_vx
        self.lb_vy = (self.delta_t / self.delta_x) * dim_vy
        self.u_lb = float(np.float32(self.lb_vx))
        self.v_lb = float(np.float32(self.lb_vy))
        like = dict(dtype=self.dtype, device=self.device)
        self.u = torch.full((1, 1), self.u_lb, **like)
        self.v = torch.full((1, 1), self.v_lb, **like)

        self.backend = self._pick_backend(backend)
        rho0 = torch.as_tensor(self._initial_rho(), **like)
        self.state = self._feq(rho0).contiguous()
        super().__init__()

    def _extra_init(self, **kw):
        if kw:
            raise TypeError(f"unexpected arguments {sorted(kw)}")

    @property
    def num_fields(self) -> int:
        raise NotImplementedError

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    @property
    def temporal_k(self) -> int:
        """Steps per K4 launch for this model's physics and fields."""
        k = (EXPANSION_TEMPORAL_K if self.physics == "expansion"
             else FISHER_TEMPORAL_K)
        return min(k, multifield_max_k(self.num_fields))

    def _pick_backend(self, backend):
        backend = plain_backend(backend)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use 'auto', "
                             "'temporal' or 'eager'")
        if backend == "eager":
            return backend
        if self.device.type != "cuda":
            if backend == "auto":
                return "eager"
            raise ValueError(f"backend={backend!r} runs a CUDA kernel and "
                             f"needs a CUDA device, not {self.device}")
        if self.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels are float32 only, not "
                             f"{self.dtype}; pass backend='eager' to run the "
                             "plain PyTorch step on the card")
        if self.num_fields > MAX_MULTIFIELD_FIELDS:
            raise ValueError(f"the multifield kernel takes up to "
                             f"{MAX_MULTIFIELD_FIELDS} fields, not "
                             f"{self.num_fields}; pass backend='eager' to run "
                             "the plain PyTorch step on the card")
        return "temporal"

    def _feq(self, rho: torch.Tensor) -> torch.Tensor:
        """Linear feq per field with the shared (u, v)
        (``D2Q9_multifield_diffusion.cl:1-47``); rho is ``[F, ny, nx]``."""
        return feq_linear(rho, self.u, self.v, self.lattice)

    def step_kwargs(self) -> dict:
        """The arguments of this model's step for
        :func:`~lb2d_tpu_torch.ops.fused.multifield_run_reference` and K4,
        ``step0`` aside."""
        return dict(omegas=self.omega, lb_G=self.lb_G, u_lb=self.u_lb,
                    v_lb=self.v_lb, physics=self.physics)

    def make_step(self):
        """``run(n)`` is one hook, ``_run_n``, that reads ``steps_taken`` as
        the global step of its first step (the noise's step counter)."""
        kw = self.step_kwargs()
        if self.backend == "eager":
            def run_n(f, n):
                return multifield_run_reference(f, n, step0=self.steps_taken,
                                                **kw)
        else:
            _build.load_library()  # build now, outside any timed region
            spare = [torch.empty_like(self.state)]
            k_max = self.temporal_k

            def run_n(f, n):  # K4 over two buffers
                step = self.steps_taken
                while n > 0:
                    k = min(n, k_max)
                    out = temporal_multifield_step(f, spare[0], k, step0=step,
                                                   **kw)
                    spare[0], f = f, out
                    n -= k
                    step += k
                return f
        self._run_n = run_n
        return lambda f: run_n(f, 1)

    # -- getters (multifield.py:155-178) ---------------------------------------
    def get_fields(self) -> dict:
        """``f``, ``feq`` (``[nx, ny, F, Q]``), ``rho`` (``[nx, ny, F]``) and
        the imposed ``u``, ``v`` (``[nx, ny]``) in LB units as numpy arrays,
        the reference layout."""
        f = self.state
        rho = density(f)
        feq = self._feq(rho)

        def host(t, axes):
            return np.transpose(t.detach().cpu().numpy(), axes)

        return {
            "f": host(f, (3, 2, 1, 0)),
            "feq": host(feq, (3, 2, 1, 0)),
            "rho": host(rho, (2, 1, 0)),
            "u": np.broadcast_to(self.u.cpu().numpy(), (self.nx, self.ny)),
            "v": np.broadcast_to(self.v.cpu().numpy(), (self.nx, self.ny)),
        }

    def get_nondim_fields(self) -> dict:
        fields = self.get_fields()
        scale = self.delta_x / self.delta_t
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields

    def get_physical_fields(self) -> dict:
        fields = self.get_nondim_fields()
        fields["u"] = fields["u"] * (self.L / self.T)
        fields["v"] = fields["v"] * (self.L / self.T)
        return fields

    def device_field(self, name):
        """``"rho"``, the total density of all fields, as a device tensor
        ``[ny, nx]`` (no host copy)."""
        if name == "rho":
            return self.state.sum(dim=(0, 1))
        return None


class FisherExpansion(_MultifieldBase):
    """Deterministic multifield Fisher waves with logistic competition and
    no-flux walls (``deterministic_fisher_waves.py:55-499``).

    ``initial_frac_widths`` / ``initial_frac_indices`` paint vertical stripes
    of each population over the first ``N * initial_fisher_widths`` rows
    (``deterministic_fisher_waves.py:299-345``).
    """

    physics = "fisher"

    def _extra_init(self, initial_frac_widths=None, initial_frac_indices=None,
                    initial_fisher_widths=2):
        if initial_frac_widths is None or initial_frac_indices is None:
            raise ValueError("initial_frac_widths and initial_frac_indices "
                             "are required")
        self.initial_frac_widths = list(initial_frac_widths)
        self.initial_frac_indices = list(initial_frac_indices)
        self.initial_fisher_widths = initial_fisher_widths

    @property
    def num_fields(self) -> int:
        return self.num_populations

    def _initial_rho(self) -> np.ndarray:
        """Stripes along x over an occupied band of rows
        (``deterministic_fisher_waves.py:325-345``)."""
        rho = np.zeros((self.num_populations, self.ny, self.nx), np.float32)
        band = int(self.N * self.initial_fisher_widths)
        sites = 0
        n_w = len(self.initial_frac_widths)
        for count, (width, idx) in enumerate(
                zip(self.initial_frac_widths, self.initial_frac_indices), 1):
            num = int(width * self.nx)
            if count == n_w:
                num = self.nx - sites
            rho[idx, 0:band, sites:sites + num] = 1.0
            sites += num
        return rho


class Expansion(_MultifieldBase):
    """Stochastic multifield range expansion with a consumable nutrient
    (``stochastic_nutrients.py:55-545``): ``state`` is ``f[9, P + 1, ny,
    nx]``, the last field the nutrient.

    Per step: periodic stream -> clipped hydro -> linear feq -> collision
    with growth ``G_p rho_p c``, Milstein noise, nutrient consumption
    ``-sum_p react_p`` and the zero/negative/NaN clips
    (``D2Q9_multifield_diffusion.cl:80-168``), fresh normals per population
    every step, keyed by ``rng_seed`` and ``steps_taken`` (see the module
    docstring). ``Nb = inf`` switches the noise off.
    """

    physics = "expansion"

    def _extra_init(self, Nb=10.0, Dc=1.0, zero_cutoff=0.01, rng_seed=0):
        self.phys_Nb = Nb
        self.phys_Dc = Dc
        self.zero_cutoff = zero_cutoff
        self.rng_seed = int(rng_seed)

    @property
    def num_fields(self) -> int:
        return self.num_populations + 1

    def _initial_rho(self) -> np.ndarray:
        """Well-mixed inoculation over the first 2N rows, uniform nutrient
        (``stochastic_nutrients.py:368-385``); sets the nutrient's and the
        noise's constants (``:218-248``) first."""
        self.dim_Dg = (self.phys_mu_list / self.phys_Nb) / (4.0 * self.D_standard)
        self.lb_Dg = (self.dim_Dg * self.delta_t).astype(np.float32)
        self.dim_D_nutrient = self.phys_Dc / (4.0 * self.D_standard)
        self.lb_D_nutrient = self.dim_D_nutrient * self.delta_t / self.delta_x**2
        self.omega_nutrient = np.float32(
            1.0 / (0.5 + self.lb_D_nutrient / self.lattice.cs2))
        if not self.omega_nutrient < 2.0:
            raise ValueError(f"omega_nutrient = {self.omega_nutrient} >= 2 "
                             "is unstable")
        P = self.num_populations
        rho = np.zeros((P + 1, self.ny, self.nx), np.float32)
        rho[0:P, 0:2 * self.N, :] = self.rho_amp / P
        rho[P] = self.concentration_amp
        return rho

    def step_kwargs(self) -> dict:
        return dict(super().step_kwargs(), omega_nutrient=self.omega_nutrient,
                    lb_Dg=self.lb_Dg, cutoff=self.zero_cutoff,
                    seed=self.rng_seed)
