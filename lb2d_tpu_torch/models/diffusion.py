"""Advection-diffusion / reaction-diffusion family (counterpart of
``lb2d_tpu.models.diffusion``).

A scalar density advected by an imposed constant velocity with the linear
feq (``D2Q9_diffusion.cl:1-38``), optional Fisher growth ``G rho (1 -
rho)`` (``:95-124``) and, in the stochastic class, multiplicative noise
``sqrt(Dg rho (1 - rho)) eta`` with the negativity clip (``:126-167``). The
domain is fully periodic; the JAX module's docstring lists its divergences
from the reference, which hold here too.

Backends, each a hand-written CUDA kernel of :mod:`lb2d_tpu_torch.ops.fused`
on a CUDA device, at any ``ny x nx``:

* ``"resident"`` (K3, :func:`~lb2d_tpu_torch.ops.fused.resident_diffusion_run`):
  the whole ``run(n)`` in one launch, the grid held in shared memory (up
  to about 790^2 cells, 16 x 4096 among the wide ones). ``"auto"`` picks
  it on CUDA for grids of up to ``RESIDENT_MAX_CELLS`` cells
  (``RESIDENT_MAX_CELLS_DIFFUSION`` without noise: there K2 wins at
  724^2).
* ``"temporal"`` (K2,
  :func:`~lb2d_tpu_torch.ops.fused.temporal_diffusion_step`): ``temporal_k``
  steps per launch and one shorter launch for the rest of ``run(n)``.
  ``"auto"`` picks it on CUDA for larger grids. The kernel wraps the
  periodic domain exactly, so the JAX model's seam patch is not needed.
* ``"eager"`` (the default on the CPU; JAX's ``"xla"``, taken as an
  alias): the plain PyTorch step. On a CUDA device it runs only when asked
  for by name.

That is JAX's ladder (``lb2d_tpu/models/diffusion.py:170-193``) without its
TPU alignment gates.

Noise. The stochastic models keep ``state`` as the populations tensor
alone. The normal of a cell at a step is the Philox normal of
(``rng_seed``, global step, cell) (:mod:`lb2d_tpu_torch.ops.random`), and
the global step is ``steps_taken``, so ``run(a); run(b)`` equals
``run(a + b)`` bit for bit on every backend, and the kernels follow the
plain step with noise on. JAX's ``jax.random`` key (the second half of its
``(f, key)`` state) has no counterpart and is not carried: state crosses
between the packages as the populations only (``load_numpy_state`` /
``state_numpy``), and the two packages draw different noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops import _build
from ..ops.equilibrium import feq_linear
from ..ops.fused import (
    diffusion_run_reference,
    resident_diffusion_run,
    resident_scratch,
    supports_resident,
    temporal_diffusion_step,
)
from ..ops.moments import density
from ..ops.random import normals
from ..utils.tracing import traced, traced_field
from .base import LBModel, plain_backend, resolve_device

__all__ = [
    "Diffusion",
    "AdvectionDiffusion",
    "ReactionDiffusion",
    "ReactionAdvectionDiffusion",
    "ReactionAdvectionDiffusionStochastic",
    "DIFFUSION_TEMPORAL_K",
    "NOISY_TEMPORAL_K",
]

# steps per K2 launch: the fastest K of each physics at 2048^2 on an H100
# (PERF.md, the K sweep of chip_smoke.py)
DIFFUSION_TEMPORAL_K = 8
NOISY_TEMPORAL_K = 4
_KERNEL_IDS = {"resident": "K3", "temporal": "K2"}


class PeriodicScalarModel(LBModel):
    """Backends, run hooks, noise and getters shared by the diffusion family
    and :class:`~lb2d_tpu_torch.models.waves.NoisyAdvectedFisherWave`.

    Subclasses set the scales (``omega``, ``nx``, ``ny``, ``L``, ``T``,
    ``delta_x``, ``delta_t``), ``dtype``, the imposed lattice velocity
    (:meth:`_set_velocity`) and, when ``noisy``, ``rng_seed``; then call
    :meth:`_setup`.
    """

    noisy = False  # the stochastic Fisher step (noise and clip)

    def _lb_G(self) -> float:
        return 0.0  # no reaction

    def _lb_Dg(self) -> float:
        return 0.0  # no noise

    @property
    def temporal_k(self) -> int:
        """Steps per K2 launch for this model's physics."""
        return NOISY_TEMPORAL_K if self.noisy else DIFFUSION_TEMPORAL_K

    def _set_velocity(self, u_lb, v_lb):
        """The imposed lattice velocity, rounded to float32 as JAX holds it:
        floats ``u_lb``, ``v_lb`` for the kernels and ``[1, 1]`` tensors
        ``u``, ``v`` on the device."""
        self.u_lb, self.v_lb = float(np.float32(u_lb)), float(np.float32(v_lb))
        like = dict(dtype=self.dtype, device=self.device)
        self.u = torch.full((1, 1), self.u_lb, **like)
        self.v = torch.full((1, 1), self.v_lb, **like)

    def _setup(self, rho0: np.ndarray, seed, backend):
        """Backend and the initial state: the linear feq of ``rho0`` times
        the 0.1% perturbation of ``np.random.RandomState(seed)``, exactly as
        JAX (``lb2d_tpu/models/diffusion.py:145-157``)."""
        self.backend = self._pick_backend(backend)
        rng = np.random.RandomState(seed)
        like = dict(dtype=self.dtype, device=self.device)
        perturb = 1.0 + 0.001 * rng.randn(9, self.ny, self.nx)
        feq0 = feq_linear(torch.as_tensor(rho0, **like), self.u, self.v,
                          self.lattice)
        self.state = (feq0 * torch.as_tensor(perturb, **like)).contiguous()
        LBModel.__init__(self)

    def _pick_backend(self, backend):
        backend = plain_backend(backend)
        if backend == "eager":
            return backend
        if backend != "auto" and backend not in _KERNEL_IDS:
            raise ValueError(f"unknown backend {backend!r}; use 'auto', "
                             f"{', '.join(map(repr, _KERNEL_IDS))} or 'eager'")
        if self.device.type != "cuda":
            if backend == "auto":
                return "eager"
            raise ValueError(f"backend={backend!r} runs a CUDA kernel and "
                             f"needs a CUDA device, not {self.device}")
        if self.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels are float32 only, not "
                             f"{self.dtype}; pass backend='eager' to run the "
                             "plain PyTorch step on the card")
        if backend == "auto":
            physics = "noisy_fisher" if self.noisy else "diffusion"
            return ("resident" if supports_resident(self.ny, self.nx, physics)
                    else "temporal")
        return backend

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    def step_kwargs(self) -> dict:
        """The arguments of this model's step for the plain steps and the
        kernels of :mod:`lb2d_tpu_torch.ops.fused`, ``step0`` aside."""
        kw = dict(omega=self.omega, u_lb=self.u_lb, v_lb=self.v_lb,
                  lb_G=self._lb_G())
        if self.noisy:
            kw.update(lb_Dg=self._lb_Dg(), noisy=True, seed=self.rng_seed)
        return kw

    def make_step(self):
        """``run(n)`` is one hook, ``_run_n``, that reads ``steps_taken`` as
        the global step of its first step (the noise's step counter)."""
        kw = self.step_kwargs()
        if self.backend == "eager":
            def run_n(f, n):
                return diffusion_run_reference(f, n, step0=self.steps_taken,
                                               **kw)
        else:
            _build.load_library()  # build now, outside any timed region
            if self.backend == "resident":
                scratch = resident_scratch(self.state)

                def run_n(f, n):  # K3, in place
                    return resident_diffusion_run(
                        f, scratch, n, step0=self.steps_taken, **kw)
            else:
                k_max = self.temporal_k
                spare = [torch.empty_like(self.state)]

                def run_n(f, n):  # K2 over two buffers
                    step = self.steps_taken
                    while n > 0:
                        k = min(n, k_max)
                        out = temporal_diffusion_step(f, spare[0], k,
                                                      step0=step, **kw)
                        spare[0], f = f, out
                        n -= k
                        step += k
                    return f
        self._run_n = run_n
        return lambda f: run_n(f, 1)

    def noise(self, step: int | None = None) -> torch.Tensor:
        """The standard normals ``[ny, nx]`` that the noise of global step
        ``step`` (default: the next step) draws, on the model's device
        (:func:`~lb2d_tpu_torch.ops.random.normals`; on CUDA the P1 kernel).
        """
        if not self.noisy:
            raise ValueError(f"{type(self).__name__} draws no noise")
        step = self.steps_taken if step is None else step
        return normals(self.rng_seed, step, (self.ny, self.nx), self.device)

    @traced_field
    def device_field(self, name):
        """``"rho"`` as a device tensor ``[ny, nx]`` (no host copy)."""
        if name == "rho":
            return density(self.state)
        return None

    # -- getters (diffusion.py:385-432) ---------------------------------------
    @traced("lb2d.readout.get_fields")
    def get_fields(self) -> dict:
        """``f``, ``feq``, ``rho`` and the imposed ``u``, ``v`` in LB units,
        as numpy arrays indexed ``[x, y]`` (``f``/``feq`` as ``[9, nx,
        ny]``), the reference layout."""
        f = self.state
        rho = density(f)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq_linear(rho, self.u, self.v)),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(self.u.expand(rho.shape)),
            "v": self._to_host_xy(self.v.expand(rho.shape)),
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


class Diffusion(PeriodicScalarModel):
    """Pure diffusion of an initially-Gaussian density blob
    (``diffusion.py:56-185``): characteristic scales L = z, T = z^2/D so the
    dimensionless diffusivity is 1; ``D_lb = dt/dx^2``,
    ``omega = (0.5 + D_lb/cs^2)^-1``.

    Arguments as in the JAX class, plus ``backend`` and ``device`` (default
    ``"cuda"``; a machine without CUDA raises).
    """

    def __init__(self, Lx=1.0, Ly=1.0, D=1.0, z=0.1, time_prefactor=1.0,
                 N=50, seed=0, dtype=torch.float32, backend="auto",
                 device="cuda"):
        self.phys_Lx, self.phys_Ly = Lx, Ly
        self.phys_D, self.phys_z = D, z
        self.N = N
        self.time_prefactor = time_prefactor
        self.lattice = D2Q9
        self.dtype = dtype
        self.device = resolve_device(device)

        self.set_characteristic_length_time()
        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        self.set_D_and_omega()
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")

        # grid (diffusion.py:188-198): +2 boundary ring, int() truncation
        self.lx = self.N * int(self.phys_Lx / self.L)
        self.ly = self.N * int(self.phys_Ly / self.L)
        self.nx, self.ny = self.lx + 2, self.ly + 2

        self._init_velocity()
        self._setup(self._initial_rho(), seed, backend)

    # -- scaling hooks ---------------------------------------------------------
    def set_characteristic_length_time(self):
        self.L = self.phys_z
        self.T = self.phys_z**2 / self.phys_D

    def set_D_and_omega(self):
        # diffusion.py:168-174
        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)

    def _init_velocity(self):
        self._set_velocity(0.0, 0.0)

    def _initial_rho(self) -> np.ndarray:
        """Gaussian blob in dimensionless coordinates (diffusion.py:258-280),
        centered at (nx//2, ny//2)."""
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / self.N
        Yd = (Y - self.ny // 2) / self.N
        return np.exp(-(Xd**2 + Yd**2)).astype(np.float32)  # [ny, nx]


class AdvectionDiffusion(Diffusion):
    """Diffusion in a uniform imposed flow (``diffusion.py:433-481``):
    L = z, T = z/vc, Peclet Pe = z vc / D, ``D_lb = (dt/dx^2)/Pe``,
    imposed lattice velocity ``(dt/dx) * v_phys/vc``."""

    def __init__(self, vx=1.0, vy=1.0, vc=1.0, **kwargs):
        self.phys_vx, self.phys_vy, self.phys_vc = vx, vy, vc
        self.Pe = None
        super().__init__(**kwargs)

    def set_characteristic_length_time(self):
        self.L = self.phys_z
        self.T = self.phys_z / self.phys_vc

    def set_D_and_omega(self):
        self.Pe = self.phys_z * self.phys_vc / self.phys_D
        self.lb_D = (self.delta_t / self.delta_x**2) / self.Pe
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)

    def _init_velocity(self):
        self._set_velocity(self.ulb * self.phys_vx / self.phys_vc,
                           self.ulb * self.phys_vy / self.phys_vc)


class ReactionDiffusion(Diffusion):
    """Fisher wave: diffusion + logistic growth ``G rho (1 - rho)``
    (``diffusion.py:482-519``; source formula ``D2Q9_diffusion.cl:112-121``).
    ``G_lb = (T g) * dt``."""

    def __init__(self, g=1.0, **kwargs):
        self.g = g
        super().__init__(**kwargs)

    def set_D_and_omega(self):
        super().set_D_and_omega()
        self.G_dim = self.T * self.g
        self.G = self.G_dim * self.delta_t

    def _lb_G(self):
        return self.G


class ReactionAdvectionDiffusion(AdvectionDiffusion):
    """Fisher wave advected by a uniform flow (``diffusion.py:521-553``);
    dimensionless Fisher speed ``v_f = 2 sqrt(G_dim / Pe)``
    (``diffusion.py:542``)."""

    def __init__(self, g=1.0, **kwargs):
        self.g = g
        super().__init__(**kwargs)

    def set_D_and_omega(self):
        super().set_D_and_omega()
        self.G_dim = self.T * self.g
        self.G = self.G_dim * self.delta_t
        self.vf_dim = 2.0 * np.sqrt(self.G_dim / self.Pe)

    def _lb_G(self):
        return self.G


class ReactionAdvectionDiffusionStochastic(ReactionAdvectionDiffusion):
    """Stochastic Fisher wave: adds ``sqrt(Dg rho (1-rho)) eta`` per cell with
    fresh normals every step and clips negative populations to zero
    (``D2Q9_diffusion.cl:126-167``). ``Dg`` is the lattice-units noise
    amplitude, unconverted, as in JAX (``diffusion.py:26-29``).

    ``state`` is the populations tensor; the noise is keyed by
    ``rng_seed`` and ``steps_taken`` (see the module docstring).
    """

    noisy = True

    def __init__(self, Dg=1.0, rng_seed=0, **kwargs):
        self.Dg = Dg
        self.rng_seed = int(rng_seed)
        super().__init__(**kwargs)

    def _lb_Dg(self):
        return self.Dg
