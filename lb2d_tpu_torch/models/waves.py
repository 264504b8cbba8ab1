"""Coupled Fisher-wave models (counterpart of ``lb2d_tpu.models.waves``).

* :class:`NoisyAdvectedFisherWave`: the stochastic Fisher wave (K2 / K3).
* :class:`ScreenedFisherWave`: a Fisher wave advected by the negative
  gradient of the screened-Poisson potential of its own density, re-solved
  every step (K8 and K7 ``screened_fisher`` on CUDA), and the machinery the
  coupled families share: the per-step screened velocity
  (:class:`_ScreenedVelocity`) and the backends and run loop
  (:class:`CoupledModel`), which ``models/surfactant.py`` and
  ``models/rocket_yeast.py`` use too.
* :class:`RepellingFisherWave`: a Fisher wave advected by the negative
  gradient of the LBM-Poisson potential of its own density, solved inside
  every outer step (:mod:`lb2d_tpu_torch.models.poisson`), or amortized by
  a drift test or a fixed inner budget.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops import _build
from ..ops.collide import bgk
from ..ops.equilibrium import feq_linear
from ..ops.fused_coupled import (
    COUPLED_TEMPORAL_K,
    CoupledConfig,
    coupled_density,
    coupled_max_k,
    coupled_params,
    coupled_step_reference,
    coupled_sweep,
    density_in_order,
    rocket_yeast_step_reference,
    screened_fisher_step_reference,
    surfactant_step_reference,
    _coupled_cell_step,
)
from ..ops.moments import density, rho_poisson
from ..ops.spectral import screened_gradients, screened_gradients_reference
from ..ops.stream import stream
from ..utils.metrics import mach_number
from ..utils.tracing import traced, traced_field
from .base import (
    LBModel,
    graph_in_place,
    held_solve_sweep,
    plain_backend,
    resolve_device,
)
from .diffusion import PeriodicScalarModel
from .poisson import (
    PoissonSolver,
    _make_poisson_iter,
    _poisson_run,
    negative_gradient,
)

__all__ = ["NoisyAdvectedFisherWave", "ScreenedFisherWave",
           "RepellingFisherWave", "CoupledModel"]

_BACKENDS = ("auto", "kernel", "eager")
_SOLVE_METHODS = ("auto", "pallas", "matmul", "fft")
_PRECISIONS = ("highest", "bf16x3")


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


class _ScreenedVelocity:
    """Per-step screened-Poisson velocity: ``(u, v) = -vc (dt/dx) grad
    screen(rho)`` with the reference's frequency conventions
    (``screened_poisson_waves.py:337-361``; ``lb2d_tpu/models/waves.py:
    207-321``): the integer ``fftfreq(n) n`` grids, Nyquist-zeroed
    gradient multipliers, ``lam2`` and ``scale = -vc ulb`` in float32.

    The solve runs through K8
    (:func:`~lb2d_tpu_torch.ops.spectral.screened_gradients`: the kernel on
    CUDA, its plain version on the CPU), or, with ``plain`` (a model's
    ``backend="eager"``) or ``method="fft"``, the plain ``torch.fft`` solve
    by name. ``method`` ``"auto"``, ``"pallas"`` and ``"matmul"`` (the
    JAX solve's choices) all take K8. ``mm`` (``"highest"`` or
    ``"bf16x3"``, the TPU's matmul modes) is accepted and runs the same
    float32 kernel. ``ny``, ``nx`` and ``delta_x`` are the JAX signature's:
    the grids follow from ``rho``'s shape, and ``(n dx) fftfreq(n, dx)`` is
    the integer grid at any dx."""

    def __init__(self, ny, nx, lam, delta_x, vc, ulb, method="auto",
                 mm="highest", plain=False):
        if method not in _SOLVE_METHODS:
            raise ValueError(f"unknown method {method!r}; use one of "
                             f"{', '.join(_SOLVE_METHODS)}")
        if mm not in _PRECISIONS:
            raise ValueError(f"unknown precision {mm!r}; use 'highest' or "
                             "'bf16x3'")
        self._lam2 = np.float32(lam * lam)
        self.scale = np.float32(-vc * ulb)
        self.method = method
        self.mm = mm
        self.plain = bool(plain) or method == "fft"

    def _solve(self, rho, out_scale, out=None):
        if self.plain:
            planes = screened_gradients_reference(rho, self._lam2,
                                                  out_scale=out_scale)
            return planes if out is None else out.copy_(planes)
        return screened_gradients(rho, self._lam2, out=out,
                                  out_scale=out_scale)

    def planes(self, rho, out=None):
        """``stack(u, v)`` ``[2, ny, nx]``, into ``out`` if given."""
        return self._solve(rho, self.scale, out)

    def ext_planes(self, rho, amp, out=None):
        """``stack(amp u, amp v)`` ``[2, ny, nx]``: the multicomponent
        engine's external-force hand-off, the scale ``amp scale`` fused
        into K8's last write (``waves.py:261-283``)."""
        if self.plain:
            ux, uy = self(rho)
            planes = torch.stack((amp * ux, amp * uy))
            return planes if out is None else out.copy_(planes)
        return self._solve(rho, float(amp) * float(self.scale), out)

    def __call__(self, rho):
        u_v = self.planes(rho)
        return u_v[0], u_v[1]


class CoupledModel(LBModel):
    """Backends and the run loop of the coupled families (K7, with K8 for
    the spectral velocity).

    Subclasses set ``nx``, ``ny``, ``dtype``, ``device``, ``lattice``,
    ``stale_velocity``, ``backend`` (:meth:`_pick_backend`), the velocity
    solve ``_velocity`` (a :class:`_ScreenedVelocity` built with
    ``plain=self.backend == "eager"``, or None for rocket yeast) and the
    state, implement :meth:`coupled_config`, and call
    :meth:`_finish_setup`.

    Backends: ``"kernel"`` (CUDA, float32): K7
    (:func:`~lb2d_tpu_torch.ops.fused_coupled.coupled_sweep`), K steps per
    launch with the densities computed inside. The rocket yeasts run
    ``COUPLED_TEMPORAL_K`` steps a launch (``steps_per_call``): ``run(n)``
    is ``n // K`` launches and one of the ``n % K`` steps left, and no
    density pass. The screened families run, per sweep of
    ``stale_velocity`` steps, K6's density pass
    (:func:`~lb2d_tpu_torch.ops.fused_coupled.coupled_density`), the K8
    solve of the population's density into two ext planes, and K7 launches
    of at most ``COUPLED_TEMPORAL_K`` steps with the planes held (a sweep
    of one step: K7's one-step kernel on the solve's densities,
    :func:`~lb2d_tpu_torch.ops.fused_coupled._coupled_cell_step`).
    ``"eager"``: the plain step with the plain ``torch.fft`` solve (the CPU
    default; on CUDA only by name); ``"auto"``: ``"kernel"`` on CUDA,
    ``"eager"`` on the CPU. Off CUDA ``"kernel"`` raises; so do
    ``"kernel"`` and ``"auto"`` on CUDA with another dtype than float32,
    naming ``backend="eager"``.

    ``stale_velocity = K > 1`` (the screened families): one solve per K-step
    sweep, from the sweep's first post-stream density, held for the sweep
    (:func:`~lb2d_tpu_torch.models.base.held_solve_sweep` on the eager
    backend); ``run(n)`` runs ``n // K`` sweeps, then the rest as exact
    single steps, on both backends. JAX demotes K to a depth its VMEM
    tiling holds; the port does not.
    """

    POP = 0
    _velocity = None
    stale_velocity = 1

    def coupled_config(self) -> CoupledConfig:
        raise NotImplementedError

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    def _pick_backend(self, backend):
        backend = plain_backend(backend)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use 'auto', "
                             "'kernel' or 'eager'")
        if backend == "eager":
            return backend
        if self.device.type != "cuda":
            if backend == "auto":
                return "eager"
            raise ValueError(f"backend={backend!r} runs a CUDA kernel and "
                             f"needs a CUDA device, not {self.device}")
        if self.dtype != torch.float32:
            raise ValueError(f"the coupled kernel is float32 only, not "
                             f"{self.dtype}; pass backend='eager' to run the "
                             "plain PyTorch step on the card")
        return "kernel"

    def _finish_setup(self):
        self.stale_velocity = int(self.stale_velocity)
        if self.stale_velocity < 1:
            raise ValueError(f"stale_velocity must be >= 1, got "
                             f"{self.stale_velocity}")
        if self.backend == "kernel":
            _build.load_library()  # build now, outside any timed region
        LBModel.__init__(self)

    def _fields4(self, f):
        """The state as ``[9, F, ny, nx]`` (a view)."""
        return f.view(9, -1, self.ny, self.nx)

    def _plain_step(self, cfg):
        """The exact plain step ``f -> f`` (JAX's XLA step)."""
        if self._velocity is None:
            return lambda f: rocket_yeast_step_reference(f, cfg)
        step = (screened_fisher_step_reference
                if cfg.physics == "screened_fisher"
                else surfactant_step_reference)
        return lambda f: step(f, cfg, velocity=self._velocity)

    def make_step(self):
        cfg = self.coupled_config()
        if self.backend == "kernel":
            steps = self._kernel_steps(cfg)
            if self._velocity is None:  # local: K steps a launch, any n
                K = min(COUPLED_TEMPORAL_K[cfg.physics], coupled_max_k(cfg))
                self._run_n = steps
            else:
                K = self.stale_velocity
            single = lambda f: steps(f, 1)  # noqa: E731
        else:
            K = self.stale_velocity if self._velocity is not None else 1
            single, steps = self._eager_steps(cfg)
        self.steps_per_call = K
        self._single_step = single
        return (lambda f: steps(f, K)) if K > 1 else single

    def _held_planes(self, cfg):
        """The velocity planes a sweep holds, or None."""
        if not cfg.reads_ext:
            return None
        return torch.empty((2, self.ny, self.nx), dtype=self.dtype,
                           device=self.device)

    def _eager_steps(self, cfg):
        """The plain path's exact step and sweep ``(f, n) -> f``: the sweep
        solves from its first post-stream density."""
        ext = self._held_planes(cfg)

        def steps(f, n):
            return held_solve_sweep(
                f, n, lambda f, rho: coupled_step_reference(f, cfg, ext),
                lambda f: density_in_order(stream(self._fields4(f),
                                                  self.lattice)),
                lambda rho: self._velocity.planes(rho[self.POP], out=ext))

        return self._plain_step(cfg), steps

    def _kernel_steps(self, cfg):
        """The kernel path's ``steps(f, n) -> f``: one solve (the screened
        families), then K7 launches of at most ``COUPLED_TEMPORAL_K``
        steps, the velocity planes held."""
        like = dict(dtype=self.dtype, device=self.device)
        spare = [torch.empty((9, cfg.fields, self.ny, self.nx), **like)]
        ext = self._held_planes(cfg)
        rho = (torch.empty((cfg.fields, self.ny, self.nx), **like)
               if ext is not None else None)
        prm = coupled_params(cfg)
        cap = min(COUPLED_TEMPORAL_K[cfg.physics], coupled_max_k(cfg))

        def steps(f, n):
            f4 = self._fields4(f)
            if ext is not None:
                coupled_density(f4, rho)
                self._velocity.planes(rho[self.POP], out=ext)
            if ext is not None and n == 1:
                # the solve's densities are the step's: the one-step kernel
                out = _coupled_cell_step(f4, spare[0], rho, ext, cfg, prm)
                spare[0], f4 = f4, out
                n = 0
            while n > 0:
                k = min(cap, n)
                out = coupled_sweep(f4, spare[0], ext, cfg, k, prm)
                spare[0], f4 = f4, out
                n -= k
            return f4.view(f.shape)

        return steps

    def mach_number(self) -> float:
        u, v = self._velocity_fields()
        return mach_number(u, v, self.lattice)

    def _velocity_fields(self):
        rho = self._fields4(self.state).sum(dim=0)
        return self._velocity(rho[self.POP])


class ScreenedFisherWave(CoupledModel):
    """Self-repelling Fisher wave (``screened_poisson_waves.py:55-448``):
    dimensionless units (L = T = 1), D = 1/4, G = 1; each step re-solves the
    screened Poisson equation of the post-stream density for the advection
    velocity. State ``f[9, ny, nx]``.

    Arguments as in the JAX class (``check_max_ulb`` and ``mach_tolerance``
    are stored, as there; :meth:`mach_number` reads the Mach number;
    ``solve_precision`` goes to the solve's ``mm``), plus ``backend`` and
    ``device`` (:class:`CoupledModel`)."""

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, lam=1.0, R0=5.0,
                 time_prefactor=1.0, N=50, seed=0, check_max_ulb=False,
                 mach_tolerance=0.1, dtype=torch.float32, method="auto",
                 stale_velocity=1, solve_precision="highest", backend="auto",
                 device="cuda"):
        self.stale_velocity = stale_velocity
        self.Lx, self.Ly = Lx, Ly
        self.D, self.G = 1.0 / 4.0, 1.0
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
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")
        self.lb_G = np.float32(self.G * self.delta_t)

        # grid round(N L), no boundary ring (screened_poisson_waves.py:139-141)
        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        self.backend = self._pick_backend(backend)
        self._velocity = _ScreenedVelocity(
            self.ny, self.nx, lam, self.delta_x, vc, self.ulb, method,
            mm=solve_precision, plain=self.backend == "eager")

        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        rho0 = torch.tensor(np.exp(-(Xd**2 + Yd**2) / R0**2), dtype=dtype,
                            device=self.device)
        self.state = self._state_from_rho(rho0)
        self._finish_setup()

    def coupled_config(self) -> CoupledConfig:
        return CoupledConfig("screened_fisher", omega=float(self.omega),
                             lb_G=float(self.lb_G))

    def _state_from_rho(self, rho):
        u, v = self._velocity(rho)
        return feq_linear(rho, u, v, self.lattice).contiguous()

    def redo_initial_condition(self, rho_field):
        """Re-seed from a user density ``[ny, nx]``
        (``screened_poisson_waves.py:275-282``)."""
        self.state = self._state_from_rho(torch.as_tensor(
            np.asarray(rho_field), dtype=self.dtype, device=self.device))
        return self

    @traced_field
    def device_field(self, name):
        if name == "rho":
            return density(self.state)
        return None

    @traced("lb2d.readout.get_fields")
    def get_fields(self):
        f = self.state
        rho = density(f)
        u, v = self._velocity(rho)
        feq = feq_linear(rho, u, v, self.lattice)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(u),
            "v": self._to_host_xy(v),
        }


class RepellingFisherWave(LBModel):
    """Fisher wave repelled by its own LBM-Poisson potential
    (``repelling_fisher_waves_old.py:55-477``): each outer step re-solves the
    Poisson equation with source rho (to ``max_inner_iter`` iterations or
    convergence, warm-started from the previous potential) and advects with
    ``E (dt/dx) * (u, v)`` of its negative gradient (``:380-392``).

    Arguments as in the JAX class (``seed`` is accepted and unused there
    too: the Poisson solver draws its perturbation with seed 0), plus
    ``device``. The state is JAX's 5-tuple ``(f, poisson f, raw gradient u,
    v, rho at the last solve)``; the raw gradient is carried unscaled
    (``DIVERGENCES.md`` #5). Three modes:

    * exact (the default): a converge-to-tolerance solve every outer step;
    * gated, ``reuse_tolerance > 0``: the potential is reused while
      ``mean|rho - rho_at_last_solve| <= reuse_tolerance * mean(rho)``;
    * tracking, ``inner_per_step = k``: the potential is converged once at
      construction, then every outer step runs exactly ``k`` inner
      iterations and refreshes the gradient. Excludes ``reuse_tolerance``.
      Its lag grows with N at fixed k (see the JAX class).

    Host reads of device values per outer step on CUDA (``host_reads``
    counts them): exact, one per block of the solve,
    ``ceil(iterations / check_every)`` (check_every 10, so at most
    ``ceil(max_inner_iter / 10)``); gated, one for the drift test (JAX's
    ``lax.cond``) plus, on a step that solves, the solve's; tracking, none:
    its whole outer step is one CUDA graph, replayed ``n`` times by
    ``run(n)``. The solve's blocks are CUDA graphs in the exact and gated
    modes (:class:`lb2d_tpu_torch.models.poisson._PoissonLoop`); the rest
    of their outer step runs eagerly. On the CPU everything runs eagerly.
    """

    def __init__(self, Lx=1.0, Ly=1.0, vc=1.0, E=1.0, R0=5.0,
                 time_prefactor=1.0, N=50, max_inner_iter=200,
                 inner_tolerance=1e-5, seed=0, dtype=torch.float32,
                 reuse_tolerance=0.0, inner_per_step=None, device="cuda"):
        self.D, self.G = 1.0 / 4.0, 1.0
        self.E = E
        self.R0 = R0
        self.N = N
        self.lattice = D2Q9
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_inner_iter = max_inner_iter
        self.reuse_tolerance = float(reuse_tolerance)
        self.inner_per_step = None if inner_per_step is None else int(
            inner_per_step)
        if self.inner_per_step is not None:
            if self.inner_per_step < 1:
                raise ValueError("inner_per_step must be >= 1")
            if reuse_tolerance != 0.0:
                raise ValueError(
                    "inner_per_step (tracking) and reuse_tolerance (gated) "
                    "are mutually exclusive amortization modes")

        self.delta_x = 1.0 / N
        self.delta_t = time_prefactor * self.delta_x**2
        self.ulb = self.delta_t / self.delta_x
        self.lb_D = np.float32(self.D * self.delta_t / self.delta_x**2)
        self.omega = np.float32(1.0 / (0.5 + self.lb_D / self.lattice.cs2))
        self.lb_G = np.float32(self.G * self.delta_t)

        self.nx = int(np.round(N * Lx))
        self.ny = int(np.round(N * Ly))

        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        Xd = (X - self.nx // 2) / N
        Yd = (Y - self.ny // 2) / N
        rho0 = torch.tensor(np.exp(-(Xd**2 + Yd**2) / R0**2), dtype=dtype,
                            device=self.device)

        self.poisson = PoissonSolver(
            nx=self.nx, ny=self.ny, sources=rho0, delta_t=self.delta_t,
            delta_x=self.delta_x, tolerance=inner_tolerance, dtype=dtype,
            device=self.device)

        zero = torch.zeros((self.ny, self.nx), dtype=dtype, device=self.device)
        if self.inner_per_step is not None:
            # tracking: converge the potential of the initial density once,
            # then take its gradient whether or not the run converged
            self.poisson.run(max_inner_iter)
            pu0, pv0 = negative_gradient(self.poisson.rho, self.delta_x)
        else:
            pu0, pv0 = zero.clone(), zero.clone()
        # the 5th member: the density at the last solve (the gated mode's
        # drift reference; -1 forces the first step to solve)
        self.state = (feq_linear(rho0, zero, zero, self.lattice),
                      self.poisson.f, pu0, pv0,
                      torch.full((self.ny, self.nx), -1.0, dtype=dtype,
                                 device=self.device))
        self._drift_reads = self._replays = 0
        self._graph = self._static = None
        super().__init__()

    @property
    def num_cells(self):
        return self.nx * self.ny

    @property
    def host_reads(self) -> int:
        """Host reads of device values so far: the solve's convergence flags
        and the gated mode's drift tests."""
        return self.poisson._loop.reads + self._drift_reads

    @property
    def graph_replays(self) -> int:
        """CUDA-graph replays so far: the solve's blocks and the tracking
        mode's outer steps."""
        return self.poisson._loop.replays + self._replays

    @property
    def inner_iterations(self) -> int:
        """Iterations that the Poisson solves' converge loop ran so far (the
        tracking mode's fixed ``k`` per step run outside it)."""
        return self.poisson._loop.iterations

    def make_step(self):
        lat = self.lattice
        kw = dict(dtype=self.dtype, device=self.device)
        omega = torch.tensor(self.omega, **kw)
        w = torch.tensor(lat.w_np(), **kw)[:, None, None]
        G = float(self.lb_G)
        consts = self.poisson._consts()
        source_scale = np.float32(self.poisson.lb_D * self.poisson.delta_t)
        max_iter = self.max_inner_iter
        scale = float(np.float32(self.E * self.ulb))
        n_cells = self.num_cells

        def collide(f, rho, pu, pv):
            feq = feq_linear(rho, scale * pu, scale * pv, lat)
            growth = G * rho * (1.0 - rho)
            return bgk(f, feq, omega) + w * growth

        if self.inner_per_step is not None:
            # tracking: k fixed inner iterations per outer step, with the
            # second source-scaling stage of _poisson_run (DIVERGENCES #8)
            piter = _make_poisson_iter(consts)
            react_scale = float(source_scale * np.float32(consts["delta_t"])
                                * np.float32(consts["lb_D"]))
            k_inner = self.inner_per_step
            dx = float(np.float32(consts["delta_x"]))

            def step(state):
                f, pf, pu, pv, rho_ref = state
                f = stream(f, lat)
                rho = density(f)
                react = rho * react_scale
                for _ in range(k_inner):
                    pf, prho = piter(pf, react)
                pu, pv = negative_gradient(prho, dx)
                return (collide(f, rho, pu, pv), pf, pu, pv, rho)

            if self.device.type == "cuda":
                self._run_n = self._replay_run
            return step

        loop = self.poisson._loop
        ss = float(source_scale)
        reuse_tol = float(np.float32(self.reuse_tolerance))
        use_reuse = self.reuse_tolerance > 0.0

        def solve(rho, pf, pu, pv):
            # warm-started from the previous potential; it0 = 0 on every
            # solve, as JAX passes it (waves.py:674-676)
            pf, _, pu, pv, _, _ = _poisson_run(
                consts, pf, rho_poisson(pf, lat), pu, pv, rho * ss, 0,
                max_iter, loop=loop)
            return pf, pu, pv

        def step(state):
            f, pf, pu, pv, rho_ref = state
            f = stream(f, lat)
            rho = density(f)
            if use_reuse:
                drift = torch.sum(torch.abs(rho - rho_ref)) / n_cells
                need = drift > reuse_tol * (torch.sum(rho) / n_cells)
                self._drift_reads += 1
                if bool(need):
                    pf, pu, pv = solve(rho, pf, pu, pv)
                    rho_ref = rho
            else:
                pf, pu, pv = solve(rho, pf, pu, pv)
                rho_ref = rho
            return (collide(f, rho, pu, pv), pf, pu, pv, rho_ref)

        return step

    def _replay_run(self, state, n):
        """Tracking mode on CUDA: ``n`` replays of the outer step captured
        as one CUDA graph on buffers of the model's own (the state is copied
        in when it is not already them); returns those buffers."""
        if self._graph is None:
            self._static = tuple(t.clone() for t in state)
            self._graph = graph_in_place(lambda *s: self._step(s),
                                         self._static, self._static)
        for buf, t in zip(self._static, state):
            if buf is not t:
                buf.copy_(t)
        for _ in range(n):
            self._graph.replay()
        self._replays += n
        return self._static

    @traced("lb2d.readout.get_fields")
    def get_fields(self):
        f, pf, pu, pv, _ = self.state
        rho = density(f)
        scale = float(self.E * self.ulb)
        return {
            "f": self._to_host_xy(f),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(scale * pu),
            "v": self._to_host_xy(scale * pv),
        }
