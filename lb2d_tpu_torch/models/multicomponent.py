"""Multicomponent / multiphase / porous-media engine (counterpart of
``lb2d_tpu.models.multicomponent``).

* :class:`Fluid`: per-component parameters (porosity ``epsilon``, effective
  viscosity ``nu_e`` -> tau / omega, fluid viscosity, permeability ``K``,
  Forchheimer ``Fe``, edge condition) and the initial state.
* :class:`SimulationRunner`: owns the state ``f[q, C, ny, nx]`` and the
  reference's registry of force and collision hooks, kept as descriptors in
  registration order (:class:`~lb2d_tpu_torch.ops.fused_mc.MCKernelConfig`).

The step, its formulas and its order are the JAX module's (see its
docstring and :func:`~lb2d_tpu_torch.ops.fused_mc.mc_step_reference`). The
step's plain pieces (``SECOND_BELT_STENCIL``, :func:`get_psi`, the shift
and the zero-gradient edges) live in ``ops/fused_mc.py``, which the kernel
wrappers share; the first two are re-exported here, where the JAX package
keeps them.

Backends:

* ``"kernel"``: K6 (``csrc/mc_step.cu``), one step per launch, on D2Q9 and
  D2Q25, any grid of at least 3 x 3, zero-gradient edges, clamped
  interaction neighbours and the radial g force included, for up to
  ``MAX_MC_FLUIDS`` (4) fluids, ``MAX_MC_HOOKS`` (16) force hooks and
  ``MAX_MC_COLLISIONS`` (8) collision hooks, float32.
* ``"eager"``: the plain PyTorch step; the CPU default, on CUDA only when
  asked for by name. It honours ``dtype=torch.float64`` (JAX runs that with
  ``jax_enable_x64``).
* ``"auto"``: ``"kernel"`` on CUDA, ``"eager"`` on the CPU. Nothing falls
  back silently: on CUDA a configuration the kernel does not hold raises a
  ``ValueError`` that names ``backend="eager"``.

The screened-Poisson repulsion (``add_screened_poisson_force``) is solved
on the fluid's post-stream, post-BC density: on the kernel path each step is
``mc_density``, K8 (:func:`~lb2d_tpu_torch.ops.spectral.screened_gradients`)
writing ``amplitude (xg, yg)`` into the hook's ext plane pair, then
``mc_step``, which reads that pair as any ext hook. ``stale_force=K`` solves
once per K-step sweep and holds the force for the sweep (both backends;
``run`` runs the rest of ``n`` as exact single steps).

``shard_over(mesh)`` cuts the runner into the shards of a
:class:`~lb2d_tpu_torch.parallel.Mesh`
(:class:`~lb2d_tpu_torch.parallel.sharded.ShardedRunner`): each step runs
K6h, K6's kernels on a shard and its halo, with K8 once per device on the
gathered source density; ``run``, the getters, ``check_fields`` and the state
transfer then work on the shards.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import D2Q9, D2Q25, Lattice
from ..ops import _build
from ..ops.fused_mc import (
    MAX_MC_FLUIDS,
    SECOND_BELT_STENCIL,
    FluidParams,
    MCKernelConfig,
    get_psi,
    mc_density,
    mc_density_reference,
    mc_params,
    mc_step,
    mc_step_reference,
)
from ..ops.spectral import screened_gradients, screened_gradients_reference
from ..utils.metrics import accumulated_sum
from ..utils.tracing import traced
from .base import advance, held_solve_sweep, plain_backend, resolve_device

__all__ = ["Fluid", "SimulationRunner", "SECOND_BELT_STENCIL", "get_psi",
           "pick_backend"]

ZERO_DENSITY_POROUS = 1e-6   # single_component.cl:9
ZERO_DENSITY_MULTI = 1e-12   # multi.cl:9
_BACKENDS = ("auto", "kernel", "eager")
_PSI_NAMES = {"linear": 0, "shan_chen": 1, "pow": 2, "vdw": 3}


def pick_backend(backend, device, dtype, num_populations) -> str:
    """The backend a runner on ``device`` with ``dtype`` and
    ``num_populations`` fluids runs: ``"kernel"`` or ``"eager"``. Raises
    rather than fall back: ``"kernel"`` off CUDA, and ``"kernel"`` or
    ``"auto"`` on CUDA for a configuration K6 does not take. JAX's name
    ``"xla"`` is read as ``"eager"``."""
    backend = plain_backend(backend)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use 'auto', 'kernel' "
                         "or 'eager'")
    if backend == "eager":
        return backend
    device = torch.device(device)
    if device.type != "cuda":
        if backend == "auto":
            return "eager"
        raise ValueError(f"backend={backend!r} runs a CUDA kernel and needs a "
                         f"CUDA device, not {device}")
    if dtype != torch.float32:
        raise ValueError(f"the multicomponent kernel is float32 only, not "
                         f"{dtype}; pass backend='eager' to run the plain "
                         "PyTorch step on the card")
    if num_populations > MAX_MC_FLUIDS:
        raise ValueError(f"the multicomponent kernel takes at most "
                         f"{MAX_MC_FLUIDS} fluids, not {num_populations}; pass "
                         "backend='eager' to run the plain PyTorch step on "
                         "the card")
    return "kernel"


class Fluid:
    """Per-component configuration and initial state (mirrors
    ``Pourous_Media``, ``single_component.py:46-107``). ``epsilon = 1`` and
    ``porous=False`` on the runner give the plain multicomponent fluid."""

    def __init__(self, sim, field_index, nu_e=1.0, epsilon=1.0, nu_fluid=1.0,
                 K=1.0, Fe=1.0, bc="periodic"):
        if bc not in ("periodic", "zero_gradient"):
            raise ValueError(f"bc must be 'periodic' or 'zero_gradient', not "
                             f"{bc!r}")
        self.sim = sim
        self.field_index = int(field_index)
        self.lb_nu_e = nu_e
        self.epsilon = epsilon
        self.nu_fluid = nu_fluid
        self.K = K
        self.Fe = Fe
        self.bc = bc
        self.tau = 0.5 + nu_e / sim.lattice.cs2
        self.omega = 1.0 / self.tau
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")

    def initialize(self, rho_arr, f_amp=0.0, seed=None):
        """Install the initial density ``rho_arr`` (``[ny, nx]``; pass the
        reference's (nx, ny) transposed) and set this fluid's f to
        ``feq(rho, u_bary)``, times ``1 + f_amp * randn`` from numpy
        ``RandomState(seed)`` (default seed ``7 (i + 1)``), as JAX does
        (``single_component.py:70-107``)."""
        sim = self.sim
        i = self.field_index
        like = dict(dtype=sim.dtype, device=sim.device)
        rho = torch.tensor(np.asarray(rho_arr), **like)
        sim.rho[i] = rho
        feq = sim._feq_single(rho, sim.u_bary, sim.v_bary, self.epsilon)
        if f_amp:
            rng = np.random.RandomState(
                seed if seed is not None else 7 * (i + 1))
            feq = feq * torch.tensor(
                1.0 + f_amp * rng.randn(sim.lattice.q, sim.ny, sim.nx), **like)
        sim.f[:, i] = feq


class SimulationRunner:
    """The orchestrator (``single_component.py:245-766``,
    ``multi.py:226-818``).

    Arguments as in the JAX class, plus ``device`` (default ``"cuda"``; a
    machine without CUDA raises). ``dtype`` defaults to float32 (JAX picks
    float64 when ``jax_enable_x64`` is on). Hooks are registered before the
    first ``run``.
    """

    def __init__(self, nx=100, ny=100, L_lb=100, T_lb=1.0, num_populations=1,
                 porous=True, lattice: Lattice = D2Q9, dtype=None,
                 check_max_ulb=False, mach_tolerance=0.1, backend="auto",
                 stale_force=None, device="cuda"):
        self.nx, self.ny = int(nx), int(ny)
        self.L_lb, self.T_lb = L_lb, T_lb
        self.delta_x = 1.0 / L_lb
        self.delta_t = 1.0 / T_lb
        self.num_populations = int(num_populations)
        self.porous = porous
        if lattice not in (D2Q9, D2Q25):
            raise ValueError(f"lattice must be D2Q9 or D2Q25, not {lattice}")
        self.lattice = lattice
        self.dtype = torch.float32 if dtype is None else dtype
        self.device = resolve_device(device)
        self.zero_density = (ZERO_DENSITY_POROUS if porous
                             else ZERO_DENSITY_MULTI)
        self.check_max_ulb = check_max_ulb
        self.mach_tolerance = mach_tolerance
        # stale_force=K: the screened-Poisson force is solved once per K-step
        # sweep and held for it (None: every step, the reference's coupling)
        self.stale_force = None if stale_force in (None, 0, 1) \
            else int(stale_force)
        self.backend = pick_backend(backend, self.device, self.dtype,
                                    self.num_populations)
        if self.backend == "kernel":
            _build.load_library()  # build now, outside any timed region

        C, q = self.num_populations, lattice.q
        like = dict(dtype=self.dtype, device=self.device)
        self._sharded = None
        self.rho = torch.zeros((C, self.ny, self.nx), **like)
        self.u_bary = torch.zeros((self.ny, self.nx), **like)
        self.v_bary = torch.zeros((self.ny, self.nx), **like)
        self.f = torch.zeros((q, C, self.ny, self.nx), **like)

        self.fluid_list: list[Fluid] = []
        self._hooks = []          # force hooks in registration order
        self._collisions = []     # collision hooks in registration order
        self._ext_planes = []     # (fx, fy) numpy float64 per "ext" hook,
        # None for a "screened" hook (its pair is solved every step or sweep)
        self._plan = None         # (cfg, ext, K6 params) built at first run
        self._spare = self._rho_buf = None
        self._hydro_step = None   # steps_taken of the gathered hydro fields
        self.backend_used = None
        self.steps_per_call = 1   # K6 runs one step per launch
        self.steps_taken = 0
        self.last_mlups = None

    # ---- setup ---------------------------------------------------------------
    def add_fluid(self, fluid: Fluid):
        self.fluid_list.append(fluid)
        self._plan = None

    def complete_setup(self):
        if len(self.fluid_list) != self.num_populations:
            raise ValueError(f"{len(self.fluid_list)} fluids added, "
                             f"num_populations is {self.num_populations}")
        self.tau_arr = np.array([fl.tau for fl in self.fluid_list])

    def set_bary_velocity(self, u_bary, v_bary):
        like = dict(dtype=self.dtype, device=self.device)
        self.u_bary = torch.tensor(np.asarray(u_bary), **like)
        self.v_bary = torch.tensor(np.asarray(v_bary), **like)

    # ---- registry hooks (reference API names) --------------------------------
    def _add_hook(self, hook):
        self._hooks.append(hook)
        self._plan = None

    def _add_collision(self, coll):
        self._collisions.append(coll)
        self._plan = None

    def add_eating_rate(self, eater_index, eatee_index, rate):
        """f_eater += w rate rho_eater rho_eatee; f_eatee -= the same
        (``single_component.cl:120-159``)."""
        self._add_collision(("eating", int(eater_index), int(eatee_index),
                             float(rate)))

    def add_growth(self, eater_index, min_rho_cutoff, max_rho_cutoff,
                   eat_rate):
        """Uniform growth wherever the density is inside the cutoff window
        (``multi.cl:182-220``)."""
        self._add_collision(("growth", int(eater_index),
                             float(min_rho_cutoff), float(max_rho_cutoff),
                             float(eat_rate)))

    def add_constant_body_force(self, fluid_index, force_x, force_y):
        """Constant force per density (``single_component.cl:547-570``)."""
        self._add_hook(("const_force", int(fluid_index), float(force_x),
                        float(force_y)))

    def add_constant_g_force(self, fluid_index, g_x, g_y):
        """Constant gravity: force density ``g rho``
        (``multi.cl:541-566``)."""
        self._add_hook(("const_g", int(fluid_index), float(g_x), float(g_y)))

    def _radial(self, center_x, center_y, prefactor, radial_scaling,
                times_rho, fluid_index):
        """The radial field, precomputed in numpy float64 as JAX does
        (``multicomponent.py:311-331``)."""
        X, Y = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        dx_, dy_ = X - center_x, Y - center_y
        r = np.sqrt(dx_**2 + dy_**2)
        theta = np.arctan2(dy_, dx_)
        mag = prefactor * r**radial_scaling
        self._ext_planes.append((mag * np.cos(theta), mag * np.sin(theta)))
        self._add_hook(("ext", int(fluid_index), len(self._ext_planes) - 1,
                        bool(times_rho)))

    def add_radial_body_force(self, fluid_index, center_x, center_y,
                              prefactor, radial_scaling):
        """(``single_component.cl:571-607``)"""
        self._radial(center_x, center_y, prefactor, radial_scaling, False,
                     fluid_index)

    def add_radial_g_force(self, fluid_index, center_x, center_y, prefactor,
                           radial_scaling):
        """(``multi.cl:568-606``)"""
        self._radial(center_x, center_y, prefactor, radial_scaling, True,
                     fluid_index)

    def _interaction(self, fluid_1, fluid_2, G_int, bc, potential,
                     potential_parameters, belt):
        params = (tuple(float(p) for p in potential_parameters)
                  if potential_parameters is not None else (0.0,))
        self._add_hook(("interaction", int(fluid_1), int(fluid_2),
                        float(G_int), _PSI_NAMES[potential], params, belt,
                        bc != "periodic"))

    def add_interaction_force(self, fluid_1_index, fluid_2_index, G_int,
                              bc="periodic", potential="linear",
                              potential_parameters=None):
        """First-belt Shan-Chen interaction over the D2Q9 moving vectors,
        whatever the lattice (``single_component.cl:652-793``,
        ``multi.py:517-529``)."""
        self._interaction(fluid_1_index, fluid_2_index, G_int, bc, potential,
                          potential_parameters, 1)

    def add_interaction_force_second_belt(self, fluid_1_index, fluid_2_index,
                                          G_int, bc="periodic",
                                          potential="linear",
                                          potential_parameters=None):
        """Two-belt 25-vector Shan-Chen interaction
        (``single_component.cl:795-967``; stencil from
        ``single_component.py:533-646``)."""
        self._interaction(fluid_1_index, fluid_2_index, G_int, bc, potential,
                          potential_parameters, 2)

    def add_screened_poisson_force(self, source_index, force_index,
                                   interaction_length, amplitude,
                                   precision="highest"):
        """Per-step spectral repulsion (``multi.py:488-511, 768-769``):
        ``G[force_index] += amplitude * grad(screen(rho[source_index]))``
        with dx = 1 and the Nyquist-zeroed gradient multipliers of
        ``ScreenedFisherWave``'s solve, at its registration-order place
        among the force hooks. ``precision`` (``"highest"`` or
        ``"bf16x3"``, the TPU solve's matmul modes) is accepted; both run
        the same float32 K8."""
        if precision not in ("highest", "bf16x3"):
            raise ValueError(f"unknown precision {precision!r}; use "
                             "'highest' or 'bf16x3'")
        self._ext_planes.append(None)
        self._add_hook(("screened", int(force_index),
                        len(self._ext_planes) - 1, int(source_index),
                        float(interaction_length) ** 2, float(amplitude)))

    def shard_over(self, mesh):
        """Cut the state into the shards of ``mesh`` (a
        :class:`~lb2d_tpu_torch.parallel.Mesh`, e.g. ``make_mesh(devices=
        ["cuda:0"] * 4, shape=(4, 1))`` or ``global_mesh()`` across
        processes; ``["cpu"] * n`` with ``device="cpu"``) and return the
        runner (``lb2d_tpu/models/multicomponent.py:834-871``). From then on
        ``run`` steps the shards (K6h and, for a screened-Poisson hook, K8
        once per device on the gathered density, on the kernel backend; the
        plain twins on ``eager``) and ``get_fields``, ``check_fields``,
        ``rho``, ``u_bary``, ``v_bary``, ``state_numpy`` and
        ``load_numpy_state`` read or write the shards. The runner gives up
        its whole-grid state: ``f`` is None. The grid must divide the mesh;
        hooks may still be registered."""
        from ..parallel.sharded import ShardedRunner

        if self._sharded is not None:
            self.f = torch.from_numpy(self.state_numpy()).to(self.device)
            self._sharded = None
        sharded = ShardedRunner(self, mesh)
        self._sharded = sharded
        self.f = None
        self._spare = self._rho_buf = None
        self._hydro_step = None
        return self

    # ---- hydro fields (gathered from the shards when sharded) ---------------
    @property
    def rho(self):
        self._gather_hydro()
        return self._rho

    @rho.setter
    def rho(self, value):
        self._rho = value

    @property
    def u_bary(self):
        self._gather_hydro()
        return self._u_bary

    @u_bary.setter
    def u_bary(self, value):
        self._u_bary = value

    @property
    def v_bary(self):
        self._gather_hydro()
        return self._v_bary

    @v_bary.setter
    def v_bary(self, value):
        self._v_bary = value

    def _gather_hydro(self):
        if (self._sharded is not None
                and self._hydro_step != self.steps_taken):
            self._rho, self._u_bary, self._v_bary = self._sharded.hydro()
            self._hydro_step = self.steps_taken

    # ---- numerics ------------------------------------------------------------
    @traced("lb2d.wait.columns")
    def _columns(self):
        like = dict(dtype=self.dtype, device=self.device)
        lat = self.lattice
        return tuple(torch.tensor(c, **like)[:, None, None]
                     for c in (lat.w, lat.cx, lat.cy))

    def _feq_single(self, rho, u, v, epsilon):
        """Porosity feq for one component (``single_component.cl:39-60``)."""
        cs2 = self.lattice.cs2
        w, cx, cy = self._columns()
        cu = cx * u + cy * v
        usq = u * u + v * v
        return w * rho * (1.0 + cu / cs2 + cu * cu / (2 * cs2 * cs2 * epsilon)
                          - usq / (2 * cs2 * epsilon))

    def config(self) -> MCKernelConfig:
        """The registered fluids and hooks as the step's configuration."""
        fluids = tuple(FluidParams(omega=fl.omega, epsilon=fl.epsilon,
                                   nu_fluid=fl.nu_fluid, K=fl.K, Fe=fl.Fe,
                                   zero_gradient=fl.bc == "zero_gradient")
                       for fl in self.fluid_list)
        return MCKernelConfig(fluids=fluids, porous=bool(self.porous),
                              zero_density=self.zero_density,
                              hooks=tuple(self._hooks),
                              collisions=tuple(self._collisions))

    def ext_planes(self) -> torch.Tensor | None:
        """The ``"ext"`` hooks' planes ``[2 * pairs, ny, nx]`` (Gx, Gy per
        hook; zeros for a screened-Poisson hook's pair, which the kernel
        path fills) on the runner's device, or None."""
        if not self._ext_planes:
            return None
        zero = np.zeros((self.ny, self.nx))
        planes = [p for pair in self._ext_planes
                  for p in (pair if pair is not None else (zero, zero))]
        return torch.tensor(np.stack(planes), dtype=self.dtype,
                            device=self.device)

    def _make_plan(self):
        if len(self.fluid_list) != self.num_populations:
            raise ValueError("add every fluid and call complete_setup() "
                             "before run()")
        cfg = self.config()
        params = (mc_params(cfg, self.lattice) if self.backend == "kernel"
                  else None)
        self._plan = (cfg, self.ext_planes(), params)

    def _sweep_depth(self, k_steps):
        """Steps per solve of the screened-Poisson force: ``stale_force``,
        capped by ``k_steps`` (JAX, ``multicomponent.py:651-653``); 1 without
        such a hook."""
        if not self._plan[0].screened or self.stale_force is None:
            return 1
        return min(self.stale_force, int(k_steps or self.stale_force))

    @traced("lb2d.solve")
    def _solve_screened(self, rho, ext, plain):
        """Each screened-Poisson hook's force ``amplitude (xg, yg)`` of the
        post-stream densities ``rho`` into its ext pair: K8 (its plain
        version on the CPU), or, ``plain``, the plain solve."""
        for _, _, pair, src, lam2, amp in self._plan[0].screened:
            out = ext[2 * pair:2 * pair + 2]
            if plain:
                out.copy_(screened_gradients_reference(
                    rho[src].to(torch.float32), lam2, out_scale=amp))
            else:
                screened_gradients(rho[src], lam2, out=out, out_scale=amp)

    def _steps(self):
        """The backend's exact step ``f -> f`` and its sweep ``(f, n) -> f``
        holding the screened-Poisson force (:func:`held_solve_sweep`).
        Eager: the plain step, whose sweep solves from
        ``mc_density_reference`` with the plain solve. Kernel: ``mc_density``
        when the interactions or the solve need the density, K8 into the ext
        pairs at the sweep's first step, ``mc_step``."""
        cfg, ext, params = self._plan
        lat = self.lattice
        if self.backend != "kernel":
            def sweep(f, n):
                return held_solve_sweep(
                    f, n,
                    lambda f, rho: mc_step_reference(f, cfg, lat, ext,
                                                     hold_screened=True),
                    lambda f: mc_density_reference(f, cfg, lat),
                    lambda rho: self._solve_screened(rho, ext, plain=True))

            return (lambda f: mc_step_reference(f, cfg, lat, ext)), sweep
        if self._spare is None:
            self._spare = torch.empty_like(self.f)
        if self._rho_buf is None and (cfg.interactions or cfg.screened):
            self._rho_buf = torch.empty_like(self.rho)

        def step(f, rho):
            out = mc_step(f, self._spare, rho, ext, cfg, lat, params)
            self._spare = f
            return out

        def sweep(f, n):
            return held_solve_sweep(
                f, n, step,
                lambda f: mc_density(f, self._rho_buf, cfg, lat),
                ((lambda rho: self._solve_screened(rho, ext, plain=False))
                 if cfg.screened else None),
                density_every_step=bool(cfg.interactions))

        return (lambda f: sweep(f, 1)), sweep

    # ---- execution -----------------------------------------------------------
    @traced("lb2d.run")
    def run(self, num_iterations, debug=False, timed=False, k_steps=None):
        """Advance ``num_iterations`` steps. With a screened-Poisson hook
        and ``stale_force=K``, ``steps_per_call`` is K (capped by
        ``k_steps``): ``num_iterations // K`` sweeps that each solve once,
        then the rest as exact single steps. Otherwise every step is exact
        and ``k_steps`` changes no number (K6 runs one step per launch).
        ``debug`` runs exact single steps and prints ``check_fields()``
        after each; ``timed`` synchronises around the run and sets
        ``last_mlups``."""
        if k_steps is not None and int(k_steps) < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        if self._sharded is not None:
            return self._run_sharded(num_iterations, debug, timed, k_steps)
        if self._plan is None:
            self._make_plan()
        single, steps = self._steps()
        self.backend_used = self.backend
        K = 1 if debug else self._sweep_depth(k_steps)
        self.steps_per_call = K

        def sweep(f):
            if not debug:
                return steps(f, K) if K > 1 else single(f)
            self.f = single(f)  # K is 1
            self.check_fields()
            return self.f

        if timed:
            self._synchronize()
            t0 = time.perf_counter()
        self.f = advance(self.f, num_iterations, K, sweep, single)
        if timed:
            self._synchronize()
            dt = time.perf_counter() - t0
            self.last_mlups = self.nx * self.ny * num_iterations / dt / 1e6
        self.steps_taken += int(num_iterations)
        self._refresh_hydro()
        return self

    def _run_sharded(self, num_iterations, debug, timed, k_steps):
        """``run`` on the shards (:class:`~lb2d_tpu_torch.parallel.sharded.
        ShardedRunner`, which advances ``steps_taken``): the same sweeps,
        debug dumps and timing."""
        sh = self._sharded.prepare(k_steps, debug)
        self.backend_used = self.backend
        self.steps_per_call = sh.steps_per_call
        if debug:
            for _ in range(int(num_iterations)):
                sh.run(1)
                self.check_fields()
            return self
        sh.run(num_iterations, timed=timed)
        if timed:
            self.last_mlups = sh.last_mlups
        return self

    @traced("lb2d.wait.synchronize")
    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _hydro_of(self, f):
        """rho per fluid and the barycentric velocity without the half-force
        term of populations ``f [q, C, ...]`` (``multicomponent.py:
        948-963``)."""
        _, cx, cy = self._columns()
        rho = f.sum(dim=0)
        rho_tot = rho.sum(dim=0)
        u = torch.tensordot(cx[:, 0, 0], f, dims=1).sum(0) / rho_tot
        v = torch.tensordot(cy[:, 0, 0], f, dims=1).sum(0) / rho_tot
        return rho, u, v

    @traced("lb2d.hydro")
    def _refresh_hydro(self):
        """rho and the barycentric velocity of the state (of the shards,
        on first access, when sharded)."""
        if self._sharded is None:
            self.rho, self.u_bary, self.v_bary = self._hydro_of(self.f)

    def check_fields(self, accumulate: str = "f64"):
        """Conservation debug dump (``single_component.py:753-766``), with
        float64-grade accumulation by default (``accumulate``, as in
        :func:`lb2d_tpu_torch.utils.metrics.accumulated_sum`);
        sharded, the sums of the shards' sums."""
        parts = ([self.f] if self._sharded is None
                 else self._sharded.fluid_views())
        out = {}
        for i in range(self.num_populations):
            out[f"sum_rho_{i}"] = out[f"sum_f_{i}"] = 0.0
        for f in parts:
            rho = f.sum(dim=0)
            for i in range(self.num_populations):
                out[f"sum_rho_{i}"] += accumulated_sum(rho[i], accumulate)
                out[f"sum_f_{i}"] += accumulated_sum(f[:, i], accumulate)
        if self._sharded is not None:
            out = self._sharded.sum_over_processes(out)
        print(out)
        return out

    @traced("lb2d.readout.get_fields")
    def get_fields(self):
        """Reference layout: rho (nx, ny, C), f (nx, ny, C, Q), u_bary and
        v_bary (nx, ny), as numpy arrays."""
        self._refresh_hydro()

        def host(t):
            return t.detach().cpu().numpy()

        return {
            "f": np.transpose(self.state_numpy(), (3, 2, 1, 0)),
            "rho": np.transpose(host(self.rho), (2, 1, 0)),
            "u_bary": host(self.u_bary).T,
            "v_bary": host(self.v_bary).T,
        }

    # ---- state carried across packages ---------------------------------------
    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    def state_numpy(self) -> np.ndarray:
        """The populations ``[q, C, ny, nx]`` as numpy (in JAX:
        ``np.asarray(sim.f)``), gathered from the shards when sharded."""
        if self._sharded is not None:
            return self._sharded.state_numpy().reshape(
                self.lattice.q, self.num_populations, self.ny, self.nx)
        return self.f.detach().cpu().numpy().copy()

    def load_numpy_state(self, f) -> None:
        """Replace the populations with a numpy array ``[q, C, ny, nx]``, for
        example the state of the JAX runner built from the same arguments
        (split into the shards when sharded), and refresh rho and the
        barycentric velocity."""
        f = np.ascontiguousarray(f)
        want = (self.lattice.q, self.num_populations, self.ny, self.nx)
        if f.shape != want:
            raise ValueError(f"state must be {want}, got {f.shape}")
        if self._sharded is not None:
            self._sharded.load_numpy_state(f)
            self._hydro_step = None
            return
        self.f = torch.tensor(f, dtype=self.dtype, device=self.device)
        self._refresh_hydro()
