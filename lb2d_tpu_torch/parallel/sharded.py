"""Domain decomposition of the flow, diffusion, multifield,
multicomponent and coupled families (counterpart of
``lb2d_tpu.parallel.sharded`` and ``SimulationRunner.shard_over``).

A grid is cut into the ``H x W`` shards of a :class:`~lb2d_tpu_torch.
parallel.halo.Mesh`; each process keeps its own shards on their devices
and no device ever holds the whole grid. One sweep of ``k`` steps exchanges
a ``k``-cell halo around every shard (:mod:`lb2d_tpu_torch.parallel.halo`,
outside the kernel as in JAX), then launches K9
(:func:`~lb2d_tpu_torch.ops.fused_halo.temporal_halo_step`) once per
shard, into the shard's spare buffer (ping-pong: ``run`` allocates
nothing). The rest of ``run(n)`` (``n % K``) is one more K9 sweep of
``n % K`` steps, not a plain step as in JAX (``sharded.py:346-351``).

K9 applies every BC by global coordinates and keys its Philox noise by
(seed, global step, global cell), so a sharded run equals the unsharded K2
/ K4 run on any mesh, walls and noise included: no wall band, no seam
patch, and the same noise for a cell whatever the mesh (JAX draws a
different noise per shard, DIVERGENCES #19). The port's K9 takes any shard
shape, obstacles and unaligned widths too, so JAX's fall-backs to its XLA
step (``sharded.py:884-891``) have no counterpart: ``backend="auto"`` is K9
on CUDA and the plain sharded step (:func:`make_sharded_pipe_step`) on the
CPU. On the CPU, ``"temporal"`` runs the same sweeps through K9's plain
twin.

The sharded state is the list :attr:`state` of this process's shard
tensors (``[9, H, W]``; ``[9 F, H, W]`` for multifield, plane ``j F + p``);
:meth:`state_numpy` assembles the global array and
:meth:`load_numpy_state` splits one into the shards. A wrapped model gives
its state up to the shards (its ``state`` becomes None, so no device keeps
the whole grid) and follows the sharded model's ``steps_taken``.

The multicomponent runner (:class:`ShardedRunner`, what
``SimulationRunner.shard_over`` drives) steps one step per launch, K6h:
the halo is the lattice's reach, and the post-stream densities, which the
interaction stencils read at the neighbours and the screened-Poisson
solve reads everywhere, go into one whole-grid plane stack per device,
filled band by band by the shards' density passes; across devices and
processes :func:`~lb2d_tpu_torch.parallel.halo.exchange_bands` brings
each device the belt around its shards, and :func:`~lb2d_tpu_torch.
parallel.halo.gather_bands` completes the solve's source planes alone; K8
then solves once per device (JAX runs its matmul DFT on the sharded
density under GSPMD, ``sharded.py:734-750``). JAX's sweeps of K kernel
steps per exchange, its ext halo chunks and its 128-lane x strips are TPU
scheduling and have no counterpart there.

The coupled families (:class:`ShardedCoupled`) run K7h's K-step sweeps,
as JAX runs K kernel steps per exchange: one halo exchange of K times the
step's reach per launch; the rocket yeasts need nothing else, the
screened families' density pass and solve run once per
``stale_velocity`` sweep, on the same plane stacks.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import held_solve_sweep, plain_backend
from ..ops.fused import multifield_max_k
from ..ops.fused_coupled import (
    COUPLED_TEMPORAL_K,
    coupled_density_halo,
    coupled_max_k,
    coupled_params,
    coupled_reach,
    coupled_density_halo_reference,
    coupled_sweep_halo,
    coupled_sweep_halo_reference,
    _coupled_cell_step_halo,
)
from ..ops.fused_halo import (
    HALO_TEMPORAL_K,
    cut_region,
    halo_max_k,
    temporal_halo_step,
    temporal_halo_step_reference,
)
from ..ops.fused_mc import (
    lattice_reach,
    mc_density_halo,
    mc_density_halo_reference,
    mc_step_halo,
    mc_step_halo_reference,
    shard_cells,
)
from .halo import (
    Mesh,
    band,
    exchange_bands,
    exchange_halos,
    gather_bands,
    new_halos,
    this_rank,
)

__all__ = [
    "make_sharded_pipe_step",
    "make_sharded_temporal_step",
    "make_mesh",
    "ShardedPipeFlow",
    "ShardedDiffusion",
    "ShardedMultifield",
    "ShardedCoupled",
    "ShardedRunner",
]


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A mesh of this process's ``devices`` (default: every CUDA card),
    the first ``n_devices`` of them, factored as square as possible unless
    ``shape`` is given. ``devices`` may repeat a device: ``["cuda:0"] * 4``
    cuts a grid into four shards on one card, ``["cpu"] * 8`` into eight on
    the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs a device, but only 0 CUDA devices are "
                         "available; pass devices=['cpu', ...] for the CPU")
    if shape is None:
        my = int(np.floor(np.sqrt(n)))
        while n % my:
            my -= 1
        shape = (my, n // my)
    rank = this_rank()
    return Mesh([(rank, d) for d in devices], shape)


def _shard_shape(mesh: Mesh, ny: int, nx: int):
    if ny % mesh.my or nx % mesh.mx:
        raise ValueError(f"grid {ny}x{nx} must divide mesh "
                         f"{mesh.my}x{mesh.mx}")
    return ny // mesh.my, nx // mesh.mx


def _steps_per_sweep(k_steps, mesh, H, W, max_k, reach=1):
    """``k_steps`` capped by the kernel's limit ``max_k`` and by the shard's
    edge along the sharded axes: the halo of ``reach`` cells a step comes
    from one neighbour."""
    k = min(int(k_steps), max_k, H // reach,
            W // reach if mesh.mx > 1 else max_k)
    if k < 1:
        raise ValueError(f"no sweep of steps that reach {reach} cells on "
                         f"{H}x{W} shards")
    return k


def _halo_sweep(mesh: Mesh, run_shard):
    """``sweep(halos, out, k)``: exchange the halos of this process's
    shards (:func:`~lb2d_tpu_torch.parallel.halo.exchange_halos`), then
    ``run_shard(pos, halo, out[pos], k)`` writes ``k`` steps of each shard
    into ``out``."""
    def sweep(halos, out, k):
        exchange_halos(mesh, halos)
        for pos, h in halos.items():
            run_shard(pos, h, out[pos], k)
        return out
    return sweep


def _region_masks(mesh, obstacle_mask, H, W, width):
    """Each local shard's obstacle mask with its ``width``-cell ring
    (int32, on its device), cut once from the global mask; {} without
    one."""
    if obstacle_mask is None:
        return {}
    m = torch.as_tensor(np.asarray(obstacle_mask, np.int32))
    return {pos: cut_region(m, pos[0] * H, pos[1] * W, H, W, width).to(
        mesh.device(pos)).contiguous() for pos in mesh.local_positions()}


def _flow_kwargs(omega, inlet_rho, outlet_rho, equilibrium):
    return dict(omega=omega, inlet_rho=inlet_rho, outlet_rho=outlet_rho,
                incompressible=equilibrium == "incompressible")


def make_sharded_pipe_step(*, mesh: Mesh, ny: int, nx: int, omega,
                           inlet_rho, outlet_rho,
                           equilibrium: str = "compressible",
                           obstacle_mask=None):
    """The plain sharded pipe-flow step (JAX's general XLA path,
    ``sharded.py:58-123``): ``step(halos, out, 1)`` exchanges 1-cell
    halos and writes one plain step of each local shard into ``out[pos]``,
    with the Zou-He BCs, walls and obstacle by global coordinates
    (:func:`~lb2d_tpu_torch.ops.fused_halo.temporal_halo_step_reference`
    at one step). ``halos``: position -> 1-cell
    :class:`~lb2d_tpu_torch.ops.fused_halo.Halo` (``new_halos(mesh,
    shards, 1)``). ``obstacle_mask``: the global ``[ny, nx]`` mask or
    None."""
    H, W = _shard_shape(mesh, ny, nx)
    masks = _region_masks(mesh, obstacle_mask, H, W, 1)
    kw = _flow_kwargs(omega, inlet_rho, outlet_rho, equilibrium)

    def run_shard(pos, halo, out, k):
        out.copy_(temporal_halo_step_reference(halo, 1, "flow",
                                               mask=masks.get(pos), **kw))

    return _halo_sweep(mesh, run_shard)


def make_sharded_temporal_step(*, mesh: Mesh, ny: int, nx: int, omega,
                               inlet_rho, outlet_rho,
                               equilibrium: str = "compressible",
                               obstacle_mask=None,
                               k_steps: int | None = None):
    """The K9 sweep of the sharded pipe flow (``sharded.py:126-208``):
    returns ``(sweep, K)``; ``sweep(halos, out, k)`` exchanges the
    ``K``-cell halos and launches K9 once per local shard, writing ``k <=
    K`` steps into ``out[pos]``. ``K`` is ``k_steps`` (default K9's
    ``HALO_TEMPORAL_K["flow"]``) capped by the shard's edge."""
    H, W = _shard_shape(mesh, ny, nx)
    K = _steps_per_sweep(k_steps or HALO_TEMPORAL_K["flow"], mesh, H, W,
                         halo_max_k("flow"))
    masks = _region_masks(mesh, obstacle_mask, H, W, K)
    kw = _flow_kwargs(omega, inlet_rho, outlet_rho, equilibrium)

    def run_shard(pos, halo, out, k):
        temporal_halo_step(halo, out, k, "flow", mask=masks.get(pos), **kw)

    return _halo_sweep(mesh, run_shard), K


class _ShardedModel:
    """The run loop, state and getters of the sharded models.

    Subclasses set ``mesh``, ``base``, ``ny``, ``nx``, ``steps_per_call``,
    ``steps_taken``, ``physics`` and ``step_kwargs`` (K9's physics and its
    arguments), and call :meth:`_place` with their shards and sweep; or, on
    a 1x1 mesh, set ``_single`` to the unsharded model that runs instead.
    ``halos`` holds this process's shards: position -> :class:`~lb2d_tpu_
    torch.ops.fused_halo.Halo` (the shard and its halo buffers).
    """

    _single = None
    last_mlups = None

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    def _place(self, blocks: dict, width: int, sweep):
        """This process's shards (position -> tensor on its device), their
        ``width``-cell halos, spare buffers and the sweep
        ``sweep(halos, out, k)``."""
        self.halos = new_halos(self.mesh, blocks, width)
        self._spare = {p: torch.empty_like(f) for p, f in blocks.items()}
        self._sweep_fn = sweep
        first = next(iter(blocks.values()))
        self._planes, self._H, self._W = first.shape
        self._dtype = torch.empty((), dtype=first.dtype).numpy().dtype

    def _sweep(self, k):
        self._sweep_fn(self.halos, self._spare, k)
        self._swap()

    def _swap(self):
        """The spare buffers, just written, become the shards."""
        for pos, h in self.halos.items():
            self._spare[pos], self.halos[pos] = h.f, h._replace(
                f=self._spare[pos])

    @property
    def state(self) -> list:
        """This process's shard tensors, in mesh order."""
        if self._single is not None:
            return [self._single.state]
        return [h.f for h in self.halos.values()]

    def _devices(self):
        return {t.device for t in self.state}

    def block_until_ready(self):
        for dev in self._devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def run(self, num_iterations: int, *, timed: bool = False):
        """``num_iterations // K`` sweeps of ``K = steps_per_call`` steps,
        then one of the rest. With ``timed``, ``last_mlups`` records million
        lattice-site updates per second between two synchronisations of
        this process's devices."""
        n = int(num_iterations)
        if timed:
            self.block_until_ready()
            t0 = time.perf_counter()
        if self._single is not None:
            self._single.run(n)
        else:
            done = 0
            while done < n:
                k = min(self.steps_per_call, n - done)
                self._step0 = self.steps_taken + done
                self._sweep(k)
                done += k
        if timed:
            self.block_until_ready()
            self.last_mlups = self.num_cells * n / (
                time.perf_counter() - t0) / 1e6
        self.steps_taken += n
        if self._single is None:
            self.base.steps_taken = self.steps_taken
        return self

    def state_numpy(self) -> np.ndarray:
        """The global populations ``[P, ny, nx]`` as a numpy array (every
        process's shards; in JAX ``np.asarray(jax.device_get(sh.state))``)."""
        if self._single is not None:
            return self._single.state_numpy()
        return self._assemble({pos: h.f for pos, h in self.halos.items()})

    def _assemble(self, parts: dict) -> np.ndarray:
        """The global ``[P', ny, nx]`` numpy array of per-shard tensors
        ``[P', H, W]`` (position -> tensor), every process's."""
        H, W = self._H, self._W
        blocks = {pos: t.detach().cpu().numpy() for pos, t in parts.items()}
        if len({rank for rank, _ in self.mesh.entries}) > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, blocks)
            blocks = {k: v for part in gathered for k, v in part.items()}
        first = next(iter(blocks.values()))
        out = np.empty((first.shape[0], self.ny, self.nx), first.dtype)
        for pos, a in blocks.items():
            out[(slice(None),) + band(pos, H, W)] = a
        return out

    def load_numpy_state(self, f) -> None:
        """Replace the populations with a global numpy array (``[P, ny,
        nx]`` or the base model's layout), split into this process's
        shards: for example a JAX model's state."""
        if self._single is not None:
            return self._single.load_numpy_state(f)
        f = np.asarray(f, self._dtype)
        if f.size != self._planes * self.ny * self.nx:
            raise ValueError(f"state must hold {self._planes} planes of "
                             f"{self.ny}x{self.nx}, got {f.shape}")
        f = f.reshape(self._planes, self.ny, self.nx)
        H, W = self._H, self._W
        for h in self.halos.values():
            h.f.copy_(torch.from_numpy(np.ascontiguousarray(
                f[:, h.y0:h.y0 + H, h.x0:h.x0 + W])))

    def get_fields(self) -> dict:
        """The base model's fields of the global state (gathered to the
        base model's device for the getter)."""
        if self._single is not None:
            return self._single.get_fields()
        base = self.base
        saved = getattr(base, "state", None)
        base.state = torch.from_numpy(self.state_numpy()).reshape(
            self._base_shape).to(base.device)
        try:
            return base.get_fields()
        finally:
            base.state = saved


class ShardedPipeFlow(_ShardedModel):
    """Pipe flow over a mesh; the arguments of
    :class:`~lb2d_tpu_torch.models.PipeFlow` (``device`` aside: the mesh
    places the shards) and its getters (``sharded.py:854-979``).

    ``backend``: ``"temporal"`` is K9, ``K = k_steps`` (default
    ``HALO_TEMPORAL_K["flow"]``, capped by the shard's edge) steps per
    sweep;
    ``"eager"`` (alias ``"xla"``) the plain sharded step
    (:func:`make_sharded_pipe_step`); ``"auto"`` K9 on CUDA and
    ``"eager"`` on the CPU, and on a 1x1 mesh the unsharded model's own
    ``auto`` path (JAX bypasses to its unsharded kernel too,
    ``sharded.py:921-944``). The state is built shard by shard from the
    perturbation of ``np.random.RandomState(seed)``, so its bits are the
    unsharded model's.
    """

    def __init__(self, mesh: Mesh | None = None, backend: str = "auto",
                 k_steps: int | None = None, **kwargs):
        from ..models.pipe_flow import PipeFlow

        self.mesh = mesh if mesh is not None else make_mesh()
        backend = plain_backend(backend)
        if backend not in ("auto", "temporal", "eager"):
            raise ValueError(f"unknown backend {backend!r}; use 'auto', "
                             "'temporal' or 'eager'")
        local = self.mesh.local_positions()
        device = self.mesh.device(local[0] if local else (0, 0))
        single = self.mesh.size == 1 and backend == "auto"
        base = PipeFlow(backend="auto" if single else "eager",
                        init_state=single, device=device, **kwargs)
        self.base = base
        self.units = base.units
        self.nx, self.ny = base.nx, base.ny
        self.omega = base.omega
        self.inlet_rho, self.outlet_rho = base.inlet_rho, base.outlet_rho
        self.steps_taken = 0
        if single:
            self._single = base
            self.backend = base.backend
            self.steps_per_call = base.steps_per_call
            return
        if backend == "auto":
            backend = "temporal" if device.type == "cuda" else "eager"
        self.backend = backend
        self.physics = "flow"
        self.step_kwargs = _flow_kwargs(self.omega, self.inlet_rho,
                                        self.outlet_rho, base.equilibrium)
        mask = (None if base.obstacle_mask is None
                else base.obstacle_mask.cpu().numpy())
        geometry = dict(mesh=self.mesh, ny=self.ny, nx=self.nx,
                        omega=self.omega, inlet_rho=self.inlet_rho,
                        outlet_rho=self.outlet_rho,
                        equilibrium=base.equilibrium, obstacle_mask=mask)
        if backend == "temporal":
            sweep, K = make_sharded_temporal_step(k_steps=k_steps,
                                                  **geometry)
        else:
            sweep, K = make_sharded_pipe_step(**geometry), 1
        self.steps_per_call = K
        H, W = _shard_shape(self.mesh, self.ny, self.nx)
        perturb = base._init_perturb(np.random.RandomState(base.seed))
        blocks = {pos: base._init_from_perturb(
            perturb[:, pos[0] * H:(pos[0] + 1) * H,
                    pos[1] * W:(pos[1] + 1) * W], self.mesh.device(pos),
            pos[1] * W) for pos in local}
        del perturb
        self._base_shape = (9, self.ny, self.nx)
        self._place(blocks, K, sweep)


class ShardedDiffusion(_ShardedModel):
    """The advection-diffusion family over a mesh (``sharded.py:211-363``):
    wraps a constructed model of :mod:`lb2d_tpu_torch.models.diffusion`
    (deterministic or stochastic) and runs K9 ``"diffusion"`` /
    ``"noisy_fisher"`` per shard, ``K = k_steps`` (default K9's
    ``HALO_TEMPORAL_K`` of the physics, capped by the shard's edge) steps
    per sweep. The noise
    is the unsharded model's: the model's ``rng_seed``, the global step
    ``steps_taken`` and the global cell."""

    def __init__(self, base, mesh: Mesh | None = None,
                 k_steps: int | None = None):
        self.base = base
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ny, self.nx = base.ny, base.nx
        self.noisy = base.noisy
        self.steps_taken = base.steps_taken
        self.physics = "noisy_fisher" if self.noisy else "diffusion"
        H, W = _shard_shape(self.mesh, self.ny, self.nx)
        K = self.steps_per_call = _steps_per_sweep(
            k_steps or HALO_TEMPORAL_K[self.physics], self.mesh, H, W,
            halo_max_k(self.physics))
        kw = self.step_kwargs = base.step_kwargs()
        kw.pop("noisy", None)

        def run_shard(pos, halo, out, k):
            temporal_halo_step(halo, out, k, self.physics, step0=self._step0,
                               **kw)

        self._base_shape = tuple(base.state.shape)
        self._place(_split(self.mesh, base.state, H, W), K,
                    _halo_sweep(self.mesh, run_shard))
        base.state = None  # the shards hold it now


class ShardedMultifield(_ShardedModel):
    """The multifield range expansions over a mesh (``sharded.py:366-627``):
    wraps a :class:`~lb2d_tpu_torch.models.FisherExpansion` or
    :class:`~lb2d_tpu_torch.models.Expansion` and runs K9
    ``"multifield_fisher"`` / ``"multifield_expansion"`` per shard on
    ``[9 F, H, W]`` shards (plane ``j F + p``), ``K = k_steps`` (default
    the model's ``temporal_k``, capped by the shard's edge) steps per
    sweep. The no-flux walls apply by global coordinates, so JAX's wall
    bands (``sharded.py:501-580``) have no counterpart; the Expansion's
    noise is the unsharded model's."""

    def __init__(self, base, mesh: Mesh | None = None,
                 k_steps: int | None = None):
        self.base = base
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ny, self.nx = base.ny, base.nx
        self.noisy = base.physics == "expansion"
        self.steps_taken = base.steps_taken
        F = base.num_fields
        H, W = _shard_shape(self.mesh, self.ny, self.nx)
        K = self.steps_per_call = _steps_per_sweep(
            k_steps or base.temporal_k, self.mesh, H, W, multifield_max_k(F))
        kw = self.step_kwargs = base.step_kwargs()
        self.physics = "multifield_" + kw.pop("physics")

        def run_shard(pos, halo, out, k):
            temporal_halo_step(halo, out, k, self.physics, step0=self._step0,
                               **kw)

        self._base_shape = tuple(base.state.shape)
        self._place(_split(self.mesh, base.state.reshape(9 * F, self.ny,
                                                         self.nx), H, W),
                    K, _halo_sweep(self.mesh, run_shard))
        base.state = None  # the shards hold it now


class _DensityShards(_ShardedModel):
    """Whole-grid planes on each device around the shards, for the models
    whose steps read densities: the multicomponent runner's shards and the
    coupled families.

    Every shard's density pass writes its band of the post-stream densities
    into one whole-grid ``rho`` per device (:meth:`_densities`). Across
    devices and processes, each device then receives the ``belt`` rows and
    columns around its shards' bands that the interaction stencils read
    (:func:`~lb2d_tpu_torch.parallel.halo.exchange_bands`), and, before a
    solve (the screened-Poisson force or velocity), the whole of the planes
    the solve reads (:func:`~lb2d_tpu_torch.parallel.halo.gather_bands`);
    the solve runs once per device from them into whole-grid ext planes
    (:meth:`_solve`). Each shard's step then reads ``rho`` at its
    neighbours' and ext at its own global cells; the subclasses' ``_sweep``
    launch the steps.

    Subclasses call :meth:`_place` with their shards, then
    :meth:`_set_planes` with ``density(halo, rho)``, the solve ``solve(rho,
    ext)`` (or None), the planes of ``rho`` (0 for none), the ext planes,
    the belt and the planes the solve reads.
    """

    def _set_planes(self, density, solve, rho_planes, ext, dtype, belt,
                    solve_planes):
        """``ext``: the whole-grid ext planes ``[E, ny, nx]`` to start from
        on every device (None for none); ``belt``: how far the steps read
        the neighbours' densities (0: not at all); ``solve_planes``: the
        planes of ``rho`` the solve reads."""
        self._density_fn, self._solve_fn = density, solve
        self._belt, self._solve_planes = belt, tuple(solve_planes)
        devices = {self.mesh.device(p) for p in self.halos}
        like = dict(dtype=dtype)
        self._rho = ({d: torch.empty((rho_planes, self.ny, self.nx),
                                     device=d, **like) for d in devices}
                     if rho_planes else {})
        self._ext = ({d: ext.to(d, copy=True) for d in devices}
                     if ext is not None else {})

    def _densities(self, belt):
        """Every shard's density pass into its device's ``rho`` (from
        exchanged halos), then, with ``belt``, the belt around each band
        from the other devices; returns the planes per device."""
        for pos, h in self.halos.items():
            self._density_fn(h, self._rho[self.mesh.device(pos)])
        if belt:
            exchange_bands(self.mesh, self._rho, self._H, self._W, belt)
        return self._rho

    def _solve(self):
        """The solve's planes gathered on every device, then the solve once
        per device into its ext planes."""
        gather_bands(self.mesh, self._rho, self._H, self._W,
                     self._solve_planes)
        for dev, r in self._rho.items():
            with _on(dev):  # K8 launches on the current card
                self._solve_fn(r, self._ext[dev])

    def _state_model(self) -> torch.Tensor:
        """The global state in the wrapped model's layout (gathered to its
        device)."""
        return torch.from_numpy(self.state_numpy()).reshape(
            self._base_shape).to(self.base.device)


def _on(device):
    """The context that makes ``device`` the current card (none for the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check_backend(model, mesh):
    """The shards run on the device type the model was built for (so a
    model built on the CPU, whose ``auto`` is the plain step, never runs
    it on a card unasked), and the kernel backend on CUDA devices. Returns
    whether the kernels run."""
    devices = {mesh.device(p).type for p in mesh.positions()}
    if devices != {model.device.type}:
        raise ValueError(
            f"a model built on {model.device.type} shards over "
            f"{model.device.type} devices, not {sorted(devices)}: build it "
            "with device='cuda' for a CUDA mesh (backend='eager' names the "
            "plain step there), or shard over devices=['cpu'] * n")
    if model.backend == "kernel" and devices != {"cuda"}:
        raise ValueError("a model on the kernel backend shards over CUDA "
                         f"devices, not {sorted(devices)}; build it with "
                         "device='cpu' (the plain twins) for a CPU mesh")
    return model.backend == "kernel"


def _reach_fits(mesh, H, W, reach, what="the lattice's reach"):
    if H < reach or (mesh.mx > 1 and W < reach):
        raise ValueError(f"{H}x{W} shards are smaller than {what} of "
                         f"{reach} cells")


class ShardedRunner(_DensityShards):
    """A :class:`~lb2d_tpu_torch.models.SimulationRunner` cut into the
    shards of a mesh: what ``SimulationRunner.shard_over`` drives
    (``lb2d_tpu/models/multicomponent.py:834-871``, whose kernel path runs
    JAX's K6 per shard, ``:590-700``). Each step is K6h's density pass (when
    an interaction or a screened-Poisson hook reads densities), K8 once per
    device on the gathered density for each screened hook (once per
    ``stale_force`` sweep), and K6h's step, on the ``kernel`` backend; the
    plain twins on ``eager``. The runner gives its state up to the shards
    (``runner.f`` becomes None). The sharded state is ``[q C, H, W]`` per
    shard (plane ``j C + i``)."""

    def __init__(self, runner, mesh: Mesh):
        self.base, self.mesh = runner, mesh
        self.ny, self.nx = runner.ny, runner.nx
        self.steps_taken = runner.steps_taken
        self.kernel = _check_backend(runner, mesh)
        lat = runner.lattice
        q, C = lat.q, runner.num_populations
        H, W = _shard_shape(mesh, self.ny, self.nx)
        reach = lattice_reach(lat)
        _reach_fits(mesh, H, W, reach)
        if any(fl.bc == "zero_gradient" for fl in runner.fluid_list):
            # an edge cell pulls at the cell inside it, one cell further in
            _reach_fits(mesh, H, W, 2, "a zero-gradient edge's reach")
        self._base_shape = (q, C, self.ny, self.nx)
        self._place(_split(mesh, runner.f.reshape(q * C, self.ny, self.nx),
                           H, W), reach, None)
        self.steps_per_call = 1
        self._plan = None

    def prepare(self, k_steps=None, debug=False):
        """Build the step from the runner's plan (its hooks as registered
        now) and set ``steps_per_call`` for a run."""
        runner = self.base
        if runner._plan is None:
            runner._make_plan()
        if self._plan is not runner._plan:  # hooks registered since
            self._plan = runner._plan
            cfg, ext, params = self._plan
            lat, kernel = runner.lattice, self.kernel

            def density(h, rho):
                if kernel:
                    mc_density_halo(h, rho, cfg, lat)
                else:
                    rows, cols = shard_cells(h)
                    rho[:, rows, cols] = mc_density_halo_reference(h, cfg,
                                                                   lat)

            def step(h, out, rho, ext):
                if kernel:
                    mc_step_halo(h, out, rho, ext, cfg, lat, params)
                else:
                    out.copy_(mc_step_halo_reference(h, rho, ext, cfg, lat))

            def solve(rho, ext):
                runner._solve_screened(rho, ext, plain=not kernel)

            belt = max((hook[6] for hook in cfg.interactions), default=0)
            _reach_fits(self.mesh, self._H, self._W, belt,
                        "the interactions' belt")
            reads = bool(cfg.interactions or cfg.screened)
            self._step_fn = step
            self._set_planes(density, solve if cfg.screened else None,
                             runner.num_populations if reads else 0, ext,
                             runner.dtype, belt,
                             sorted({hook[3] for hook in cfg.screened}))
        self.steps_per_call = 1 if debug else runner._sweep_depth(k_steps)
        return self

    def _sweep(self, k):
        """``k`` steps, one halo exchange of the lattice's reach and one
        K6h step launch per shard each: the density pass before each step
        whose interactions read it, and before the first for the solve,
        which ``held_solve_sweep`` holds for a sweep of ``steps_per_call``
        steps, as the runner does; a shorter sweep, the rest of ``run(n)``,
        is exact single steps."""
        if 1 < k < self.steps_per_call:
            for _ in range(k):
                self._sweep(1)
            return
        fresh = [False]

        def exchange():
            if not fresh[0]:
                exchange_halos(self.mesh, self.halos)
                fresh[0] = True

        def density(_):
            exchange()
            return self._densities(self._belt)

        def step(_, rho):
            exchange()
            for pos, h in self.halos.items():
                dev = self.mesh.device(pos)
                self._step_fn(h, self._spare[pos], self._rho.get(dev),
                              self._ext.get(dev))
            self._swap()
            fresh[0] = False

        held_solve_sweep(None, k, step, density,
                         ((lambda _: self._solve())
                          if self._solve_fn is not None else None),
                         density_every_step=bool(self._belt))

    def fluid_views(self) -> list:
        """This process's shards as ``[q, C, H, W]`` views."""
        q, C = self.base.lattice.q, self.base.num_populations
        return [h.f.view(q, C, self._H, self._W) for h in self.halos.values()]

    def sum_over_processes(self, sums: dict) -> dict:
        """Per-process sums (name -> float) summed over every process of
        the mesh."""
        if len({rank for rank, _ in self.mesh.entries}) == 1:
            return sums
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, sums)
        return {k: sum(p[k] for p in parts) for k in sums}

    def hydro(self):
        """The runner's ``rho [C, ny, nx]``, ``u_bary`` and ``v_bary`` of
        the shards (``_refresh_hydro``'s formulas per shard), gathered to
        its device."""
        C = self.base.num_populations
        parts = {}
        for pos, f in zip(self.halos, self.fluid_views()):
            rho, u, v = self.base._hydro_of(f)
            parts[pos] = torch.cat([rho, u[None], v[None]])
        out = torch.from_numpy(self._assemble(parts)).to(self.base.device)
        return out[:C], out[C], out[C + 1]


# Steps per sweep of the sharded rocket yeasts on meshes that cut x. Their
# shards exchange columns too, which keeps the host busy about 1 ms a sweep
# on one card whatever K, so the kernel's cap, which halves the sweeps, beat
# COUPLED_TEMPORAL_K's 4 by 1.67-1.78x at 1024^2 on 2x2 shards, where the
# 4x1 shards, bound by the kernel, ran 1.12-1.13x faster at 4 (an H100;
# PERF.md, section 6).
COUPLED_X_SHARDED_K = 8


class ShardedCoupled(_DensityShards):
    """The coupled families over a mesh (``lb2d_tpu/parallel/sharded.py:
    630-853``): wraps a constructed :class:`~lb2d_tpu_torch.models.
    RocketYeast` (or ``RocketYeastForcesOnly``), ``SurfactantNutrientWave``
    (or ``Clumpy...``) or ``ScreenedFisherWave``.

    A sweep exchanges halos of ``K`` times the step's reach (2 cells for
    the physics that read the neighbours' densities, else 1) and launches
    K7h once per shard for ``K`` steps (:func:`~lb2d_tpu_torch.ops.
    fused_coupled.coupled_sweep_halo`) on the model's ``kernel`` backend;
    on ``eager`` its plain twin runs the same sweeps, on any device. ``K``
    is ``k_steps`` for the rocket yeasts (default ``COUPLED_TEMPORAL_K``,
    or ``COUPLED_X_SHARDED_K`` on meshes that cut x) and the
    ``stale_velocity`` depth (``k_steps``, default the model's) for
    the screened families, capped by the kernel and by the shard's edge.
    The rocket yeasts need no density planes: ``run(n)`` is ``n // K``
    sweeps and one of the rest. The screened families solve once per
    sweep: each shard's density pass (K6h) fills its band of a whole-grid
    density per device, ``gather_bands`` completes it across devices, K8
    solves once per device, and the sweep's launches hold the planes; a
    deeper sweep than the cap takes several launches, each after an
    exchange, and the rest of ``run(n)`` runs exact single steps, as the
    unsharded models. A sweep of one step runs K7h's one-step kernel on
    those densities (for the clumpy surfactant with the belt around each
    band, ``exchange_bands``).
    The model gives its state up to the shards (its ``state`` becomes None)
    and follows ``steps_taken``. JAX's matmul DFT under GSPMD has no
    counterpart (``PERF.md``)."""

    def __init__(self, base, mesh: Mesh | None = None,
                 k_steps: int | None = None):
        from ..models.waves import CoupledModel

        if not isinstance(base, CoupledModel):
            raise TypeError(f"unsupported model {type(base).__name__}")
        self.base = base
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ny, self.nx = base.ny, base.nx
        self.steps_taken = base.steps_taken
        kernel = _check_backend(base, self.mesh)
        cfg = base.coupled_config()
        F = cfg.fields
        H, W = _shard_shape(self.mesh, self.ny, self.nx)
        reach = coupled_reach(cfg)
        _reach_fits(self.mesh, H, W, reach, "one step's reach")
        velocity = base._velocity
        if velocity is not None:
            depth = int(k_steps or base.stale_velocity)
        else:
            depth = int(k_steps or (COUPLED_X_SHARDED_K if self.mesh.mx > 1
                                    else COUPLED_TEMPORAL_K[cfg.physics]))
        if depth < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        launch = (min(depth, COUPLED_TEMPORAL_K[cfg.physics])
                  if velocity is not None else depth)
        self._k = _steps_per_sweep(launch, self.mesh, H, W,
                                   coupled_max_k(cfg), reach)
        self.steps_per_call = depth if velocity is not None else self._k
        self._base_shape = tuple(base.state.shape)
        self._place(_split(self.mesh, base.state.reshape(9 * F, self.ny,
                                                         self.nx), H, W),
                    reach * self._k, None)
        base.state = None  # the shards hold it now
        if kernel:
            prm = coupled_params(cfg)
            density = coupled_density_halo

            def step(h, out, ext, k):
                coupled_sweep_halo(h, out, ext, cfg, k, prm)

            def cell(h, out, rho, ext):
                _coupled_cell_step_halo(h, out, rho, ext, cfg, prm)
        else:  # the plain twins, on any device

            def density(h, rho):
                rows, cols = shard_cells(h)
                rho[:, rows, cols] = coupled_density_halo_reference(h)

            def step(h, out, ext, k):
                out.copy_(coupled_sweep_halo_reference(h, ext, cfg, k))

            def cell(h, out, rho, ext):
                step(h, out, ext, 1)

        self._step_fn, self._cell_fn = step, cell

        def solve(rho, ext):
            velocity.planes(rho[base.POP], out=ext)

        ext = (torch.zeros((2, self.ny, self.nx), dtype=base.dtype)
               if cfg.reads_ext else None)
        self._set_planes(density, solve if velocity is not None else None,
                         F if velocity is not None else 0, ext, base.dtype,
                         cfg.belt, (base.POP,))

    def _sweep(self, k):
        """``k`` steps: one exchange and one K7h launch per shard for each
        ``self._k`` of them, after the screened families' density pass and
        solve."""
        solving = self._solve_fn is not None
        if solving and 1 < k < self.steps_per_call:
            for _ in range(k):  # the rest of run(n): exact single steps
                self._sweep(1)
            return
        exchange_halos(self.mesh, self.halos)
        # one step of a screened family: the solve's densities are the
        # step's, and K7h runs its one-step kernel on them (the clumpy
        # pseudo-force reads the belt around each shard's band)
        cell = solving and k == 1
        if solving:
            self._densities(self._belt if cell else 0)
            self._solve()
        if cell:
            for pos, h in self.halos.items():
                dev = self.mesh.device(pos)
                self._cell_fn(h, self._spare[pos], self._rho[dev],
                              self._ext[dev])
            self._swap()
            return
        done = 0
        while done < k:
            kk = min(self._k, k - done)
            if done:
                exchange_halos(self.mesh, self.halos)
            for pos, h in self.halos.items():
                self._step_fn(h, self._spare[pos],
                              self._ext.get(self.mesh.device(pos)), kk)
            self._swap()
            done += kk


def _split(mesh: Mesh, f: torch.Tensor, H: int, W: int) -> dict:
    """This process's shards of a global ``[P, ny, nx]`` tensor, each a
    contiguous copy on its mesh device."""
    return {pos: f[:, pos[0] * H:(pos[0] + 1) * H,
                   pos[1] * W:(pos[1] + 1) * W].to(
                       mesh.device(pos), copy=True).contiguous()
            for pos in mesh.local_positions()}
