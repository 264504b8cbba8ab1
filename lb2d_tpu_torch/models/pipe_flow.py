"""Pressure-driven pipe flow (counterpart of ``lb2d_tpu.models.pipe_flow``).

Step order as in the reference (``opencl_dim.py:380-387``): stream ->
Zou-He pressure BCs -> [obstacle bounce-back] -> hydro -> feq -> BGK.

Backends, each a hand-written CUDA kernel of :mod:`lb2d_tpu_torch.ops.fused`
on a CUDA device, ping-ponging between two buffers, any ``ny x nx``:

* ``"resident"`` (K3, :func:`~lb2d_tpu_torch.ops.fused.resident_pipe_run`):
  the whole ``run(n)`` in one launch, the grid held in shared memory (up
  to about 790^2 cells, 16 x 4096 among the wide ones; a grid it cannot
  hold raises when the backend is built). ``"auto"``
  picks it on CUDA for grids of up to ``RESIDENT_MAX_CELLS`` cells, where
  the host's launch per step would set the pace.
* ``"temporal"`` (K2, :func:`~lb2d_tpu_torch.ops.fused.temporal_pipe_step`):
  ``TEMPORAL_K`` steps per pass over ``f``, the remainder of ``run(n)`` as
  one shorter pass. ``"auto"`` picks it on CUDA for larger grids.
* ``"kernel"`` (K1, :func:`~lb2d_tpu_torch.ops.fused.pipe_step`): one step
  per launch.
* ``"eager"`` (the default on the CPU; JAX's name ``"xla"`` is taken as
  an alias): the plain PyTorch step
  (:func:`~lb2d_tpu_torch.ops.fused.pipe_step_reference`). On a CUDA
  device it runs only when asked for by name.
* ``"native"``, by name only: ``run(n)`` runs all ``n`` steps in the C++
  CPU engine (:func:`lb2d_tpu_torch.native.native_run`), one copy of the
  state to the host and one back on any ``device``; ``make_step``, the
  getters and everything else use the eager step. float32 only.

JAX's ``"pipelined"`` and ``"fused"`` are both K1 here and raise
``NotImplementedError`` with the name to use.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import D2Q9, FlowUnits
from ..ops import _build
from ..ops.equilibrium import feq_incompressible, feq_quadratic
from ..ops.fused import (
    pipe_step,
    pipe_step_reference,
    resident_pipe_run,
    resident_scratch,
    supports_resident,
    temporal_pipe_step,
)
from ..ops.moments import (FIELDS, hydro_compressible, hydro_incompressible,
                           hydro_planes)
from ..utils.tracing import traced, traced_field
from .base import LBModel, plain_backend, resolve_device

__all__ = ["PipeFlow", "PipeFlowCylinder", "PipeFlowObstacles", "disk_mask",
           "TEMPORAL_K", "VELOCITY_TEMPORAL_K"]

TEMPORAL_K = 4  # steps per K2 pass: the fastest K at 4096^2 on an H100
# steps per launch of the velocity inlet's 32 x 32 K2 tiles (grids of up to
# 640^2; its row sweep above takes TEMPORAL_K, the fastest K per step
# there at 2048^2): of K = 3, 4, 6, 8 on an H100 (PERF.md, section 6) the
# steadiest end to end, as the tiles' 0.033-0.036 ms launch outlasts the
# host's 18-26 us a launch, so that the card sets the pace (the
# benchmark's 401^2 cell: 33,786-34,490 MLUPS in seven runs on two
# machines, against 31,768-38,483 at K = 6 and 22,764-32,307 at K = 4,
# which follow the host). JAX takes the largest of 8, 6, 4 that its chunks
# allow.
VELOCITY_TEMPORAL_K = 8
_KERNEL_IDS = {"resident": "K3", "temporal": "K2", "kernel": "K1"}
_NOT_PORTED = {
    "pipelined": "ported as backend='kernel' (ROADMAP.md queue 2, K1)",
    "fused": "ported as backend='kernel' (ROADMAP.md queue 2, K1)",
}


def disk_mask(nx: int, ny: int, cx: float, cy: float, radius: float) -> np.ndarray:
    """Circular obstacle mask: int32 ``[ny, nx]`` with 1 inside the disk."""
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
    return ((X - cx) ** 2 + (Y - cy) ** 2 <= radius**2).astype(np.int32)


class PipeFlow(LBModel):
    """2-D pressure-driven channel flow with Zou-He pressure inlet/outlet.

    Arguments as in the JAX ``PipeFlow`` (physical diameter, density,
    viscosity, pressure gradient, pipe length, resolution ``N``), plus
    ``device`` (default ``"cuda"``; a machine without CUDA raises). The
    random initial perturbation comes from ``np.random.RandomState(seed)``
    exactly as in JAX, so both packages start from the same bits.

    ``init_state=False`` builds the configuration only (units, grid, mask,
    backend) and no ``state``: :class:`~lb2d_tpu_torch.parallel.sharded.
    ShardedPipeFlow` builds each shard's state itself.
    """

    _kernel_backends = tuple(_KERNEL_IDS)  # the CUDA backends of this model
    _temporal_k = TEMPORAL_K  # steps per K2 launch

    def __init__(self, diameter=None, rho=None, viscosity=None,
                 pressure_grad=None, pipe_length=None, N=200,
                 time_prefactor=1.0, equilibrium="compressible",
                 convention="W", obstacle_mask=None, seed=0,
                 dtype=torch.float32, backend="auto", device="cuda",
                 init_state=True):
        self.units = FlowUnits(
            diameter=diameter, rho=rho, viscosity=viscosity,
            pressure_grad=pressure_grad, pipe_length=pipe_length, N=N,
            time_prefactor=time_prefactor, convention=convention,
            L_override=self._characteristic_length(diameter),
        )
        self.lattice = D2Q9
        self.equilibrium = equilibrium
        self.dtype = dtype
        self.omega = self.units.omega
        self.nx, self.ny = self._grid_dims()
        self.lx, self.ly = self.nx - 1, self.ny - 1
        self.inlet_rho, self.outlet_rho = self.units.inlet_outlet_rho(self.nx)
        if obstacle_mask is None:
            obstacle_mask = self._build_obstacle_mask()
        self._setup(obstacle_mask, seed, backend, device, init_state)

    def _setup(self, obstacle_mask, seed, backend, device, init_state=True):
        """Device, mask, backend and, with ``init_state``, the initial state
        and the step."""
        self.device = resolve_device(device)
        self.obstacle_mask = (
            None if obstacle_mask is None
            else torch.as_tensor(np.asarray(obstacle_mask, dtype=bool),
                                 device=self.device))
        self.backend = self._pick_backend(backend)
        self.seed = seed
        if not init_state:
            return
        self.state = self._init_state(np.random.RandomState(seed))
        LBModel.__init__(self)

    def _pick_backend(self, backend):
        backend = plain_backend(backend)
        if backend in _NOT_PORTED:
            raise NotImplementedError(f"backend={backend!r}: "
                                      f"{_NOT_PORTED[backend]}")
        if backend == "eager":
            return backend
        if backend == "native":
            if self.dtype != torch.float32:
                raise ValueError(f"the C++ engine (backend='native') is "
                                 f"float32 only, not {self.dtype}")
            return backend
        if backend != "auto" and backend not in _KERNEL_IDS:
            raise ValueError(f"unknown backend {backend!r}; use 'auto', "
                             f"{', '.join(map(repr, _KERNEL_IDS))}, 'eager' "
                             "or 'native'")
        if backend != "auto" and backend not in self._kernel_backends:
            ported = ", ".join(f"{b!r} ({_KERNEL_IDS[b]})"
                               for b in self._kernel_backends)
            raise NotImplementedError(
                f"backend={backend!r} is not ported for "
                f"{type(self).__name__}; its CUDA backends are {ported}")
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
            return ("resident" if "resident" in self._kernel_backends
                    and supports_resident(self.ny, self.nx) else "temporal")
        return backend

    # --- geometry hooks (overridden by subclasses) -----------------------------
    def _characteristic_length(self, diameter):
        return None  # default: L = diameter (FlowUnits default)

    def _grid_dims(self):
        return self.units.grid_dims()

    def _build_obstacle_mask(self):
        return None

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny

    # --- initialization (opencl_dim.py:258-327) ----------------------------------
    def _init_perturb(self, rng: np.random.RandomState) -> np.ndarray:
        """0.1% multiplicative Gaussian perturbation (opencl_dim.py:318-321)."""
        return (1.0 + 0.001 * rng.randn(self.lattice.q, self.ny, self.nx)
                ).astype(np.float32)

    def _init_state(self, rng: np.random.RandomState) -> torch.Tensor:
        """feq of the linear inlet -> outlet density ramp (opencl_dim.py:
        279-283) times the perturbation."""
        return self._init_from_perturb(self._init_perturb(rng), self.device)

    def _init_from_perturb(self, perturb: np.ndarray, device,
                           x0: int = 0) -> torch.Tensor:
        """feq of the density ramp times ``perturb`` (``[9, rows, cols]``, a
        block of the grid whose first column is global column ``x0``) on
        ``device``: the whole state, or one shard's."""
        rows, cols = perturb.shape[1:]
        like = dict(dtype=self.dtype, device=device)
        ramp = self.inlet_rho - np.arange(x0, x0 + cols) * (
            (self.inlet_rho - self.outlet_rho) / float(self.nx))
        rho0 = np.broadcast_to(ramp[None, :], (rows, cols)).astype(np.float32)
        rho0 = torch.as_tensor(rho0, **like)
        zeros = torch.zeros((rows, cols), **like)
        # broadcasting can leave a transposed layout; the kernel needs C order
        return (self._feq_fn()(rho0, zeros, zeros)
                * torch.as_tensor(perturb, **like)).contiguous()

    # --- step construction ---------------------------------------------------------
    @property
    def _incompressible(self) -> bool:
        """Whether ``equilibrium`` is the He-Luo incompressible form."""
        return self.equilibrium == "incompressible"

    def _feq_fn(self):
        return feq_incompressible if self._incompressible else feq_quadratic

    def _hydro_fn(self):
        return (hydro_incompressible if self._incompressible
                else hydro_compressible)

    def _step_kwargs(self):
        return dict(omega=self.omega, inlet_rho=self.inlet_rho,
                    outlet_rho=self.outlet_rho,
                    incompressible=self._incompressible)

    def make_step(self):
        if self.backend == "native":
            native.build()  # build now, outside any timed region
            self._run_n = self._native_run_n
        if self.backend in ("eager", "native"):
            return self._make_eager_step()
        return self._make_kernel_step()

    def _native_run_n(self, f, n):
        """``n`` steps in the C++ engine: one copy of ``f`` to the host, one
        of the result back to the model's device."""
        mask = self.obstacle_mask
        out = native.native_run(
            f.cpu(), n, omega=self.omega, inlet_rho=self.inlet_rho,
            outlet_rho=self.outlet_rho,
            incompressible=self._incompressible,
            mask=None if mask is None else mask.cpu())
        return torch.from_numpy(out).to(self.device)

    def _make_eager_step(self):
        kw = self._step_kwargs()
        mask = self.obstacle_mask
        return lambda f: pipe_step_reference(f, mask=mask, **kw)

    def _kernels(self, mask):
        """K3's run, K2's step and the keyword arguments of both (and of
        K1's step), for the int32 obstacle ``mask`` or None."""
        return (resident_pipe_run, temporal_pipe_step,
                dict(self._step_kwargs(), mask=mask))

    def _make_kernel_step(self):
        """The kernel backends: K1 and K2 over two buffers, each launch
        writing into the buffer the previous one read, K3 in place with its
        exchange buffer, so ``run`` allocates nothing. K2 runs ``run(n)`` as
        launches of ``_temporal_k`` steps and one of the rest, K3 as one
        launch. Sets the run hooks of :class:`LBModel` that the backend
        needs."""
        _build.load_library()  # build now, outside any timed region
        resident_run, temporal_step, kw = self._kernels(
            None if self.obstacle_mask is None
            else self.obstacle_mask.to(torch.int32).contiguous())
        if self.backend == "resident":
            scratch = resident_scratch(self.state)

            def run_n(f, n):  # K3, in place
                return resident_run(f, scratch, n, **kw)

            self._run_n = run_n
            return lambda f: run_n(f, 1)
        spare = [torch.empty_like(self.state)]
        if self.backend == "kernel":
            def one(f):  # K1
                out = pipe_step(f, spare[0], **kw)
                spare[0] = f
                return out

            return one
        K = self.steps_per_call = self._temporal_k

        def step(f, k=K):  # K2
            out = temporal_step(f, spare[0], k, **kw)
            spare[0] = f
            return out

        def run_n(f, n):
            while n > 0:
                k = min(n, K)
                f = step(f, k)
                n -= k
            return f

        self._run_n = run_n
        return step

    @traced_field
    def device_field(self, name):
        """One 2-D field (``"rho"``, ``"u"`` or ``"v"``) as a device tensor
        ``[ny, nx]``, without a copy to the host; None for another name. On
        a float32 CUDA state one launch of the moments kernel that writes
        only this plane (:func:`~lb2d_tpu_torch.ops.moments.hydro_planes`)."""
        if name not in FIELDS:
            return None
        return hydro_planes(self.state, (name,), self._incompressible)[0]

    # --- field access (opencl_dim.py:390-438) --------------------------------------
    @traced("lb2d.readout.get_fields")
    def get_fields(self) -> dict:
        """All fields in LB units, as numpy arrays indexed ``[x, y]``
        (``f``/``feq`` as ``[9, nx, ny]``) to match the reference layout."""
        return self._fields(self._hydro_fn())

    def _fields(self, hydro) -> dict:
        f = self.state
        rho, u, v = hydro(f)
        feq = self._feq_fn()(rho, u, v)
        return {
            "f": self._to_host_xy(f),
            "feq": self._to_host_xy(feq),
            "rho": self._to_host_xy(rho),
            "u": self._to_host_xy(u),
            "v": self._to_host_xy(v),
        }

    def get_nondim_fields(self) -> dict:
        fields = self.get_fields()
        scale = self.units.velocity_lb_to_nondim
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields

    def get_physical_fields(self) -> dict:
        fields = self.get_nondim_fields()
        scale = self.units.velocity_nondim_to_phys
        fields["u"] = fields["u"] * scale
        fields["v"] = fields["v"] * scale
        return fields


class PipeFlowCylinder(PipeFlow):
    """Flow around a cylinder (``opencl_dim.py:441-518``): the characteristic
    length is the cylinder radius, and a disk of radius N cells is placed at
    the physical cylinder center."""

    def __init__(self, cylinder_center=None, cylinder_radius=None, **kwargs):
        if cylinder_center is None or cylinder_radius is None:
            raise ValueError("cylinder_center and cylinder_radius are required")
        self.phys_cylinder_center = cylinder_center
        self.phys_cylinder_radius = cylinder_radius
        super().__init__(**kwargs)

    def _characteristic_length(self, diameter):
        return self.phys_cylinder_radius  # opencl_dim.py:448-456

    def _grid_dims(self):
        # ly from the pipe diameter, in cylinder radii (opencl_dim.py:458-465)
        return self.units.grid_dims(transverse_extent=self.units.diameter)

    def _build_obstacle_mask(self):
        N, L = self.units.N, self.units.L
        cx = N * self.phys_cylinder_center[0] / L
        cy = N * self.phys_cylinder_center[1] / L
        return disk_mask(self.nx, self.ny, cx, cy, N)  # radius = N cells


class PipeFlowObstacles(PipeFlow):
    """Pipe flow with a user obstacle mask (``OLD/python.py:417-473``),
    indexed ``[ny, nx]``."""

    def __init__(self, obstacle_mask=None, **kwargs):
        if obstacle_mask is None or not np.asarray(obstacle_mask).any():
            raise ValueError("PipeFlowObstacles needs a non-empty obstacle_mask")
        super().__init__(obstacle_mask=obstacle_mask, **kwargs)
