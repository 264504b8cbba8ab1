"""Lattice-units pipe-flow API (counterpart of
``lb2d_tpu.models.lattice_units``, the reference's ``OLD`` module)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..ops import _build
from ..ops.fused import (
    resident_scratch,
    resident_velocity_run,
    temporal_velocity_step,
    velocity_step_reference,
)
from ..ops.moments import hydro_compressible
from ..utils.tracing import span, traced
from .pipe_flow import VELOCITY_TEMPORAL_K, PipeFlow

__all__ = ["LatticePipeFlow", "LatticePipeFlowPeriodicBC",
           "PipeFlowVelocityInlet"]


class LatticePipeFlow(PipeFlow):
    """``Pipe_Flow`` in raw lattice units (``OLD/python.py:24``); same step
    and backends as :class:`PipeFlow`."""

    def __init__(self, omega=0.99, lx=400, ly=400, dr=1.0, dt=1.0,
                 deltaP=-0.1, equilibrium="compressible", obstacle_mask=None,
                 seed=0, dtype=torch.float32, backend="auto", device="cuda"):
        self.lx, self.ly = int(lx), int(ly)
        self.dr, self.dt_lattice, self.deltaP = dr, dt, deltaP
        self.units = None  # no physical-units layer
        self.lattice = D2Q9
        self.equilibrium = equilibrium
        self.dtype = dtype
        self.omega = float(omega)
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")
        self.nx, self.ny = self.lx + 1, self.ly + 1
        # OLD/python.py:38-39: deltaP is negative
        self.inlet_rho = 1.0
        self.outlet_rho = deltaP / self.lattice.cs2 + self.inlet_rho
        self._setup(obstacle_mask, seed, backend, device)
        self.update_dimensionless_nums()

    def update_dimensionless_nums(self):
        """Diagnostic viscosity / Re / Ma from omega (``OLD/python.py:56-64``)."""
        dr, dt = self.dr, self.dt_lattice
        self.viscosity = (dr**2 / (3 * dt)) * (self.omega - 0.5)
        _, u, v = self._hydro_fn()(self.state)
        with span("lb2d.wait.dimensionless_nums"):
            U = float(torch.sqrt(u * u + v * v).max())
        L = self.ly * dr
        self.Re = U * L / self.viscosity if self.viscosity else float("inf")
        self.Ma = (dr / (L * np.sqrt(3.0))) * (self.omega - 0.5) * self.Re
        return self.viscosity, self.Re, self.Ma

    def get_nondim_fields(self):
        raise NotImplementedError(
            "LatticePipeFlow is the lattice-units API (OLD module); use "
            "PipeFlow for unit conversions")

    get_physical_fields = get_nondim_fields


# The OLD module's Pipe_Flow_PeriodicBC is behaviourally the base class
# (DIVERGENCES.md #18); aliased so the name exists.
LatticePipeFlowPeriodicBC = LatticePipeFlow


class PipeFlowVelocityInlet(LatticePipeFlow):
    """Zou-He velocity inlet with y-periodic walls
    (``OLD/opencl.py:281-375``), with the stability fixes of DIVERGENCES.md
    #20-21; uniform initial state rho = 1, u = u_w, v = 0.

    On CUDA ``"auto"`` runs K2 with the velocity BCs (``backend="temporal"``,
    :func:`~lb2d_tpu_torch.ops.fused.temporal_velocity_step`: 32 x 32 tiles
    up to 640^2, the row sweep above), as the JAX model runs
    ``make_temporal_pipe_step(physics="velocity_inlet")`` on a TPU:
    ``VELOCITY_TEMPORAL_K`` (4) steps per launch, on an H100 the fastest K
    per step on the sweep and the steadiest end to end in the tiles (JAX
    takes the largest of 8, 6, 4 that its chunks allow), and one shorter
    launch for the rest of ``run(n)``. ``backend="resident"``, asked for by
    name, runs all of ``run(n)`` as one K3 launch with the same BCs
    (:func:`~lb2d_tpu_torch.ops.fused.resident_velocity_run`).
    """

    _kernel_backends = ("temporal", "resident")

    def __init__(self, u_w=0.1, omega=0.99, lx=400, ly=400,
                 outlet="zero_gradient", **kwargs):
        self.u_w = float(u_w)
        self.u_e = float(u_w)
        if outlet not in ("zero_gradient", "velocity"):
            raise ValueError(f"outlet must be 'zero_gradient' or 'velocity', "
                             f"not {outlet!r}")
        self.outlet = outlet
        super().__init__(omega=omega, lx=lx, ly=ly, deltaP=0.0, **kwargs)

    def _init_state(self, rng):
        ny, nx = self.ny, self.nx
        like = dict(dtype=self.dtype, device=self.device)
        rho0 = torch.ones((ny, nx), **like)
        u0 = torch.full((ny, nx), self.u_w, **like)
        v0 = torch.zeros((ny, nx), **like)
        return self._feq_fn()(rho0, u0, v0).contiguous()

    def _pick_backend(self, backend):
        if backend == "native":
            raise ValueError(
                "backend='native': the C++ engine has the pressure BCs only, "
                "not the velocity inlet; use 'auto', 'temporal', 'resident' "
                "or 'eager'")
        picked = super()._pick_backend(backend)
        if backend == "auto" and picked == "resident":
            return "temporal"  # the JAX model's choice at every grid size
        return picked

    def _velocity_kwargs(self, mask):
        return dict(omega=self.omega, u_w=self.u_w, u_e=self.u_e,
                    outlet=self.outlet,
                    incompressible=self._incompressible,
                    mask=mask)

    def _make_eager_step(self):
        kw = self._velocity_kwargs(self.obstacle_mask)
        return lambda f: velocity_step_reference(f, **kw)

    def _make_kernel_step(self):
        """K2 over two buffers, ``run(n)`` as ``n // VELOCITY_TEMPORAL_K``
        launches and one of ``n % VELOCITY_TEMPORAL_K`` steps; or K3,
        ``run(n)`` as one launch."""
        _build.load_library()  # build now, outside any timed region
        kw = self._velocity_kwargs(
            None if self.obstacle_mask is None
            else self.obstacle_mask.to(torch.int32).contiguous())
        if self.backend == "resident":
            scratch = resident_scratch(self.state)

            def run_resident(f, n):  # K3, in place
                return resident_velocity_run(f, scratch, n, **kw)

            self._run_n = run_resident
            return lambda f: run_resident(f, 1)
        spare = [torch.empty_like(self.state)]

        def step(f, k=1):
            out = temporal_velocity_step(f, spare[0], k, **kw)
            spare[0] = f
            return out

        def run_n(f, n):
            while n > 0:
                k = min(n, VELOCITY_TEMPORAL_K)
                f = step(f, k)
                n -= k
            return f

        self._run_n = run_n
        return step

    @traced("lb2d.readout.get_fields")
    def get_fields(self) -> dict:
        return self._fields(hydro_compressible)
