"""Nondimensionalization: physical units -> lattice units.

A copy of the numpy-only ``lb2d_tpu.core.nondim``: the port imports
nothing of the JAX package.

This is the reference project's centerpiece "dimensionless" layer, rebuilt as
pure dataclasses (no device code). Two conventions exist in the reference and
both are preserved:

* **W convention** (``dimensionless/opencl_dim.py:102-120``):
  ``W = |dP/dx / rho| * L * T / nu``, ``nu_lb = (dt/dx^2) / W``,
  ``omega = (3 nu_lb + 0.5)^-1`` and ``T = sqrt(L / (|dP/dx|/rho))``.

* **Re convention** (``dimensionless/python_dim.py:61-81`` and
  ``dimensionless/opencl_dim_D2Q9i.py:98-119``):
  ``T = 8 rho nu / (|dP/dx| L)``, ``Re = L^2 / (nu T^2)``,
  ``nu_lb = (dt/dx^2) / Re``, ``omega = (nu_lb/cs^2 + 0.5)^-1``.

Both use **diffusive scaling** (``python_dim.py:65-67``):
``delta_x = 1/N``, ``delta_t = time_prefactor * delta_x^2``, which keeps
``omega`` resolution-independent.

Fields convert LB -> nondimensional -> physical exactly as
``opencl_dim.py:417-438``: velocity scales by ``delta_x/delta_t`` then ``L/T``.
"""

from __future__ import annotations

import dataclasses
import math

from .lattice import D2Q9

__all__ = [
    "diffusive_scaling",
    "omega_from_lb_visc",
    "FlowUnits",
    "DiffusionUnits",
]

_CS2 = D2Q9.cs2  # 1/3


def diffusive_scaling(N: int, time_prefactor: float = 1.0) -> tuple[float, float]:
    """``delta_x = 1/N``, ``delta_t = time_prefactor * delta_x**2``
    (``python_dim.py:65-67``)."""
    delta_x = 1.0 / N
    delta_t = time_prefactor * delta_x**2
    return delta_x, delta_t


def omega_from_lb_visc(lb_visc: float) -> float:
    """BGK relaxation rate from an LB-unit viscosity/diffusivity:
    ``omega = (nu_lb/cs^2 + 0.5)^-1`` (``python_dim.py:79-81``; the
    ``(3 nu_lb + 0.5)^-1`` form at ``opencl_dim.py:118`` is identical since
    ``cs^2 = 1/3``). Raises if ``omega >= 2`` (unstable; ``opencl_dim.py:120``).
    """
    omega = 1.0 / (lb_visc / _CS2 + 0.5)
    if not omega < 2.0:
        raise ValueError(f"omega = {omega} >= 2 is unstable; increase resolution "
                         "or time_prefactor")
    return omega


@dataclasses.dataclass(frozen=True)
class FlowUnits:
    """Unit system for the pressure-driven pipe-flow family.

    Args mirror ``Pipe_Flow.__init__`` (``opencl_dim.py:64-120``): physical
    diameter, density, kinematic viscosity, pressure gradient, pipe length,
    resolution N (cells per characteristic length), and time prefactor.

    ``convention`` selects between the reference's two derivations:
    ``"W"`` (opencl_dim.py, default there) or ``"Re"`` (python_dim.py /
    opencl_dim_D2Q9i.py). ``L_override`` lets subclasses redefine the
    characteristic length (cylinder radius, ``opencl_dim.py:448-456``).
    """

    diameter: float
    rho: float
    viscosity: float
    pressure_grad: float
    pipe_length: float
    N: int = 200
    time_prefactor: float = 1.0
    convention: str = "W"
    L_override: float | None = None

    # ---- characteristic scales -------------------------------------------
    @property
    def L(self) -> float:
        return self.L_override if self.L_override is not None else self.diameter

    @property
    def T(self) -> float:
        zeta = abs(self.pressure_grad) / self.rho
        if self.convention == "W":
            # opencl_dim.py:186-189
            return math.sqrt(self.L / zeta)
        # python_dim.py:106-107: time for fluid at theoretical max to cross L
        return (8.0 * self.rho * self.viscosity) / (abs(self.pressure_grad) * self.L)

    @property
    def dimensionless_group(self) -> float:
        """W number (opencl_dim.py:103) or Re (python_dim.py:61)."""
        if self.convention == "W":
            zeta = abs(self.pressure_grad) / self.rho
            return zeta * self.L * self.T / self.viscosity
        return self.L**2 / (self.viscosity * self.T**2)

    # ---- lattice scales ---------------------------------------------------
    @property
    def delta_x(self) -> float:
        return diffusive_scaling(self.N, self.time_prefactor)[0]

    @property
    def delta_t(self) -> float:
        return diffusive_scaling(self.N, self.time_prefactor)[1]

    @property
    def ulb(self) -> float:
        """Lattice velocity scale ``delta_t/delta_x`` (opencl_dim.py:111)."""
        return self.delta_t / self.delta_x

    @property
    def lb_viscosity(self) -> float:
        # opencl_dim.py:116 / python_dim.py:76-77
        return (self.delta_t / self.delta_x**2) / self.dimensionless_group

    @property
    def omega(self) -> float:
        return omega_from_lb_visc(self.lb_viscosity)

    # ---- grid -------------------------------------------------------------
    def grid_dims(self, transverse_extent: float | None = None) -> tuple[int, int]:
        """(nx, ny) including the boundary ring (``opencl_dim.py:191-201``).

        ``transverse_extent`` is the physical size in y; defaults to the
        characteristic length L (plain pipe: ly = N). The cylinder subclass
        passes the pipe diameter here (``opencl_dim.py:458-465``).
        """
        lx = int(math.ceil((self.pipe_length / self.L) * self.N))
        if transverse_extent is None:
            ly = self.N
        else:
            ly = int(math.ceil((transverse_extent / self.L) * self.N))
        return lx + 1, ly + 1

    # ---- boundary densities -------------------------------------------------
    def inlet_outlet_rho(self, nx: int) -> tuple[float, float]:
        """Zou-He pressure-BC densities (``opencl_dim.py:266-276``):
        ``delta_rho = nx * (dt^2/dx) * (1/cs^2) * nondim_gradP`` with the
        nondimensional pressure gradient taken as 1 (its magnitude is absorbed
        into T), ``outlet_rho = 1``, ``inlet_rho = 1 + |delta_rho|``.
        """
        delta_rho = nx * (self.delta_t**2 / self.delta_x) * (1.0 / _CS2) * 1.0
        return 1.0 + abs(delta_rho), 1.0

    # ---- unit conversion factors -------------------------------------------
    @property
    def velocity_lb_to_nondim(self) -> float:
        return self.delta_x / self.delta_t  # opencl_dim.py:423-424

    @property
    def velocity_nondim_to_phys(self) -> float:
        return self.L / self.T  # opencl_dim.py:435-436


@dataclasses.dataclass(frozen=True)
class DiffusionUnits:
    """Unit system for the advection-diffusion family
    (``reaction_diffusion/diffusion.py:168-185``): characteristic length is a
    user length ``z``, characteristic time ``T = z^2 / D`` so the
    dimensionless diffusivity is 1; ``D_lb = (dt/dx^2)``, giving
    ``omega = (D_lb/cs^2 + 0.5)^-1``.
    """

    z: float
    D: float
    N: int = 100
    time_prefactor: float = 1.0

    @property
    def L(self) -> float:
        return self.z

    @property
    def T(self) -> float:
        return self.z**2 / self.D

    @property
    def delta_x(self) -> float:
        return diffusive_scaling(self.N, self.time_prefactor)[0]

    @property
    def delta_t(self) -> float:
        return diffusive_scaling(self.N, self.time_prefactor)[1]

    @property
    def lb_diffusivity(self) -> float:
        return self.delta_t / self.delta_x**2

    @property
    def omega(self) -> float:
        return omega_from_lb_visc(self.lb_diffusivity)
