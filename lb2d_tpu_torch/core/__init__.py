"""Lattice descriptors and the unit system.

``lattice`` and ``nondim`` are the port's own copies of the numpy-only
modules of ``lb2d_tpu.core``; the port imports nothing of the JAX package.
"""

from .lattice import D2Q9, D2Q25, Lattice
from .nondim import (
    DiffusionUnits,
    FlowUnits,
    diffusive_scaling,
    omega_from_lb_visc,
)

__all__ = ["D2Q9", "D2Q25", "Lattice", "FlowUnits", "DiffusionUnits",
           "diffusive_scaling", "omega_from_lb_visc"]
