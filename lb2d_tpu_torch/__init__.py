"""lb2d_tpu_torch — the PyTorch / CUDA port of lb2d_tpu.

The JAX package ``lb2d_tpu`` stays the reference; this package mirrors its
layout (``core``, ``ops``, ``models``) with plain PyTorch functions on
tensors, and replaces each Pallas kernel with a CUDA kernel written for
Hopper (``csrc/``), built with ``nvcc`` on first use.

Populations are ``f[Q, ny, nx]`` float32 tensors, exactly the JAX layout, so
state moves between the two packages as a numpy array. This package never
imports ``jax`` or anything of ``lb2d_tpu``; ``core`` holds its own copies
of the JAX package's numpy-only lattice and unit modules.
"""

from .core import (
    D2Q9,
    D2Q25,
    DiffusionUnits,
    FlowUnits,
    Lattice,
    diffusive_scaling,
    omega_from_lb_visc,
)

__version__ = "0.1.0"

__all__ = ["D2Q9", "D2Q25", "Lattice", "FlowUnits", "DiffusionUnits",
           "diffusive_scaling", "omega_from_lb_visc"]
