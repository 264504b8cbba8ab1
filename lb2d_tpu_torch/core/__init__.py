"""Lattice descriptors and the unit system, shared with the JAX package.

``lb2d_tpu.core`` is numpy-only (importing ``lb2d_tpu`` pulls in no JAX),
so the port re-exports it instead of keeping a copy.
"""

from lb2d_tpu.core.lattice import D2Q9, Lattice
from lb2d_tpu.core.nondim import FlowUnits

__all__ = ["D2Q9", "Lattice", "FlowUnits"]
