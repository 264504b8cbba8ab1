"""Hydrodynamic moments (counterpart of ``lb2d_tpu.ops.moments``)."""

from __future__ import annotations

import torch

from ..core import D2Q9, Lattice

__all__ = ["density", "momentum", "hydro_compressible", "hydro_incompressible"]


def _c_consts(lattice: Lattice, f: torch.Tensor):
    cx = torch.tensor(lattice.cx, dtype=f.dtype, device=f.device)[:, None, None]
    cy = torch.tensor(lattice.cy, dtype=f.dtype, device=f.device)[:, None, None]
    return cx, cy


def density(f: torch.Tensor) -> torch.Tensor:
    """``rho = sum_j f_j`` over the direction axis."""
    return f.sum(dim=0)


def momentum(f: torch.Tensor, lattice: Lattice = D2Q9):
    """``(sum_j cx_j f_j, sum_j cy_j f_j)``."""
    cx, cy = _c_consts(lattice, f)
    return (cx * f).sum(dim=0), (cy * f).sum(dim=0)


def hydro_compressible(f: torch.Tensor, lattice: Lattice = D2Q9):
    """(rho, u, v) with velocity = momentum / density (``D2Q9.cl:92-97``)."""
    rho = density(f)
    jx, jy = momentum(f, lattice)
    inv = 1.0 / rho
    return rho, jx * inv, jy * inv


def hydro_incompressible(f: torch.Tensor, lattice: Lattice = D2Q9):
    """(rho, u, v) with velocity = momentum (``D2Q9i.cl:90-94``)."""
    rho = density(f)
    jx, jy = momentum(f, lattice)
    return rho, jx, jy
