"""Hydrodynamic moments (counterpart of ``lb2d_tpu.ops.moments``)."""

from __future__ import annotations

import torch

from ..core import D2Q9, Lattice
from ..utils.tracing import traced

__all__ = ["density", "momentum", "hydro_compressible", "hydro_incompressible",
           "rho_poisson"]


@traced("lb2d.wait.c_consts")
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


def rho_poisson(f: torch.Tensor, lattice: Lattice = D2Q9) -> torch.Tensor:
    """``rho = (1/(1-w_0)) * sum_{j>=1} f_j``; for D2Q9 the prefactor is 9/5
    (``D2Q9_poisson.cl:59``). The populations are added in direction order,
    as JAX's sum adds them (``torch.sum`` adds in another order)."""
    total = f[1]
    for j in range(2, lattice.q):
        total = total + f[j]
    return (1.0 / (1.0 - lattice.w[0])) * total
