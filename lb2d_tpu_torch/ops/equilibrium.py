"""Equilibrium distributions (counterpart of ``lb2d_tpu.ops.equilibrium``).

Constants are tensors of the field's dtype on its device, rounded as the
JAX module rounds them, so both packages evaluate the same float32
expressions. They come from :func:`lattice_columns`, the port's one source
of the lattice's columns, made once per lattice, dtype, device and rank
and then reused, so that a call copies nothing from the host (and can be
captured in a CUDA graph once it has run).
"""

from __future__ import annotations

import functools

import torch

from ..core import D2Q9, Lattice

__all__ = ["feq_quadratic", "feq_incompressible", "feq_linear", "feq_poisson",
           "lattice_columns"]


def _consts(lattice: Lattice, rho: torch.Tensor):
    """:func:`lattice_columns` shaped to broadcast against ``rho`` of any
    rank (``[ny, nx]``, or ``[F, ny, nx]`` for the multifield models)."""
    return lattice_columns(lattice, rho.dtype, rho.device, rho.dim())


@functools.lru_cache(maxsize=None)
def lattice_columns(lattice: Lattice, dtype, device, rank: int = 2):
    """The lattice's columns as tensors of ``dtype`` on ``device``, each
    ``(Q,)`` followed by ``rank`` ones: ``w``, ``cx``, ``cy``, then the
    scalar ``cs2`` and ``w - e_0`` (the Poisson weights). Made once per
    (lattice, dtype, device, rank), so that a later call copies nothing
    from the host and waits for nothing. The tensors are shared by every
    caller and read-only: never write into them."""
    def col(values):
        return torch.tensor(values, dtype=dtype, device=device
                            ).reshape((len(values),) + (1,) * rank)

    cs2 = torch.tensor(lattice.cs2, dtype=dtype, device=device)
    w = col(lattice.w)
    rest = col((1.0,) + (0.0,) * (lattice.q - 1))
    return w, col(lattice.cx), col(lattice.cy), cs2, w - rest


def feq_quadratic(rho, u, v, lattice: Lattice = D2Q9) -> torch.Tensor:
    """``w_j rho (1 + c.u/cs2 + (c.u)^2/(2 cs4) - u^2/(2 cs2))``
    (``D2Q9.cl:55-60``)."""
    w, cx, cy, cs2, _ = _consts(lattice, rho)
    cu = cx * u + cy * v
    usq = u * u + v * v
    inner = 1.0 + cu / cs2 + (cu * cu) / (2.0 * cs2 * cs2) - usq / (2.0 * cs2)
    return w * rho * inner


def feq_incompressible(rho, u, v, lattice: Lattice = D2Q9) -> torch.Tensor:
    """He-Luo: ``w_j (rho + c.u/cs2 + (c.u)^2/(2 cs4) - u^2/(2 cs2))``
    (``D2Q9i.cl:55-60``)."""
    w, cx, cy, cs2, _ = _consts(lattice, rho)
    cu = cx * u + cy * v
    usq = u * u + v * v
    inner = rho + cu / cs2 + (cu * cu) / (2.0 * cs2 * cs2) - usq / (2.0 * cs2)
    return w * inner


def feq_linear(rho, u, v, lattice: Lattice = D2Q9) -> torch.Tensor:
    """Advection-diffusion feq, linear in velocity:
    ``w_j rho (1 + c.u/cs2)`` (``D2Q9_diffusion.cl:27-36``)."""
    w, cx, cy, cs2, _ = _consts(lattice, rho)
    cu = cx * u + cy * v
    return w * rho * (1.0 + cu / cs2)


def feq_poisson(rho, lattice: Lattice = D2Q9) -> torch.Tensor:
    """Chai-Shi Poisson-equation feq: ``(w_0 - 1) rho`` for the rest
    population, ``w_j rho`` otherwise (``D2Q9_poisson.cl:17-29``)."""
    return _consts(lattice, rho)[4] * rho
