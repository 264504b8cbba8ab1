"""Hydrodynamic moments (counterpart of ``lb2d_tpu.ops.moments``).

:func:`density`, :func:`momentum` and :func:`rho_poisson` are plain
PyTorch. The flow moments (rho, u, v) go where the state says
(:func:`hydro_planes`): a float32 state on the card to the hand-written
kernel :func:`flow_moments` (``csrc/moments.cu``), which reads ``f`` once,
writes only the planes asked for and waits for nothing; any other state
(a CPU tensor, or the eager backend's other dtypes) to the plain
functions.
"""

from __future__ import annotations

import torch

from ..core import D2Q9, Lattice
from ..utils.tracing import traced_launch
from .equilibrium import lattice_columns
from .fused import _launch

__all__ = ["FIELDS", "density", "momentum", "hydro_compressible",
           "hydro_incompressible", "hydro_planes", "flow_moments",
           "rho_poisson"]

FIELDS = ("rho", "u", "v")


def density(f: torch.Tensor) -> torch.Tensor:
    """``rho = sum_j f_j`` over the direction axis."""
    return f.sum(dim=0)


def momentum(f: torch.Tensor, lattice: Lattice = D2Q9):
    """``(sum_j cx_j f_j, sum_j cy_j f_j)``."""
    _, cx, cy, _, _ = lattice_columns(lattice, f.dtype, f.device,
                                      f.dim() - 1)
    return (cx * f).sum(dim=0), (cy * f).sum(dim=0)


def _hydro_plain(f: torch.Tensor, lattice: Lattice, incompressible: bool):
    """(rho, u, v) by the plain functions: velocity = momentum / density
    (``D2Q9.cl:92-97``), or = momentum (``D2Q9i.cl:90-94``)."""
    rho = density(f)
    jx, jy = momentum(f, lattice)
    if incompressible:
        return rho, jx, jy
    inv = 1.0 / rho
    return rho, jx * inv, jy * inv


def _plain_planes(f, fields, incompressible, lattice=D2Q9):
    """The planes ``fields`` of :func:`_hydro_plain`'s three."""
    planes = dict(zip(FIELDS, _hydro_plain(f, lattice, incompressible)))
    return tuple(planes[name] for name in fields)


def hydro_planes(f: torch.Tensor, fields=FIELDS, incompressible=False,
                 lattice: Lattice = D2Q9):
    """The planes ``fields`` of (rho, u, v) of ``f [q, ny, nx]``, in that
    order, chosen by what ``f`` shows: float32 off the CPU goes to
    :func:`flow_moments`, which launches the kernel on a CUDA device (D2Q9
    only) or raises; a CPU tensor, or another dtype, runs the plain
    functions (all three moments, the asked planes returned). The one
    place where the device and dtype decide."""
    if f.dtype == torch.float32 and f.device.type != "cpu":
        if lattice != D2Q9:
            raise ValueError(f"the moments kernel is D2Q9's, not "
                             f"{lattice.name}'s")
        return flow_moments(f, fields, incompressible)
    return _plain_planes(f, fields, incompressible, lattice)


def hydro_compressible(f: torch.Tensor, lattice: Lattice = D2Q9):
    """(rho, u, v) with velocity = momentum / density (``D2Q9.cl:92-97``);
    where it runs: :func:`hydro_planes`."""
    return hydro_planes(f, FIELDS, False, lattice)


def hydro_incompressible(f: torch.Tensor, lattice: Lattice = D2Q9):
    """(rho, u, v) with velocity = momentum (``D2Q9i.cl:90-94``); where it
    runs: :func:`hydro_planes`."""
    return hydro_planes(f, FIELDS, True, lattice)


@traced_launch
def flow_moments(f: torch.Tensor, fields=FIELDS, incompressible=False):
    """The planes ``fields`` (names of ``FIELDS``, each at most once, in
    any order) of a D2Q9 state ``f [9, ny, nx]`` (float32, contiguous, on
    the card), as a tuple of new ``[ny, nx]`` tensors, by one launch of the
    kernel of ``csrc/moments.cu``, counted in ``flow_moments.launches``.
    ``incompressible`` takes u = j (He-Luo), else u = j / rho. The kernel
    sums the directions in direction order, the plain version in
    torch.sum's (a few ulp of rho apart)."""
    if f.device.type == "cpu":
        raise ValueError("flow_moments launches on the card; f is on the "
                         "CPU (hydro_planes runs the plain moments there)")
    if f.dtype != torch.float32 or f.dim() != 3 or f.shape[0] != 9 \
            or not f.is_contiguous():
        raise ValueError(f"f must be a contiguous float32 [9, ny, nx] state, "
                         f"got {f.dtype} {tuple(f.shape)}")
    fields = tuple(fields)
    if not fields or len(set(fields)) != len(fields) \
            or not set(fields) <= set(FIELDS):
        raise ValueError(f"fields must name some of {FIELDS} once each, got "
                         f"{fields}")
    ny, nx = f.shape[1:]
    planes = tuple(torch.empty((len(fields), ny, nx), dtype=f.dtype,
                               device=f.device))
    asked = dict(zip(fields, planes))
    with torch.cuda.device(f.device):
        _launch("lb2d_moments", f, asked.get("rho"), asked.get("u"),
                asked.get("v"), ny * nx, int(bool(incompressible)))
    flow_moments.launches += 1
    return planes


flow_moments.launches = 0


def rho_poisson(f: torch.Tensor, lattice: Lattice = D2Q9) -> torch.Tensor:
    """``rho = (1/(1-w_0)) * sum_{j>=1} f_j``; for D2Q9 the prefactor is 9/5
    (``D2Q9_poisson.cl:59``). The populations are added in direction order,
    as JAX's sum adds them (``torch.sum`` adds in another order)."""
    total = f[1]
    for j in range(2, lattice.q):
        total = total + f[j]
    return (1.0 / (1.0 - lattice.w[0])) * total
