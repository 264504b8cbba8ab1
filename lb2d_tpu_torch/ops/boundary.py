"""Boundary conditions (counterpart of ``lb2d_tpu.ops.boundary``).

The reference kernels read a per-cell snapshot of all 9 populations before
writing (``D2Q9.cl:187-195``). Here every formula reads the input ``f``,
and the results are written into a clone, so no formula ever sees a value
another formula wrote. Layout ``f[Q, ny, nx]``: ``x = 0`` inlet, ``x = nx-1``
outlet, ``y = 0`` south wall, ``y = ny-1`` north wall.
"""

from __future__ import annotations

import torch

from ..core import D2Q9, Lattice

__all__ = [
    "zou_he_pressure_bcs",
    "zou_he_pressure_bcs_incompressible",
    "zou_he_velocity_bcs",
    "zou_he_velocity_inlet_open_outlet",
    "bounce_back_obstacle",
]


def _scalar(x, f: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=f.dtype, device=f.device)


def zou_he_pressure_bcs(f: torch.Tensor, inlet_rho, outlet_rho) -> torch.Tensor:
    """Pressure inlet/outlet + solid walls + 4 corners (``D2Q9.cl:173-261``)."""
    inlet_rho, outlet_rho = _scalar(inlet_rho, f), _scalar(outlet_rho, f)

    s = f[:, 1:-1, 0]  # inlet column, interior rows (D2Q9.cl:198-203)
    u_in = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7] - inlet_rho)
             / inlet_rho)
    in1 = s[3] + (2.0 / 3.0) * inlet_rho * u_in
    in5 = -0.5 * s[2] + 0.5 * s[4] + s[7] + (1.0 / 6.0) * u_in * inlet_rho
    in8 = 0.5 * s[2] - 0.5 * s[4] + s[6] + (1.0 / 6.0) * u_in * inlet_rho

    s = f[:, 1:-1, -1]  # outlet column (D2Q9.cl:205-210)
    u_out = -1.0 + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8]) / outlet_rho
    out3 = s[1] - (2.0 / 3.0) * outlet_rho * u_out
    out6 = -0.5 * s[2] + 0.5 * s[4] + s[8] - (1.0 / 6.0) * u_out * outlet_rho
    out7 = 0.5 * s[2] - 0.5 * s[4] + s[5] - (1.0 / 6.0) * u_out * outlet_rho

    out = f.clone()
    out[1, 1:-1, 0], out[5, 1:-1, 0], out[8, 1:-1, 0] = in1, in5, in8
    out[3, 1:-1, -1], out[6, 1:-1, -1], out[7, 1:-1, -1] = out3, out6, out7
    _walls_and_corners(f, out, inlet_rho, outlet_rho)
    return out


def zou_he_pressure_bcs_incompressible(f: torch.Tensor, inlet_rho,
                                       outlet_rho) -> torch.Tensor:
    """He-Luo variant (``D2Q9i.cl:173-261``): the inlet/outlet velocities are
    momenta; walls and corners are the compressible ones."""
    inlet_rho, outlet_rho = _scalar(inlet_rho, f), _scalar(outlet_rho, f)

    s = f[:, 1:-1, 0]  # inlet (D2Q9i.cl:194-199)
    u_in = -s[0] - s[2] - 2 * s[3] - s[4] - 2 * s[6] - 2 * s[7] + inlet_rho
    in1 = (1.0 / 3.0) * (3 * s[3] + 2 * u_in)
    in5 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[7] + u_in)
    in8 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[6] + u_in)

    s = f[:, 1:-1, -1]  # outlet (D2Q9i.cl:201-206)
    u_out = s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8] - outlet_rho
    out3 = (1.0 / 3.0) * (3 * s[1] - 2 * u_out)
    out6 = (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[8] - u_out)
    out7 = (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[5] - u_out)

    out = f.clone()
    out[1, 1:-1, 0], out[5, 1:-1, 0], out[8, 1:-1, 0] = in1, in5, in8
    out[3, 1:-1, -1], out[6, 1:-1, -1], out[7, 1:-1, -1] = out3, out6, out7
    _walls_and_corners(f, out, inlet_rho, outlet_rho)
    return out


def _walls_and_corners(f, out, inlet_rho, outlet_rho):
    """Solid north/south walls + 4 corner nodes (``D2Q9.cl:212-259``), read
    from ``f`` and written into ``out``. The cells are disjoint from the
    inlet/outlet rows 1..ny-2 written before."""
    s = f[:, -1, 1:-1]
    out[4, -1, 1:-1] = s[2]
    out[8, -1, 1:-1] = 0.5 * (-s[1] + s[3] + 2 * s[6])
    out[7, -1, 1:-1] = 0.5 * (s[1] - s[3] + 2 * s[5])
    s = f[:, 0, 1:-1]
    out[2, 0, 1:-1] = s[4]
    out[6, 0, 1:-1] = 0.5 * (s[1] - s[3] + 2 * s[8])
    out[5, 0, 1:-1] = 0.5 * (-s[1] + s[3] + 2 * s[7])

    c = f[:, 0, 0]  # bottom inlet
    d = 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7] + inlet_rho)
    out[1, 0, 0], out[2, 0, 0], out[5, 0, 0] = c[3], c[4], c[7]
    out[6, 0, 0] = out[8, 0, 0] = d
    c = f[:, -1, 0]  # top inlet
    d = 0.5 * (-c[0] - 2 * c[2] - 2 * c[3] - 2 * c[6] + inlet_rho)
    out[1, -1, 0], out[4, -1, 0], out[8, -1, 0] = c[3], c[2], c[6]
    out[5, -1, 0] = out[7, -1, 0] = d
    c = f[:, 0, -1]  # bottom outlet
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[4] - 2 * c[8] + outlet_rho)
    out[3, 0, -1], out[2, 0, -1], out[6, 0, -1] = c[1], c[4], c[8]
    out[5, 0, -1] = out[7, 0, -1] = d
    c = f[:, -1, -1]  # top outlet
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[2] - 2 * c[5] + outlet_rho)
    out[3, -1, -1], out[4, -1, -1], out[7, -1, -1] = c[1], c[2], c[5]
    out[6, -1, -1] = out[8, -1, -1] = d


def zou_he_velocity_bcs(f: torch.Tensor, u_w, u_e) -> torch.Tensor:
    """Velocity inlet/outlet applied on the full columns, periodic top and
    bottom (``D2Q9.cl:263-321``; wrap-compatible form, DIVERGENCES.md #20)."""
    u_w, u_e = _scalar(u_w, f), _scalar(u_e, f)

    s = f[:, :, 0]  # inlet (D2Q9.cl:291-296)
    rho_w = (1.0 / (1.0 - u_w)) * (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7]))
    in1 = s[3] + (2.0 / 3.0) * rho_w * u_w
    in5 = s[7] - 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    in8 = s[6] + 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w

    s = f[:, :, -1]  # outlet (D2Q9.cl:298-303)
    rho_e = (1.0 / (1.0 + u_e)) * (s[0] + s[2] + s[4] + 2 * (s[1] + s[5] + s[8]))
    out3 = s[1] - (2.0 / 3.0) * rho_e * u_e
    out6 = s[5] + 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e
    out7 = s[8] - 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e

    out = f.clone()
    out[1, :, 0], out[5, :, 0], out[8, :, 0] = in1, in5, in8
    out[3, :, -1], out[6, :, -1], out[7, :, -1] = out3, out6, out7
    return out


def zou_he_velocity_inlet_open_outlet(f: torch.Tensor, u_w) -> torch.Tensor:
    """Zou-He velocity inlet (west) + zero-gradient open outlet (east),
    periodic top and bottom (DIVERGENCES.md #20/#21)."""
    u_w = _scalar(u_w, f)
    s = f[:, :, 0]
    rho_w = (1.0 / (1.0 - u_w)) * (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7]))
    in1 = s[3] + (2.0 / 3.0) * rho_w * u_w
    in5 = s[7] - 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    in8 = s[6] + 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w
    out = f.clone()
    out[1, :, 0], out[5, :, 0], out[8, :, 0] = in1, in5, in8
    # outlet: copy of the upstream column, read after the inlet write as in
    # the JAX version
    out[[3, 6, 7], :, -1] = out[[3, 6, 7], :, -2]
    return out


def bounce_back_obstacle(f: torch.Tensor, mask: torch.Tensor,
                         lattice: Lattice = D2Q9) -> torch.Tensor:
    """Full bounce-back inside ``mask`` (``[ny, nx]``, bool or int;
    ``D2Q9.cl:398-433``): every population is replaced by its opposite."""
    flipped = f[list(lattice.opp)]
    return torch.where(mask.bool()[None], flipped, f)
