"""Boundary conditions (counterpart of ``lb2d_tpu.ops.boundary``).

The reference kernels read a per-cell snapshot of all 9 populations before
writing (``D2Q9.cl:187-195``). Here every formula reads the input ``f``,
and the results are written into a clone, so no formula ever sees a value
another formula wrote. Layout ``f[Q, ny, nx]``: ``x = 0`` inlet, ``x = nx-1``
outlet, ``y = 0`` south wall, ``y = ny-1`` north wall.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import D2Q9, Lattice

__all__ = [
    "GridCoords",
    "zou_he_pressure_bcs",
    "zou_he_pressure_bcs_incompressible",
    "zou_he_velocity_bcs",
    "zou_he_velocity_inlet_open_outlet",
    "bounce_back_obstacle",
]


class GridCoords(NamedTuple):
    """The global coordinates of a block of cells cut from an ``ny x nx``
    grid: ``row`` (``[R, 1]``) and ``lane`` (``[1, C]``) int64 tensors.

    Given as ``at=`` to the boundary conditions, they apply to the cells
    whose global coordinates lie on the grid's edges, wherever those cells
    sit in the block (a shard with its halo); without it, to the edges of
    the array. Both forms evaluate the same expressions on the same values,
    so they agree bit for bit."""
    row: torch.Tensor
    lane: torch.Tensor
    ny: int
    nx: int

    def edges(self) -> dict:
        """Masks of the cell classes: the inlet and outlet columns and the
        south and north walls without the corners, the four corners, and
        the whole first and last columns (velocity BCs)."""
        row, lane, ny, nx = self
        row_int = (row >= 1) & (row <= ny - 2)
        lane_int = (lane >= 1) & (lane <= nx - 2)
        row0, row_n = row == 0, row == ny - 1
        lane0, lane_n = lane == 0, lane == nx - 1
        return {"inlet": lane0 & row_int, "outlet": lane_n & row_int,
                "south": row0 & lane_int, "north": row_n & lane_int,
                "bottom_inlet": row0 & lane0, "top_inlet": row_n & lane0,
                "bottom_outlet": row0 & lane_n, "top_outlet": row_n & lane_n,
                "west": lane0.expand(row.shape[0], -1),
                "east": lane_n.expand(row.shape[0], -1)}


def _scalar(x, f: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=f.dtype, device=f.device)


# Each formula maps the pulled values ``s`` (``s[j]`` a tensor of any shape:
# a column slice, a corner, or whole planes) to ``{direction: new value}``.

def _inlet(s, rho):  # D2Q9.cl:198-203
    u_in = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7] - rho) / rho)
    return {1: s[3] + (2.0 / 3.0) * rho * u_in,
            5: -0.5 * s[2] + 0.5 * s[4] + s[7] + (1.0 / 6.0) * u_in * rho,
            8: 0.5 * s[2] - 0.5 * s[4] + s[6] + (1.0 / 6.0) * u_in * rho}


def _outlet(s, rho):  # D2Q9.cl:205-210
    u_out = -1.0 + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8]) / rho
    return {3: s[1] - (2.0 / 3.0) * rho * u_out,
            6: -0.5 * s[2] + 0.5 * s[4] + s[8] - (1.0 / 6.0) * u_out * rho,
            7: 0.5 * s[2] - 0.5 * s[4] + s[5] - (1.0 / 6.0) * u_out * rho}


def _inlet_incompressible(s, rho):  # D2Q9i.cl:194-199
    u_in = -s[0] - s[2] - 2 * s[3] - s[4] - 2 * s[6] - 2 * s[7] + rho
    return {1: (1.0 / 3.0) * (3 * s[3] + 2 * u_in),
            5: (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[7] + u_in),
            8: (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[6] + u_in)}


def _outlet_incompressible(s, rho):  # D2Q9i.cl:201-206
    u_out = s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8] - rho
    return {3: (1.0 / 3.0) * (3 * s[1] - 2 * u_out),
            6: (1.0 / 6.0) * (-3 * s[2] + 3 * s[4] + 6 * s[8] - u_out),
            7: (1.0 / 6.0) * (3 * s[2] - 3 * s[4] + 6 * s[5] - u_out)}


def _north(s, rin, rout):  # D2Q9.cl:212-223
    return {4: s[2], 8: 0.5 * (-s[1] + s[3] + 2 * s[6]),
            7: 0.5 * (s[1] - s[3] + 2 * s[5])}


def _south(s, rin, rout):
    return {2: s[4], 6: 0.5 * (s[1] - s[3] + 2 * s[8]),
            5: 0.5 * (-s[1] + s[3] + 2 * s[7])}


def _bottom_inlet(c, rin, rout):  # D2Q9.cl:228-259
    d = 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7] + rin)
    return {1: c[3], 2: c[4], 5: c[7], 6: d, 8: d}


def _top_inlet(c, rin, rout):
    d = 0.5 * (-c[0] - 2 * c[2] - 2 * c[3] - 2 * c[6] + rin)
    return {1: c[3], 4: c[2], 8: c[6], 5: d, 7: d}


def _bottom_outlet(c, rin, rout):
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[4] - 2 * c[8] + rout)
    return {3: c[1], 2: c[4], 6: c[8], 5: d, 7: d}


def _top_outlet(c, rin, rout):
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[2] - 2 * c[5] + rout)
    return {3: c[1], 4: c[2], 7: c[5], 6: d, 8: d}


def _velocity_inlet(s, u_w):  # D2Q9.cl:291-296
    rho_w = (1.0 / (1.0 - u_w)) * (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7]))
    return {1: s[3] + (2.0 / 3.0) * rho_w * u_w,
            5: s[7] - 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w,
            8: s[6] + 0.5 * (s[2] - s[4]) + (1.0 / 6.0) * rho_w * u_w}


def _velocity_outlet(s, u_e):  # D2Q9.cl:298-303
    rho_e = (1.0 / (1.0 + u_e)) * (s[0] + s[2] + s[4] + 2 * (s[1] + s[5] + s[8]))
    return {3: s[1] - (2.0 / 3.0) * rho_e * u_e,
            6: s[5] + 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e,
            7: s[8] - 0.5 * (s[2] - s[4]) - (1.0 / 6.0) * rho_e * u_e}


# where each class's cells sit at the array's edges (``at=None``)
_SLICES = {"inlet": (slice(1, -1), 0), "outlet": (slice(1, -1), -1),
           "north": (-1, slice(1, -1)), "south": (0, slice(1, -1)),
           "bottom_inlet": (0, 0), "top_inlet": (-1, 0),
           "bottom_outlet": (0, -1), "top_outlet": (-1, -1),
           "west": (slice(None), 0), "east": (slice(None), -1)}


def _apply(f, rules, at):
    """``rules``: (cell class, formula of the pulled values) pairs. Every
    formula reads ``f``; the results go into a clone, on the array's edges
    or, with ``at``, on the cells of each class by global coordinates."""
    out = f.clone()
    masks = at.edges() if at is not None else None
    for where, formula in rules:
        if masks is None:
            idx = _SLICES[where]
            for j, v in formula(f[(slice(None), *idx)]).items():
                out[(j, *idx)] = v
        else:
            for j, v in formula(f).items():
                out[j] = torch.where(masks[where], v, out[j])
    return out


def _pressure(f, inlet_rho, outlet_rho, at, inlet, outlet):
    rin, rout = _scalar(inlet_rho, f), _scalar(outlet_rho, f)
    rules = [("inlet", lambda s: inlet(s, rin)),
             ("outlet", lambda s: outlet(s, rout))]
    rules += [(name, lambda s, fn=fn: fn(s, rin, rout)) for name, fn in (
        ("north", _north), ("south", _south), ("bottom_inlet", _bottom_inlet),
        ("top_inlet", _top_inlet), ("bottom_outlet", _bottom_outlet),
        ("top_outlet", _top_outlet))]
    return _apply(f, rules, at)


def zou_he_pressure_bcs(f: torch.Tensor, inlet_rho, outlet_rho,
                        at: GridCoords | None = None) -> torch.Tensor:
    """Pressure inlet/outlet + solid walls + 4 corners (``D2Q9.cl:173-261``)."""
    return _pressure(f, inlet_rho, outlet_rho, at, _inlet, _outlet)


def zou_he_pressure_bcs_incompressible(f: torch.Tensor, inlet_rho,
                                       outlet_rho,
                                       at: GridCoords | None = None
                                       ) -> torch.Tensor:
    """He-Luo variant (``D2Q9i.cl:173-261``): the inlet/outlet velocities are
    momenta; walls and corners are the compressible ones."""
    return _pressure(f, inlet_rho, outlet_rho, at, _inlet_incompressible,
                     _outlet_incompressible)


def zou_he_velocity_bcs(f: torch.Tensor, u_w, u_e,
                        at: GridCoords | None = None) -> torch.Tensor:
    """Velocity inlet/outlet applied on the full columns, periodic top and
    bottom (``D2Q9.cl:263-321``; wrap-compatible form, DIVERGENCES.md #20)."""
    u_w, u_e = _scalar(u_w, f), _scalar(u_e, f)
    return _apply(f, [("west", lambda s: _velocity_inlet(s, u_w)),
                      ("east", lambda s: _velocity_outlet(s, u_e))], at)


def zou_he_velocity_inlet_open_outlet(f: torch.Tensor, u_w,
                                      at: GridCoords | None = None
                                      ) -> torch.Tensor:
    """Zou-He velocity inlet (west) + zero-gradient open outlet (east),
    periodic top and bottom (DIVERGENCES.md #20/#21)."""
    u_w = _scalar(u_w, f)
    out = _apply(f, [("west", lambda s: _velocity_inlet(s, u_w))], at)
    # outlet: copy of the upstream column, read after the inlet write as in
    # the JAX version
    if at is None:
        out[[3, 6, 7], :, -1] = out[[3, 6, 7], :, -2]
    else:
        west = torch.roll(out[[3, 6, 7]], 1, dims=-1)
        out[[3, 6, 7]] = torch.where(at.edges()["east"], west, out[[3, 6, 7]])
    return out


def bounce_back_obstacle(f: torch.Tensor, mask: torch.Tensor,
                         lattice: Lattice = D2Q9) -> torch.Tensor:
    """Full bounce-back inside ``mask`` (``[ny, nx]``, bool or int;
    ``D2Q9.cl:398-433``): every population is replaced by its opposite."""
    flipped = f[list(lattice.opp)]
    return torch.where(mask.bool()[None], flipped, f)
