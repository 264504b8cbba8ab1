"""Streaming by periodic roll (counterpart of ``lb2d_tpu.ops.stream``).

The boundary conditions rewrite every population a wrapping roll brings in
through a domain edge, so roll-then-BC equals the reference's non-wrapping
two-buffer move (see the JAX module's docstring).
"""

from __future__ import annotations

import torch

from ..core import D2Q9, Lattice

__all__ = ["stream"]


def stream(f: torch.Tensor, lattice: Lattice = D2Q9) -> torch.Tensor:
    """``out[j, ..., y, x] = f[j, ..., y - cy_j, x - cx_j]`` with periodic
    wrap along the last two axes; ``f`` is ``[Q, ny, nx]`` or, for the
    multifield models, ``[Q, F, ny, nx]``."""
    planes = []
    for j in range(lattice.q):
        cx, cy = lattice.cx[j], lattice.cy[j]
        p = f[j]
        if cy != 0:
            p = torch.roll(p, cy, dims=-2)
        if cx != 0:
            p = torch.roll(p, cx, dims=-1)
        planes.append(p)
    return torch.stack(planes)
