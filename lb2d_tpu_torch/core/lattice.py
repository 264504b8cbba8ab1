"""Lattice descriptors for the LB stencils (D2Q9, D2Q25).

A copy of the numpy-only ``lb2d_tpu.core.lattice``: the port imports
nothing of the JAX package.

The reference pins these constants at the top of every simulation script
(``LB_D2Q9/dimensionless/opencl_dim.py:22-36``); here they live in one
immutable descriptor so every model / kernel shares a single source of truth.

Direction numbering (D2Q9), identical to the reference::

      6  2  5
      3  0  1
      7  4  8

``c[j] = (cx[j], cy[j])``, opposite direction ``opp[j]`` satisfies
``c[opp[j]] = -c[j]`` (used for bounce-back, ``D2Q9.cl:398-433``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["Lattice", "D2Q9", "D2Q25"]


@dataclasses.dataclass(frozen=True)
class Lattice:
    """An immutable velocity-set descriptor.

    Attributes:
      name: human-readable stencil name.
      w:  quadrature weights, shape [Q].
      cx: x components of the discrete velocities, shape [Q], ints.
      cy: y components of the discrete velocities, shape [Q], ints.
      cs: lattice speed of sound.
    """

    name: str
    w: tuple
    cx: tuple
    cy: tuple
    cs: float

    @property
    def q(self) -> int:
        return len(self.w)

    @property
    def cs2(self) -> float:
        return self.cs**2

    @cached_property
    def opp(self) -> tuple:
        """Index of the opposite velocity for each direction."""
        out = []
        for j in range(self.q):
            for k in range(self.q):
                if self.cx[k] == -self.cx[j] and self.cy[k] == -self.cy[j]:
                    out.append(k)
                    break
        return tuple(out)

    def w_np(self, dtype=np.float32) -> np.ndarray:
        return np.asarray(self.w, dtype=dtype)

    def cx_np(self, dtype=np.int32) -> np.ndarray:
        return np.asarray(self.cx, dtype=dtype)

    def cy_np(self, dtype=np.int32) -> np.ndarray:
        return np.asarray(self.cy, dtype=dtype)


# D2Q9: weights/velocities as in opencl_dim.py:22-26 / python_dim.py:7-20.
D2Q9 = Lattice(
    name="D2Q9",
    w=(4.0 / 9.0,) + (1.0 / 9.0,) * 4 + (1.0 / 36.0,) * 4,
    cx=(0, 1, 0, -1, 0, 1, -1, -1, 1),
    cy=(0, 0, 1, 0, -1, 1, 1, -1, -1),
    cs=1.0 / np.sqrt(3.0),
)


def _d2q25() -> Lattice:
    """D2Q25 two-belt Gauss-Hermite lattice as constructed in the reference
    (``multicomponent_multiphase/multi.py:829-876``): velocities built from
    the 1-D set {0, ±1, ±3} with 1-D weights (t0, t1, t3) tensored into 2-D,
    sound speed cs = sqrt(1 − sqrt(2/5)). Direction ordering follows the
    reference's magnitude-grouped listing exactly (rest particle first).
    """
    r10 = np.sqrt(10.0)
    t0 = (4.0 / 45.0) * (4.0 + r10)
    t1 = (3.0 / 80.0) * (8.0 - r10)
    t3 = (1.0 / 720.0) * (16.0 - 5.0 * r10)

    cx, cy, w = [0], [0], [t0 * t0]
    # |c| = 1
    cx += [0, 0, 1, -1]
    cy += [1, -1, 0, 0]
    w += [t0 * t1] * 4
    # |c| = sqrt(2)
    cx += [1, 1, -1, -1]
    cy += [1, -1, 1, -1]
    w += [t1 * t1] * 4
    # |c| = 3
    cx += [3, -3, 0, 0]
    cy += [0, 0, 3, -3]
    w += [t0 * t3] * 4
    # |c| = sqrt(10)
    cx += [1, 1, -1, -1, 3, 3, -3, -3]
    cy += [3, -3, 3, -3, 1, -1, 1, -1]
    w += [t1 * t3] * 8
    # |c| = sqrt(18)
    cx += [3, 3, -3, -3]
    cy += [3, -3, 3, -3]
    w += [t3 * t3] * 4

    cs = float(np.sqrt(1.0 - np.sqrt(2.0 / 5.0)))
    return Lattice(name="D2Q25", w=tuple(w), cx=tuple(cx), cy=tuple(cy), cs=cs)


D2Q25 = _d2q25()
