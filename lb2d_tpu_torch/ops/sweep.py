"""The geometry of the row sweep that K2, K4 and K7 run on the card
(``csrc/row_sweep.cuh``, ``csrc/coupled_step.cu``), mirrored in Python:
the ring of rows each level
keeps in shared memory, the shared-memory budget that sets the most steps
per launch, and the cut of a grid into work items. The CPU tests emulate the
kernels' schedule with these numbers (``tests/test_torch_sweep_plan.py``);
the wrappers in :mod:`~lb2d_tpu_torch.ops.fused` take their limits from
here. Every formula matches the CUDA header's of the same name.

A work item is a strip of columns and a segment of rows. Its block sweeps
the segment one row per phase: at phase ``t`` it loads the input row of
phase ``t + PREFETCH`` (``cp.async``) and level ``s = 1..K`` computes row
``ys - K + t - 2 s`` from level ``s - 1``'s three rows around it; level
``K`` writes ``f_out``. A level keeps, per direction ``j``, the rows it
wrote in the last ``LAG[j] + 1`` phases (``LAG[j] = 2 + cy_j``: the next
level reads direction ``j`` ``LAG[j]`` phases after it was written), the
input level ``PREFETCH`` more.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["SWEEP_THREADS", "PREFETCH", "MAX_SWEEP_K", "SMEM_PER_BLOCK",
           "LAG", "GROUP", "SLOT", "DENSITY_SLOTS", "strip_width", "depth",
           "group_base", "level_rows", "smem_bytes", "blocks_per_sm",
           "max_k", "coupled_reach", "coupled_lag", "coupled_smem_bytes",
           "coupled_blocks_per_sm", "coupled_max_k", "SweepPlan", "plan"]

SWEEP_THREADS = 256       # threads per block: strip_width columns x lanes
PREFETCH = 1              # input rows in flight ahead of the one completing
MAX_SWEEP_K = 8           # K = 9-16 fit one block per SM: 1.8-2x slower
SMEM_PER_BLOCK = 232448   # the 227 KB a block may have on an H100
SMEM_PER_SM = 233472      # 228 KB per SM, 1 KB of it reserved per block

# D2Q9 direction j: lag 2 + cy_j, its group (0: lag 1, 1: lag 2, 2: lag 3)
# and its place among the group's three directions
LAG = (2, 2, 3, 2, 1, 3, 3, 1, 1)
GROUP = tuple(lag - 1 for lag in LAG)
SLOT = (0, 1, 0, 2, 0, 1, 2, 1, 2)


def strip_width(planes: int) -> int:
    """Columns of a strip for ``planes`` planes per direction (1 for K2,
    ``F`` for K4): the stored columns and a K-column halo each side."""
    return 128 if planes == 1 else 64 if planes <= 3 else 32


def depth(group: int, first: bool, lag: int = 2) -> int:
    """Rows a level keeps for each direction of ``group``: the next level
    reads them ``lag - 1 + group`` phases after they were written (``lag``
    2; 4 for the coupled sweep's levels with a density stage,
    :mod:`~lb2d_tpu_torch.ops.coupled_sweep`), plus the row being written,
    and the prefetched rows for the input level (``first``)."""
    return group + lag + (PREFETCH if first else 0)


def group_base(group: int, first: bool, lag: int = 2) -> int:
    """The first ring row of ``group`` in a level's ring; the ring row of
    (direction j, slot) is ``group_base(GROUP[j]) + 3 slot + SLOT[j]``."""
    return sum(3 * depth(g, first, lag) for g in range(group))


def level_rows(first: bool, lag: int = 2) -> int:
    """Ring rows of one level: 27 at lag 2, and 9 per prefetched row at the
    input."""
    return group_base(3, first, lag)


def smem_bytes(k_steps: int, planes: int, mask: bool = False) -> int:
    """Shared memory of one block: the rings of levels 0 .. K - 1 (a ring
    row holds ``planes`` planes of a strip) and, with an obstacle, a byte
    per cell of the mask rows levels 0 .. K read, ``2 K + PREFETCH + 1``."""
    wb = strip_width(planes)
    rows = level_rows(True) + (k_steps - 1) * level_rows(False)
    ring = rows * planes * wb * 4
    return ring + ((2 * k_steps + PREFETCH + 1) * wb if mask else 0)


def blocks_per_sm(k_steps: int, planes: int, mask: bool = False) -> int:
    """Blocks of one SM that the shared memory allows (registers may allow
    fewer: the card's occupancy query decides the launch)."""
    return SMEM_PER_SM // (smem_bytes(k_steps, planes, mask) + 1024)


def max_k(planes: int) -> int:
    """The most steps per launch, up to ``MAX_SWEEP_K``: the rings fit one
    block's shared memory (with the obstacle's mask rows)."""
    k = MAX_SWEEP_K
    while k > 1 and smem_bytes(k, planes, planes == 1) > SMEM_PER_BLOCK:
        k -= 1
    return k


# -- K7's sweep (csrc/coupled_step.cu): belt 1 for the physics that read
#    their neighbours' post-stream densities, which a density stage between
#    two levels computes into a ring of DENSITY_SLOTS rows of F + 1 planes
DENSITY_SLOTS = 4


def coupled_reach(belt: int) -> int:
    """Cells one coupled step reaches: the stream, and the belt."""
    return 1 + belt


def coupled_lag(belt: int) -> int:
    """Phases a coupled level lags behind the one below: 2, as K4, or 4
    with the density stage between them."""
    return 2 + 2 * belt


def coupled_smem_bytes(k_steps: int, fields: int, belt: int) -> int:
    """Shared memory of one K7 block: the rings of levels 0 .. K - 1 at the
    level's lag, and with a belt each level's density ring."""
    wb, lag = strip_width(fields), coupled_lag(belt)
    rows = level_rows(True, lag) + (k_steps - 1) * level_rows(False, lag)
    dens = k_steps * DENSITY_SLOTS * (fields + 1) * wb if belt else 0
    return 4 * (rows * fields * wb + dens)


def coupled_blocks_per_sm(k_steps: int, fields: int, belt: int) -> int:
    """K7 blocks of one SM that the shared memory allows."""
    return SMEM_PER_SM // (coupled_smem_bytes(k_steps, fields, belt) + 1024)


def coupled_max_k(fields: int, belt: int) -> int:
    """The most steps of one K7 launch, up to ``MAX_SWEEP_K``: its rings fit
    one block's shared memory."""
    k = MAX_SWEEP_K
    while k > 1 and coupled_smem_bytes(k, fields, belt) > SMEM_PER_BLOCK:
        k -= 1
    return k


class SweepPlan(NamedTuple):
    """The cut of a ``rows x cols`` domain into ``strips x segments`` work
    items: strip ``i`` stores columns ``[i wo, min((i + 1) wo, cols))``,
    segment ``j`` rows ``[j seg, min((j + 1) seg, rows))``."""
    strips: int
    wo: int
    segments: int
    seg: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, cols: int, k_steps: int, planes: int,
         slots: int) -> SweepPlan:
    """Strips of at most ``strip_width - 2 K`` stored columns, evened out;
    as many segments as fill ``slots`` resident blocks (the card's SMs
    times its blocks per SM) in one wave, evened out. ``k_steps`` is the
    halo of a strip: K cells for K2 and K4 (the coupled sweep's is its
    reach times K)."""
    wo = _ceil(cols, _ceil(cols, strip_width(planes) - 2 * k_steps))
    strips = _ceil(cols, wo)
    segments = min(max(slots // strips, 1), rows)
    seg = _ceil(rows, segments)
    return SweepPlan(strips, wo, _ceil(rows, seg), seg)
