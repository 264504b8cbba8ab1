"""The plan of K5, the Expansion band step (``csrc/multifield_step.cu``:
``band_plan``, ``band_cone_kernel``), mirrored in Python. The CPU tests
emulate the kernel's schedule with these numbers
(``tests/test_torch_band_plan.py``); :func:`lb2d_tpu_torch.ops.fused.band_max_k`
takes its limit from here. Every formula matches the CUDA function of the
same name.

K5 takes ``k`` Expansion steps on a band of ``rows >= 4 k`` rows and
writes its central ``2 k`` rows, from band row ``out0 = (rows - 2 k) // 2``.
Block ``b`` owns output columns ``[b W, (b + 1) W)``. Its level ``s = 1 ..
k`` computes only the cells that reach them, the region of halo ``h = k -
s``: band rows ``[out0 - h, out0 + 2 k + h)`` and columns ``[b W - h, (b +
1) W + h)`` (wrapped), thread ``t`` the cell ``(t // cols, t % cols)``.
Level 1 pulls from the band in global memory, level ``s >= 2`` from level
``s - 1`` in shared memory (the odd levels in one buffer, the even in
another), level ``k`` writes the output. The plan aims at
:data:`BLOCKS` strips and narrows them until level 1 has at most
:data:`THREADS` cells and both buffers fit a block's shared memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from .sweep import MAX_SWEEP_K, SMEM_PER_BLOCK

__all__ = ["THREADS", "BLOCKS", "level_rows", "level_cols", "smem_bytes",
           "threads", "BandPlan", "plan", "max_k"]

THREADS = 512  # the most threads of a block: cells of level 1
BLOCKS = 128   # strips aimed at: about one block per SM of an H100


def level_rows(k: int, s: int) -> int:
    """Rows of level ``s``: the ``2 k`` output rows and a halo of ``k -
    s`` rows each side."""
    return 4 * k - 2 * s


def level_cols(k: int, s: int, width: int) -> int:
    """Columns of level ``s``: the strip's ``width`` and ``k - s`` each
    side."""
    return width + 2 * (k - s)


def smem_bytes(num_fields: int, k: int, width: int) -> int:
    """Shared memory of one block: the 9F planes of levels 1 and 2, those
    of them below ``k`` (level ``k`` writes the output)."""
    cells = sum(level_rows(k, s) * level_cols(k, s, width)
                for s in (1, 2) if s < k)
    return 9 * num_fields * cells * 4


def threads(k: int, width: int) -> int:
    """Threads of one block: level 1's cells, rounded up to whole warps."""
    return -(-level_rows(k, 1) * level_cols(k, 1, width) // 32) * 32


class BandPlan(NamedTuple):
    width: int    # output columns of a strip
    strips: int   # blocks
    threads: int  # threads of a block
    smem: int     # bytes of shared memory of a block


def plan(num_fields: int, k: int, nx: int) -> BandPlan | None:
    """K5's launch for ``k`` steps of ``num_fields`` fields on ``nx``
    columns, or None where not even strips of one column fit."""
    w = -(-nx // BLOCKS)
    while w > 0 and (threads(k, w) > THREADS
                     or smem_bytes(num_fields, k, w) > SMEM_PER_BLOCK):
        w -= 1
    if w == 0:
        return None
    return BandPlan(w, -(-nx // w), threads(k, w),
                    smem_bytes(num_fields, k, w))


@functools.cache  # the wrapper checks every launch against it
def max_k(num_fields: int) -> int:
    """The most steps of one K5 launch: the largest ``k <= MAX_SWEEP_K``
    whose strips of one column fit (the plan does not depend on ``nx``
    there)."""
    return max(k for k in range(1, MAX_SWEEP_K + 1)
               if plan(num_fields, k, 1) is not None)
