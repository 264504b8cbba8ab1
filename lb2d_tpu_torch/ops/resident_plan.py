"""The plan of the one-launch run K3 (``csrc/resident_run.cu``), mirrored in
Python: the cut of the grid into bands, the thread-block clusters, the
shared memory of a block, the halo planes of an edge, the layout of the
exchange buffers and the slot of an exchange. The wrappers of
:mod:`~lb2d_tpu_torch.ops.fused` take the plan from here and pass it to the
kernel; the CPU tests emulate the kernel's schedule with these numbers
(``tests/test_torch_resident_plan.py``). Every formula matches the CUDA
header's of the same name (``csrc/resident_plan.cuh``).

A persistent block owns a band of whole rows ``[y0, y1)`` and keeps its
populations in shared memory for the whole run: it reads them from ``f``
once at the start and writes them back once at the end. Its rows live in
a ring of ``R + 2`` rows of 9 planes (``R = y1 - y0``): the band and one
halo row on each side. A step computes a group of rows into registers,
waits at a barrier, and writes each new row ``r`` into the ring slot of
the old row ``r - 1``, which no later group reads; the ring's offset then
moves back by one row, so no second copy of the band is needed.

After every step a block exchanges halos with the two bands whose rows it
pulls from (the first and last bands are neighbours, as the rows wrap): it
publishes its first row to the band above and its last row to the band
below, of which the receiver needs only the directions that stream across
its edge (:func:`edge_plane`): 2, 5, 6 (``cy = +1``) of the row above its
band, 4, 7, 8 (``cy = -1``) of the row below. It then waits for those two
neighbours alone. The edges go out as the step writes the rows (exchange
0's from the band as loaded). Inside a thread-block cluster the sender
stores an edge into the receiver's inbox in shared memory, through
distributed shared memory, and the cluster barrier is the signal (a grid
of one band is its own neighbour: its own inbox and a block barrier);
between clusters an edge goes through a buffer in ``scratch`` and a flag
per band, released by the sender and acquired by the receiver. Both
buffers hold two slots, by the parity of the exchange (:data:`SLOTS`): a
band publishes exchange ``e + 2`` into the slot of exchange ``e`` only
after it has waited for its neighbours' exchange ``e + 1``, which each of
them publishes only after reading exchange ``e``. A grid of at most
:data:`MAX_CLUSTER` bands runs as one cluster (on an H100 that measured
faster than scratch); larger grids exchange through ``scratch`` alone.

Strips: where a grid's rows are too wide for a block's threads, or its
bands do not fit shared memory, the blocks own strips of whole columns
instead, and the kernel runs the same schedule on the transposed grid.
Every function here works in that ring's frame: ``rows`` ring rows of
``len`` cells (``ny`` and ``nx`` with bands, ``nx`` and ``ny`` with
strips); with strips, ring plane ``q`` holds direction
:func:`transpose_dir` ``(q)``.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["THREADS", "CELLS_PER_THREAD", "MAX_CLUSTER", "FLAG_WORDS",
           "SMEM_PER_BLOCK", "H100_SMS", "SLOTS", "HALO_PLANES", "UP_DIRS",
           "DOWN_DIRS", "transpose_dir", "band_first_row", "rows_max",
           "group_rows", "smem_bytes", "exchange_floats", "gbuf_offset",
           "inbox_offset", "local_edge", "edge_plane", "plane_of",
           "ResidentPlan", "cut", "plan"]

THREADS = 512          # threads per block, one block per SM
CELLS_PER_THREAD = 4   # cells a thread holds in registers per group
MAX_CLUSTER = 16       # the H100's largest (non-portable) cluster
FLAG_WORDS = 32        # one 128-byte line of scratch per band's flag
SMEM_PER_BLOCK = 232448  # the 227 KB a block may have on an H100
H100_SMS = 132
SLOTS = 2              # exchange buffers per edge, by parity
HALO_PLANES = 3        # planes of an edge's row
UP_DIRS = (2, 5, 6)    # cy = +1: pulled from the row above
DOWN_DIRS = (4, 7, 8)  # cy = -1: pulled from the row below
_TRANSPOSED = (0, 2, 1, 4, 3, 5, 8, 7, 6)


def transpose_dir(q: int) -> int:
    """The D2Q9 direction whose ``(cx, cy)`` is direction ``q``'s ``(cy,
    cx)``: with strips, ring plane ``q`` holds it, so that the ring's pulls
    are the bands'. An involution: 1 <-> 2, 3 <-> 4, 6 <-> 8."""
    return _TRANSPOSED[q]


def band_first_row(b: int, rows: int, bands: int) -> int:
    """The first ring row of band ``b`` (band ``bands`` starts at
    ``rows``): an even cut, each band ``rows // bands`` or one more rows."""
    return b * rows // bands


def rows_max(rows: int, bands: int) -> int:
    return -(-rows // bands)


def group_rows(length: int) -> int:
    """Ring rows of a group: as many whole rows as the block's threads hold
    at ``CELLS_PER_THREAD`` cells each."""
    return CELLS_PER_THREAD * THREADS // length


def smem_bytes(rows: int, length: int, bands: int, cluster: int) -> int:
    """Shared memory of a block: the ring of ``rows_max + 2`` rows of 9
    planes and, in a cluster or a grid of one band, the inbox (``SLOTS``
    x 2 edges x ``HALO_PLANES`` planes of a row)."""
    ring = 9 * (rows_max(rows, bands) + 2)
    inbox = SLOTS * 2 * HALO_PLANES if cluster > 1 or bands == 1 else 0
    return 4 * length * (ring + inbox)


def exchange_floats(bands: int, length: int) -> int:
    """Floats of ``scratch`` the exchange between clusters uses: the
    flags, then ``SLOTS`` x ``bands`` x 2 edges x ``HALO_PLANES`` planes
    of a ring row."""
    return FLAG_WORDS * bands + SLOTS * bands * 2 * HALO_PLANES * length


def gbuf_offset(slot: int, band: int, edge: int, bands: int,
                length: int) -> int:
    """Where in ``scratch`` (floats) edge ``edge`` of ``band`` goes in
    ``slot``: edge 0 its first row (for the band above), 1 its last row
    (for the band below)."""
    return (FLAG_WORDS * bands
            + ((slot * bands + band) * 2 + edge) * HALO_PLANES * length)


def inbox_offset(slot: int, edge: int, length: int) -> int:
    """Where in a block's inbox (floats from its start) an edge goes (edge
    0: from the band below, 1: from the band above)."""
    return (slot * 2 + edge) * HALO_PLANES * length


def local_edge(band: int, neighbour: int, bands: int, cluster: int) -> bool:
    """Whether ``band`` and ``neighbour`` exchange edges through the
    receiver's inbox (the same cluster, or a grid of one band), not
    through ``scratch``."""
    return bands == 1 or (cluster > 1 and neighbour // cluster
                          == band // cluster)


def edge_plane(edge: int, p: int) -> int:
    """Ring plane ``p`` of an edge: edge 0 (the sender's first row, the
    receiver's row ``R``) carries :data:`DOWN_DIRS`, edge 1 (the sender's
    last row, the receiver's row -1) :data:`UP_DIRS`."""
    return (DOWN_DIRS if edge == 0 else UP_DIRS)[p]


def plane_of(edge: int, j: int) -> int:
    """The inverse of :func:`edge_plane`: the plane of ring plane ``j`` on
    an edge, or -1 where the edge does not carry it."""
    dirs = DOWN_DIRS if edge == 0 else UP_DIRS
    return dirs.index(j) if j in dirs else -1


class ResidentPlan(NamedTuple):
    """One launch of K3 on an ``ny x nx`` grid: ``bands`` blocks of
    ``THREADS`` threads, each a band of rows or, with ``strip``, a strip of
    columns, in clusters of ``cluster`` (1: no clusters, every edge
    through ``scratch``), ``smem`` bytes of shared memory per block, and
    the floats of ``scratch`` the exchange between clusters needs (0 where
    every edge stays in a cluster)."""
    ny: int
    nx: int
    strip: bool
    bands: int
    cluster: int
    smem: int
    exchange: int

    @property
    def rows(self) -> int:
        """Ring rows of the grid: ``nx`` with strips, else ``ny``."""
        return self.nx if self.strip else self.ny

    @property
    def length(self) -> int:
        """Cells of a ring row: ``ny`` with strips, else ``nx``."""
        return self.ny if self.strip else self.nx


def cut(ny: int, nx: int, strip: bool,
        sms: int = H100_SMS) -> ResidentPlan | None:
    """The plan of one layout, bands of rows or (``strip``) strips of
    columns, or None where a ring row is wider than the block's threads
    hold (``CELLS_PER_THREAD * THREADS`` cells) or a band does not fit a
    block's shared memory.

    Bands: as many as fill ``sms`` blocks, one per SM, but no more than
    give each thread of a block one cell (a grid of ``ny nx`` cells is
    worth ``ceil(ny nx / THREADS)`` blocks), each band at least one ring
    row. Clusters: a grid of at most :data:`MAX_CLUSTER` bands runs as
    one cluster where the inbox fits, others with none.
    """
    rows, length = (nx, ny) if strip else (ny, nx)
    if length > CELLS_PER_THREAD * THREADS:
        return None
    bands = max(1, min(rows, sms, -(-rows * length // THREADS)))
    cluster = bands if bands <= MAX_CLUSTER else 1
    if smem_bytes(rows, length, bands, cluster) > SMEM_PER_BLOCK:
        cluster = 1
    smem = smem_bytes(rows, length, bands, cluster)
    if smem > SMEM_PER_BLOCK:
        return None
    exchange = exchange_floats(bands, length) if bands > cluster else 0
    return ResidentPlan(ny, nx, strip, bands, cluster, smem, exchange)


def plan(ny: int, nx: int, sms: int = H100_SMS) -> ResidentPlan | None:
    """The plan of a K3 launch on an ``ny x nx`` grid: bands of rows where
    they fit (:func:`cut`), else strips of columns (rows wider than 2,048
    cells, as 16 x 4096), or None where neither fits: about 790^2 cells
    and more, whose state (36 B a cell) nears the shared memory of the
    card's blocks (132 x 227 KB on an H100)."""
    return cut(ny, nx, False, sms) or cut(ny, nx, True, sms)
