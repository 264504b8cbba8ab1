"""Halo exchange for domain-decomposed LB grids (counterpart of
``lb2d_tpu.parallel.halo``).

A grid ``f[P, ny, nx]`` is cut into the shards of a :class:`Mesh`, a
``(my, mx)`` grid of ``(rank, torch.device)`` entries. Each process holds
the shards whose rank is its own. Before each sweep every shard receives a
halo of ``hk`` cells from its neighbours (periodic rings along both mesh
axes): the ``hk`` rows above and below it from its y-neighbours, then, on
meshes with ``mx > 1``, the ``hk`` columns beside its y-extended rows from
its x-neighbours, so the diagonal corners arrive in two hops. A chunk bound
for a shard of the same process is a tensor copy (a peer copy between two
cards); one bound for another process goes by
``torch.distributed.batch_isend_irecv``. At the grid's edges the ring
brings in the opposite shard's cells, which are what the unsharded kernels
read through their wrap; the BCs rewrite them by global coordinates.

JAX exchanges x first and y second (``lb2d_tpu/parallel/halo.py:45-63``);
its sharded K9 path y first (``lb2d_tpu/parallel/sharded.py:186-201``), as
here. Both orders give the same extended block. The exchange moves any
stack of planes ``[P, H, W]`` at any width: K9's ``k``-step halos, the
multicomponent and coupled shards' halos of the lattice's reach.

The multicomponent and coupled shards' density passes write each shard's
band of the post-stream densities into one whole-grid plane stack per
device. :func:`exchange_bands` brings each device the belt around its
shards' bands, which the interaction stencils read (the density halo, in
the same two hops); :func:`gather_bands` completes the planes that the
screened solve reads everywhere: a copy between the cards of one process,
``all_gather`` across processes. Neither moves anything when one device
of one process holds every shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.fused_halo import Halo

__all__ = ["Mesh", "this_rank", "ring_shift", "new_halos", "exchange_halos",
           "extend_with_halo", "exchange_halo_2d", "band", "exchange_bands",
           "gather_bands"]


def this_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A ``(my, mx)`` grid of shards: the entry ``(rank, device)`` of shard
    ``(iy, ix)`` is ``entries[iy * mx + ix]`` (the counterpart of JAX's
    ``("y", "x")`` device mesh). A device may appear more than once: several
    shards on one card, or on the CPU."""

    def __init__(self, entries, shape):
        self.my, self.mx = (int(n) for n in shape)
        self.entries = [(int(rank), torch.device(dev))
                        for rank, dev in entries]
        if len(self.entries) != self.my * self.mx:
            raise ValueError(f"{len(self.entries)} entries do not fill a "
                             f"{self.my}x{self.mx} mesh")

    @property
    def shape(self) -> dict:
        return {"y": self.my, "x": self.mx}

    @property
    def size(self) -> int:
        return self.my * self.mx

    def positions(self):
        return [(iy, ix) for iy in range(self.my) for ix in range(self.mx)]

    def rank(self, pos) -> int:
        return self.entries[pos[0] * self.mx + pos[1]][0]

    def device(self, pos) -> torch.device:
        return self.entries[pos[0] * self.mx + pos[1]][1]

    def local_positions(self):
        """The positions of this process's shards, in mesh order."""
        rank = this_rank()
        return [pos for pos in self.positions() if self.rank(pos) == rank]

    def neighbour(self, pos, axis: str, step: int):
        iy, ix = pos
        if axis == "y":
            return ((iy + step) % self.my, ix)
        return (iy, (ix + step) % self.mx)


def ring_shift(mesh: Mesh, chunks: dict, axis: str, direction: int,
               out: dict) -> dict:
    """Shift one chunk per shard by one place along a mesh axis (a periodic
    ring): each local shard ``pos`` receives into ``out[pos]`` the chunk of
    the shard ``direction`` places before it (``direction=+1``: from the
    previous shard). ``chunks`` and ``out`` hold tensors (views allowed) of
    this process's shards; a chunk whose ``out`` is the same tensor is
already in place. Returns ``out``."""
    rank = this_rank()
    ops, unpack = [], []
    for tag, dst in enumerate(mesh.positions()):
        src = mesh.neighbour(dst, axis, -direction)
        r_src, r_dst = mesh.rank(src), mesh.rank(dst)
        if r_src == rank and r_dst == rank:
            if out[dst] is not chunks[src]:
                out[dst].copy_(chunks[src])
        elif r_src == rank:
            ops.append(dist.P2POp(dist.isend, chunks[src].contiguous(),
                                  r_dst, tag=tag))
        elif r_dst == rank:
            buf = out[dst]
            if not buf.is_contiguous():
                buf = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=buf.device)
                unpack.append((out[dst], buf))
            ops.append(dist.P2POp(dist.irecv, buf, r_src, tag=tag))
    if ops:
        if (dist.get_backend() == "gloo"
                and any(op.tensor.is_cuda for op in ops)):
            raise RuntimeError(
                "gloo cannot carry CUDA tensors point to point: a CUDA mesh "
                "across processes needs the NCCL backend (init_distributed "
                "with CUDA devices)")
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for dst, buf in unpack:
        dst.copy_(buf)
    return out


def new_halos(mesh: Mesh, shards: dict, width: int) -> dict:
    """A :class:`~lb2d_tpu_torch.ops.fused_halo.Halo` of ``width`` cells,
    with empty buffers, for each of this process's shards (``shards``:
    position -> ``[P, H, W]``); the x strips only on meshes with ``mx >
    1``."""
    halos = {}
    for pos, f in shards.items():
        P, H, W = f.shape
        top, bot = (torch.empty((P, width, W), dtype=f.dtype, device=f.device)
                    for _ in range(2))
        left = right = None
        if mesh.mx > 1:
            left, right = (torch.empty((P, H + 2 * width, width),
                                       dtype=f.dtype, device=f.device)
                           for _ in range(2))
        halos[pos] = Halo(f, top, bot, left, right, pos[0] * H, pos[1] * W,
                          mesh.my * H, mesh.mx * W)
    return halos


def exchange_halos(mesh: Mesh, halos: dict) -> dict:
    """Fill the halo buffers of this process's shards from their
    neighbours' cells: the rows first, then the x strips from the
    y-extended rows (corners in two hops). Returns ``halos``."""
    w = next(iter(halos.values())).width
    ring_shift(mesh, {p: h.f[:, h.f.shape[1] - w:] for p, h in halos.items()},
               "y", +1, {p: h.top for p, h in halos.items()})
    ring_shift(mesh, {p: h.f[:, :w] for p, h in halos.items()}, "y", -1,
               {p: h.bot for p, h in halos.items()})
    if mesh.mx > 1:
        for i, name in enumerate(("top", "f", "bot")):
            # this piece's rows in the y-extended rows: [w i, ...) for the
            # top and f, [w + H, ...) for the bottom
            rows = {p: slice(w * i if i < 2 else w + h.f.shape[1], None)
                    for p, h in halos.items()}
            for strip, direction, cols in (("left", +1, slice(-w, None)),
                                           ("right", -1, slice(0, w))):
                ring_shift(
                    mesh, {p: getattr(h, name)[..., cols]
                           for p, h in halos.items()}, "x", direction,
                    {p: getattr(h, strip)[:, rows[p]][
                        :, :getattr(h, name).shape[1]]
                     for p, h in halos.items()})
    return halos


def extend_with_halo(mesh: Mesh, shards: dict, width: int = 1) -> dict:
    """Each of this process's shards (position -> ``[P, H, W]``) extended to
    ``[P, H + 2 width, W + 2 width]`` with its neighbours' cells (periodic
    rings; at the grid's edges the wrapped-in cells are rewritten by the
    BCs, as in the unsharded roll-based stream)."""
    halos = exchange_halos(mesh, new_halos(mesh, shards, width))
    return {pos: h.extended() for pos, h in halos.items()}


exchange_halo_2d = extend_with_halo  # JAX's second name for the same


def band(pos, H: int, W: int) -> tuple:
    """The rows and columns of shard ``pos``'s ``H x W`` band of the grid,
    as slices."""
    return (slice(pos[0] * H, (pos[0] + 1) * H),
            slice(pos[1] * W, (pos[1] + 1) * W))


def _one_device(mesh: Mesh, planes: dict) -> bool:
    return len({rank for rank, _ in mesh.entries}) == 1 and len(planes) == 1


def exchange_bands(mesh: Mesh, planes: dict, H: int, W: int,
                   width: int) -> dict:
    """Fill, in the whole-grid plane stacks of this process's devices
    (``planes``: device -> ``[P, ny, nx]``, in which each local shard has
    written its ``H x W`` band on its own device), the ``width`` rows and
    columns around each local shard's band (corners included) from the
    shards that hold them: the rows above and below first, then the
    columns beside the y-extended rows, as :func:`exchange_halos` moves a
    shard's halo (``width <= H``, and ``<= W`` when ``mx > 1``). Returns
    ``planes``."""
    if _one_device(mesh, planes):
        return planes
    ny, nx = mesh.my * H, mesh.mx * W
    rank = this_rank()

    def shift(axis, direction, y, rows, x, cols):
        # src's cells [y0 + y, + rows) x [x0 + x, + cols), in every local
        # dst's planes, from the shard ``direction`` places before dst
        def region(src, dev):
            y0, x0 = (src[0] * H + y) % ny, (src[1] * W + x) % nx
            return planes[dev][:, y0:y0 + rows, x0:x0 + cols]

        chunks, out = {}, {}
        for pos in mesh.positions():
            if mesh.rank(pos) == rank:
                chunks[pos] = region(pos, mesh.device(pos))
        for dst in mesh.positions():
            if mesh.rank(dst) != rank:
                continue
            src = mesh.neighbour(dst, axis, -direction)
            same = (mesh.rank(src) == rank
                    and mesh.device(src) == mesh.device(dst))
            out[dst] = chunks[src] if same else region(src, mesh.device(dst))
        ring_shift(mesh, chunks, axis, direction, out)

    w = width
    shift("y", +1, H - w, w, 0, W)
    shift("y", -1, 0, w, 0, W)
    if mesh.mx > 1:
        for y, rows in ((-w, w), (0, H), (H, w)):
            shift("x", +1, y, rows, W - w, w)
            shift("x", -1, y, rows, 0, w)
    return planes


def gather_bands(mesh: Mesh, planes: dict, H: int, W: int,
                 index) -> dict:
    """Complete planes ``index`` (a sequence of plane numbers) of the
    whole-grid stacks of this process's devices (``planes``: device
    -> ``[P, ny, nx]``, in which each local shard has written its ``H x
    W`` band on its own device) with every other shard's band: copies
    between this process's devices, and one ``all_gather`` of the local
    bands across processes (each holds as many shards). Returns
    ``planes``."""
    if _one_device(mesh, planes):
        return planes
    index = list(index)
    ranks = {rank for rank, _ in mesh.entries}
    local = mesh.local_positions()
    if len(ranks) == 1:
        for pos in local:
            rows, cols = band(pos, H, W)
            src = planes[mesh.device(pos)]
            for dev, t in planes.items():
                if dev != mesh.device(pos):
                    for i in index:
                        t[i, rows, cols] = src[i, rows, cols]
        return planes
    counts = {rank: sum(1 for r, _ in mesh.entries if r == rank)
              for rank in ranks}
    if len(set(counts.values())) != 1:
        raise ValueError(f"gather_bands needs as many shards on every "
                         f"process, got {counts}")
    first = planes[mesh.device(local[0])]
    mine = torch.stack([planes[mesh.device(p)][index][(slice(None),) + band(
        p, H, W)].to(first.device) for p in local])
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    rank = this_rank()
    for r, part in enumerate(parts):
        owned = [p for p in mesh.positions() if mesh.rank(p) == r]
        for k, pos in enumerate(owned):
            rows, cols = band(pos, H, W)
            for dev, t in planes.items():
                if r != rank or dev != mesh.device(pos):
                    for j, i in enumerate(index):
                        t[i, rows, cols] = part[k][j]
    return planes
