"""K9: K steps of one shard of a domain-decomposed grid, from the shard's
rows and its neighbours' halos (counterpart of ``lb2d_tpu.ops.fused_halo``).

:func:`temporal_halo_step` ports ``make_temporal_halo_step``
(``lb2d_tpu/ops/fused_halo.py:93``, its ``pl.pallas_call`` at ``:443``)
with each of its physics: ``"flow"``, ``"velocity_inlet"``,
``"diffusion"``, ``"noisy_fisher"``, ``"multifield_fisher"`` and
``"multifield_expansion"``. It computes for one shard what K2 and K4
compute for the whole grid: the shard ``f [P, H, W]`` (global rows
``[y0, y0 + H)``, columns ``[x0, x0 + W)`` of an ``ny x nx`` grid) is
extended by a :class:`Halo` of ``hk >= k_steps`` cells on each side, and
``k_steps`` steps of it are written to ``f_out [P, H, W]``, read once and
written once. The halo exchange runs outside the kernel
(:mod:`lb2d_tpu_torch.parallel.halo`), as in JAX.

Every cell applies its physics by its global coordinates and draws its
noise by its global cell index, as K2 and K4 do through their wrap. So the
Zou-He walls and corners, the no-flux walls and the noise of a sharded run
are those of the unsharded run: a shard on the grid's edge receives the
opposite shard's rows (the ring), which are what K2/K4 read through their
wrap, and JAX's wall band patch (``lb2d_tpu/parallel/sharded.py:501-580``)
has no counterpart. The halo is ``k_steps`` cells wide, not JAX's CH = 8/16
rows or 128 lanes, which are TPU DMA alignment; any shard shape works.

On CUDA tensors the wrapper launches K9 (``csrc/halo_step.cu`` and
``csrc/multifield_step.cu``), counted in ``temporal_halo_step.launches``.
K9 is K2's and K4's row sweep (``csrc/row_sweep.cuh``, mirrored by
:mod:`~lb2d_tpu_torch.ops.sweep`), templated on the region's source and
run on a halo source (``csrc/region_source.cuh``): a block sweeps a strip
of the shard's columns down a segment of its rows, reading each input row
of the halo-extended region once and writing the shard's rows, at most
:func:`halo_max_k` steps per launch (8), by default ``HALO_TEMPORAL_K``;
every physics, the velocity inlet too, runs the sweep. On CPU tensors the
wrapper runs the plain twin, :func:`temporal_halo_step_reference`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.tracing import traced_launch
from . import sweep
from .boundary import GridCoords
from .fused import (
    _check_k,
    _check_outlet,
    _check_step0,
    _diffusion_args,
    _launch,
    _multifield_constants,
    _multifield_params,
    diffusion_step_reference,
    expansion_step_reference,
    fisher_step_reference,
    multifield_max_k,
    noisy_fisher_step_reference,
    pipe_step_reference,
    velocity_step_reference,
)
from .random import population_normals_at

__all__ = ["Halo", "HALO_PHYSICS", "HALO_TEMPORAL_K",
           "HALO_SWEEP_PHYSICS",
           "supports_temporal_halo", "halo_max_k", "cut_region",
           "check_pieces", "temporal_halo_step",
           "temporal_halo_step_reference"]

# steps per launch of the sharded models: the unsharded models' K
# (TEMPORAL_K, DIFFUSION_TEMPORAL_K, NOISY_TEMPORAL_K), which K9's K sweep
# at the main paths' shards also picks on an H100 (K = 7 and 8 tie for
# diffusion; PERF.md, section 6); the velocity inlet's 3, the fastest per
# step at its 100 x 401 shard on the sweep (0.0059 ms by graph replay, K =
# 4 0.0061, 6 0.0065, 8 0.0076)
HALO_TEMPORAL_K = {"flow": 4, "velocity_inlet": 3, "diffusion": 8,
                   "noisy_fisher": 4}
# the physics on K2's row sweep (the multifield ones run K4's)
HALO_SWEEP_PHYSICS = ("flow", "velocity_inlet", "diffusion", "noisy_fisher")

# each physics and the keyword arguments of its step
_ARGS = {
    "flow": ("omega", "inlet_rho", "outlet_rho", "incompressible"),
    "velocity_inlet": ("omega", "u_w", "u_e", "outlet", "incompressible"),
    "diffusion": ("omega", "u_lb", "v_lb", "lb_G"),
    "noisy_fisher": ("omega", "u_lb", "v_lb", "lb_G", "lb_Dg", "seed"),
    "multifield_fisher": ("omegas", "lb_G", "u_lb", "v_lb"),
    "multifield_expansion": ("omegas", "omega_nutrient", "lb_G", "lb_Dg",
                             "cutoff", "u_lb", "v_lb", "seed"),
}
HALO_PHYSICS = tuple(_ARGS)


class Halo(NamedTuple):
    """One shard and what surrounds it.

    ``f`` ``[P, H, W]`` holds global rows ``[y0, y0 + H)`` and columns
    ``[x0, x0 + W)`` of an ``ny x nx`` grid; ``top`` and ``bot``
    ``[P, hk, W]`` the ``hk`` rows above and below it. ``left`` and
    ``right`` ``[P, H + 2 hk, hk]`` are the ``hk`` columns beside the
    y-extended rows (``top``, ``f``, ``bot``), so they carry the corners;
    both None when the shard spans the grid's width (``W == nx``) and x
    wraps within it."""
    f: torch.Tensor
    top: torch.Tensor
    bot: torch.Tensor
    left: torch.Tensor | None
    right: torch.Tensor | None
    y0: int
    x0: int
    ny: int
    nx: int

    @property
    def width(self) -> int:
        return self.top.shape[1]

    def coords(self) -> GridCoords:
        """The global coordinates of the halo-extended region
        ``[H + 2 hk, W + 2 hk]``."""
        hk = self.width
        H, W = self.f.shape[1:]
        dev = self.f.device
        row = (self.y0 - hk + torch.arange(H + 2 * hk, device=dev)) % self.ny
        lane = (self.x0 - hk + torch.arange(W + 2 * hk, device=dev)) % self.nx
        return GridCoords(row[:, None], lane[None, :], self.ny, self.nx)

    @classmethod
    def cut(cls, f: torch.Tensor, y0: int, x0: int, H: int, W: int,
            width: int) -> "Halo":
        """The shard ``[y0, y0 + H) x [x0, x0 + W)`` of a global ``[P, ny,
        nx]`` tensor and its ``width``-cell halo, each a contiguous copy
        (with the x strips when ``W < nx``). A halo exchange gives the same
        pieces."""
        ny, nx = f.shape[1:]
        strips = W < nx
        r = cut_region(f, y0, x0, H, W, width)
        w = width
        piece = lambda t: t.contiguous()  # noqa: E731
        return cls(piece(r[:, w:w + H, w:w + W]), piece(r[:, :w, w:w + W]),
                   piece(r[:, w + H:, w:w + W]),
                   piece(r[:, :, :w]) if strips else None,
                   piece(r[:, :, w + W:]) if strips else None, y0, x0, ny, nx)

    def extended(self) -> torch.Tensor:
        """The region ``[P, H + 2 hk, W + 2 hk]`` as one tensor."""
        hk = self.width
        rows = torch.cat([self.top, self.f, self.bot], dim=1)
        if self.left is None:
            W = self.f.shape[2]
            cols = torch.arange(-hk, W + hk, device=rows.device) % W
            return rows.index_select(2, cols)
        return torch.cat([self.left, rows, self.right], dim=2)


def halo_max_k(physics: str, num_fields: int = 1) -> int:
    """The most steps of one K9 launch: the row sweep's limit (K4's for
    ``num_fields`` fields)."""
    if physics.startswith("multifield"):
        return multifield_max_k(num_fields)
    return sweep.max_k(1)


def supports_temporal_halo(H: int, W: int, k_steps: int,
                           x_sharded: bool = True,
                           max_k: int = sweep.MAX_SWEEP_K) -> bool:
    """Whether K9 can take ``k_steps`` steps per sweep on ``H x W`` shards:
    ``1 <= k_steps <= min(H, W if x_sharded, max_k)`` (a halo of
    ``k_steps`` rows comes from one neighbour). JAX's TPU gates (lane
    alignment, chunk height, ring depth) have no counterpart."""
    edge = min(H, W) if x_sharded else H
    return 1 <= k_steps <= min(edge, max_k)


def cut_region(a: torch.Tensor, y0: int, x0: int, rows: int, cols: int,
               width: int) -> torch.Tensor:
    """Rows ``[y0 - width, y0 + rows + width)`` and columns ``[x0 - width,
    x0 + cols + width)`` of the last two axes of ``a``, wrapping around the
    grid (a new tensor): a block with its ``width``-cell ring, for example a
    shard's obstacle mask with its halo."""
    ny, nx = a.shape[-2:]
    ys = torch.arange(y0 - width, y0 + rows + width, device=a.device) % ny
    xs = torch.arange(x0 - width, x0 + cols + width, device=a.device) % nx
    return a.index_select(-2, ys).index_select(-1, xs)


def _plain_step(physics, kw, mask):
    """``step(f, at, step) -> f``: one plain step of ``physics`` on a
    region ``f [P, R, C]`` whose global coordinates are ``at``, at global
    step ``step`` (the noise's counter)."""
    if physics == "flow":
        return lambda f, at, step: pipe_step_reference(
            f, kw["omega"], kw["inlet_rho"], kw["outlet_rho"],
            incompressible=kw["incompressible"], mask=mask, at=at)
    if physics == "velocity_inlet":
        return lambda f, at, step: velocity_step_reference(
            f, kw["omega"], kw["u_w"], kw["u_e"], outlet=kw["outlet"],
            incompressible=kw["incompressible"], mask=mask, at=at)
    if physics == "diffusion":
        return lambda f, at, step: diffusion_step_reference(
            f, kw["omega"], kw["u_lb"], kw["v_lb"], kw["lb_G"])
    if physics == "noisy_fisher":
        def noisy(f, at, step):
            eta = (_normals_at(kw["seed"], step, 1, at)[0] if kw["lb_Dg"]
                   else None)
            return noisy_fisher_step_reference(
                f, kw["omega"], kw["u_lb"], kw["v_lb"], kw["lb_G"],
                kw["lb_Dg"], seed=kw["seed"], step=step, eta=eta)
        return noisy

    def multifield(f, at, step):
        f4 = f.reshape(9, -1, *f.shape[1:])
        if physics == "multifield_fisher":
            out = fisher_step_reference(f4, kw["omegas"], kw["lb_G"],
                                        kw["u_lb"], kw["v_lb"], at)
        else:
            P = f4.shape[1] - 1
            eta = (_normals_at(kw["seed"], step, P, at)
                   if np.any(np.asarray(kw["lb_Dg"], np.float32)) else None)
            out = expansion_step_reference(
                f4, kw["omegas"], kw["omega_nutrient"], kw["lb_G"],
                kw["lb_Dg"], kw["cutoff"], kw["u_lb"], kw["v_lb"],
                seed=kw["seed"], step=step, eta=eta)
        return out.reshape(f.shape)
    return multifield


def _normals_at(seed, step, P, at):
    """The normals ``[P, R, C]`` of populations ``0 .. P-1`` at the global
    cells of ``at``."""
    cells = (at.row * at.nx + at.lane).reshape(-1)
    return population_normals_at(seed, step, P, cells).reshape(
        P, at.row.shape[0], at.lane.shape[1])


def temporal_halo_step_reference(halo: Halo, k_steps: int, physics: str, *,
                                 mask: torch.Tensor | None = None,
                                 step0: int = 0, **kw) -> torch.Tensor:
    """``k_steps`` plain steps of the shard of ``halo`` (the plain twin of
    K9; returns a new ``[P, H, W]`` tensor).

    It builds the halo-extended region, runs the plain step of ``physics``
    on it ``k_steps`` times with the BCs by global coordinates
    (:class:`~lb2d_tpu_torch.ops.boundary.GridCoords`) and the noise of
    global step ``step0 + s`` at the global cells, and returns the shard's
    cells. The region's own wrap brings garbage in at its edges, one cell
    deeper per step, so after ``k_steps <= hk`` steps the shard is exact.
    ``mask`` is the obstacle mask of the region ``[H + 2 hk, W + 2 hk]``
    (:func:`cut_region`); ``kw`` the arguments of the physics' step.
    """
    _check_args(physics, kw)
    hk = halo.width
    H, W = halo.f.shape[1:]
    step = _plain_step(physics, kw, mask)
    at = halo.coords()
    f = halo.extended()
    for s in range(int(k_steps)):
        f = step(f, at, step0 + s)
    return f[:, hk:hk + H, hk:hk + W].contiguous()


@traced_launch
def temporal_halo_step(halo: Halo, f_out: torch.Tensor, k_steps: int,
                       physics: str, *, mask: torch.Tensor | None = None,
                       step0: int = 0, **kw) -> torch.Tensor:
    """Write ``k_steps`` steps of the shard of ``halo`` into ``f_out`` and
    return it; ``1 <= k_steps <= min(hk, halo_max_k(physics, F))``.

    ``physics`` is one of :data:`HALO_PHYSICS`; ``kw`` are its step's
    arguments, as the plain steps of :mod:`lb2d_tpu_torch.ops.fused` take
    them (``flow``: ``omega, inlet_rho, outlet_rho, incompressible``;
    ``velocity_inlet``: ``omega, u_w, u_e, outlet, incompressible``;
    ``diffusion``: ``omega, u_lb, v_lb, lb_G``; ``noisy_fisher``: those and
    ``lb_Dg, seed``; ``multifield_fisher``: ``omegas, lb_G, u_lb, v_lb``;
    ``multifield_expansion``: ``omegas, omega_nutrient, lb_G, lb_Dg,
    cutoff, u_lb, v_lb, seed``). The noisy physics draw at global steps
    ``step0 .. step0 + k_steps - 1``. ``mask`` (flow and velocity inlet) is
    the int32 obstacle mask of the halo-extended region.

    On CUDA tensors this launches K9 (counted in
    ``temporal_halo_step.launches``); on CPU tensors it runs
    :func:`temporal_halo_step_reference`.
    """
    P = _check_halo(halo, f_out, mask, physics)
    _check_args(physics, kw)
    k_steps = _check_k(k_steps, min(halo.width, halo_max_k(physics, P // 9)))
    step0 = _check_step0(step0, k_steps)
    entry = _entry_args(halo, f_out, mask, physics, k_steps, step0, kw)
    if halo.f.device.type == "cpu":
        f_out.copy_(temporal_halo_step_reference(
            halo, k_steps, physics, mask=mask, step0=step0, **kw))
        return f_out
    with torch.cuda.device(halo.f.device):  # shards may lie on several cards
        _launch(*entry)
    temporal_halo_step.launches += 1
    return f_out


temporal_halo_step.launches = 0


def _entry_args(halo, f_out, mask, physics, k_steps, step0, kw):
    """K9's C entry point for ``physics`` and its arguments (checking the
    physics' constants): ``lb2d_halo_multifield_step`` with K4's struct,
    or ``lb2d_halo_step`` with K2's scalars (omega, a, b, g, dg, key0,
    key1, step0)."""
    H, W = halo.f.shape[1:]
    pieces = (halo.f, halo.top, halo.bot, halo.left, halo.right)
    geometry = (H, W, halo.width, halo.y0, halo.x0, halo.ny, halo.nx)
    if physics.startswith("multifield"):
        F = halo.f.shape[0] // 9
        consts = _multifield_constants(
            F, physics[len("multifield_"):], kw["omegas"], kw["lb_G"],
            kw.get("omega_nutrient"), kw.get("lb_Dg"))
        params = _multifield_params(*consts, kw.get("cutoff", 0.01),
                                    kw["u_lb"], kw["v_lb"], kw.get("seed", 0),
                                    step0)
        return ("lb2d_halo_multifield_step", *pieces, f_out, *geometry, F,
                k_steps, int(physics == "multifield_expansion"), params)
    if physics in ("diffusion", "noisy_fisher"):
        noisy = physics == "noisy_fisher"
        args = _diffusion_args(kw["omega"], kw["u_lb"], kw["v_lb"],
                               kw["lb_G"], kw.get("lb_Dg", 0.0), noisy,
                               kw.get("seed", 0), step0)
        code, scalars = 3 + noisy, args[:5] + args[6:]
    else:
        if physics == "flow":
            code, a, b = 0, kw["inlet_rho"], kw["outlet_rho"]
        else:
            _check_outlet(kw["outlet"])
            code = 1 + (kw["outlet"] == "velocity")
            a, b = kw["u_w"], kw["u_e"]
        scalars = (float(kw["omega"]), float(a), float(b), 0.0, 0.0, 0, 0, 0)
    return ("lb2d_halo_step", *pieces, mask, f_out, *geometry, k_steps, code,
            int(bool(kw.get("incompressible", False))), *scalars)


def _check_args(physics, kw):
    if physics not in _ARGS:
        raise ValueError(f"physics must be one of {HALO_PHYSICS}, not "
                         f"{physics!r}")
    if set(kw) != set(_ARGS[physics]):
        raise TypeError(f"{physics} takes the arguments "
                        f"{sorted(_ARGS[physics])}, got {sorted(kw)}")


def _check_halo(halo, f_out, mask, physics):
    """Check the shapes, types and devices of a halo, its output and mask;
    return the number of planes P."""
    f = halo.f
    P, H, W = f.shape if f.dim() == 3 else (0, 0, 0)
    hk = halo.top.shape[1] if halo.top.dim() == 3 else 0
    multifield = physics.startswith("multifield")
    if P % 9 or (not multifield and P != 9) or hk < 1:
        raise ValueError(f"f must be [9, H, W] ([9F, H, W] for the "
                         f"multifield physics) with a halo of >= 1 row, got "
                         f"{tuple(f.shape)} and {hk} rows")
    check_pieces(halo, f_out)
    if mask is not None:
        if physics not in ("flow", "velocity_inlet"):
            raise ValueError(f"{physics} takes no obstacle mask")
        region = (H + 2 * hk, W + 2 * hk)
        if (mask.dtype != torch.int32 or tuple(mask.shape) != region
                or mask.device != f.device or not mask.is_contiguous()):
            raise ValueError(f"mask must be a contiguous int32 {region} "
                             f"tensor on f's device")
    return P


def check_pieces(halo: Halo, f_out: torch.Tensor | None = None) -> None:
    """Check that a halo's pieces (and ``f_out``, unless None) are
    contiguous float32 ``[P, rows, cols]`` tensors on ``f``'s device of the
    shapes a halo of ``halo.width`` cells around ``f [P, H, W]`` has, that
    the shard lies in its grid and that ``f_out`` is a distinct ``[P, H,
    W]`` tensor (the halo kernels' shared checks)."""
    f = halo.f
    pieces = {"f": f, "top": halo.top, "bot": halo.bot, "left": halo.left,
              "right": halo.right, "f_out": f_out}
    for name, t in pieces.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous() or t.device != f.device:
            raise ValueError(f"{name} must be a contiguous [P, rows, cols] "
                             f"tensor on f's device")
    P, H, W = f.shape
    hk = halo.width
    want = {"top": (P, hk, W), "bot": (P, hk, W)}
    if f_out is not None:
        want["f_out"] = (P, H, W)
    if (halo.left is None) != (halo.right is None):
        raise ValueError("give both x strips (left, right) or neither")
    if halo.left is None:
        if W != halo.nx:
            raise ValueError(f"a shard narrower than the grid ({W} < "
                             f"{halo.nx} columns) needs its x strips")
    else:
        want.update(left=(P, H + 2 * hk, hk), right=(P, H + 2 * hk, hk))
    for name, shape in want.items():
        if tuple(pieces[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(pieces[name].shape)}")
    if f_out is not None and f_out.data_ptr() == f.data_ptr():
        raise ValueError("f_out must be a distinct tensor (the step is out "
                         "of place)")
    if not (0 <= halo.y0 and halo.y0 + H <= halo.ny and 0 <= halo.x0
            and halo.x0 + W <= halo.nx):
        raise ValueError(f"a {H}x{W} shard at ({halo.y0}, {halo.x0}) does "
                         f"not lie in the {halo.ny}x{halo.nx} grid")
