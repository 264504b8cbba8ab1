"""K7's row sweep (``csrc/coupled_step.cu``) emulated in plain torch on the
CPU: its schedule, with the numbers of :mod:`~lb2d_tpu_torch.ops.sweep`.

The kernel runs only on the card. :func:`emulate` does what its blocks do,
phase by phase: the work items of the plan (strips of columns with a halo
of ``reach * k`` columns each side, wrapped in x; segments of rows with as
many warm-up rows each end, wrapped in y), the prefetched input row of the
next phase, the input ring and each level's ring with their slots per
direction group at the level's lag, the density ring of each level of the
physics that read their neighbours' densities, which level computes which
row at which phase, and the last level's writes. Every ring slot starts
as NaN and carries the phase of the row it holds, checked at every read;
every cell of the result must be written exactly once.

A level's cells go through the plain update of their physics
(:mod:`~lb2d_tpu_torch.ops.fused_coupled`) on a batch of rows, one row per
work item: the pulled (post-stream) values from the ring below, the belt
sums of the neighbours' densities from the density ring (their psi or S
evaluated there, as the kernel's density stage stores them), and the
velocity planes at the cells' global coordinates. So the emulated sweep
equals ``k`` plain steps bit for bit (``tests/test_torch_coupled_sweep.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from . import sweep
from .fused_coupled import (
    CoupledConfig,
    _belt_terms,
    _rocket_yeast_update,
    _screened_fisher_update,
    _surfactant_update,
)

__all__ = ["emulate"]

CX, CY = D2Q9.cx, D2Q9.cy
_GROUPS = np.asarray(sweep.GROUP)


def _ring_rows(t, lag, first, level_lag):
    """Each direction's ring row in a level's ring for the row written
    ``lag(g)`` phases before phase ``t`` (``lag`` a function of the
    direction's group), and each group's slot."""
    rows, slots = [], []
    for j in range(9):
        g = sweep.GROUP[j]
        d = sweep.depth(g, first, level_lag)
        slot = (t - lag(g)) % d
        rows.append(sweep.group_base(g, first, level_lag) + 3 * slot
                    + sweep.SLOT[j])
        slots.append(slot)
    return rows, np.asarray(slots)


def _update(cfg, post, belt, ext):
    """One level's cells: ``post [9, F, B, C]`` the pulled values, ``belt``
    the belt sums' source or None, ``ext [2, B, C]`` or None."""
    if cfg.physics.startswith("rocket_yeast"):
        return _rocket_yeast_update(post, cfg, belt)
    if cfg.physics == "screened_fisher":
        return _screened_fisher_update(post[:, 0], cfg, ext)[:, None]
    return _surfactant_update(post, cfg, ext, belt=belt)


def emulate(f0: torch.Tensor, cfg: CoupledConfig, k: int, slots: int,
            ext: torch.Tensor | None = None, shard=None) -> torch.Tensor:
    """``k`` steps of ``f0 [9, F, ny, nx]`` by K7's schedule, the velocity
    planes ``ext [2, ny, nx]`` (global) held; ``slots``: the resident
    blocks the plan fills. The rings hold the columns of a strip and a
    blank column each side, where a pull from outside the strip lands.

    With ``shard = (y0, x0, ny, nx, hk)`` the sweep is K7h's on one shard
    (the domain ``[H, W]`` at global row ``y0`` and column ``x0`` of an
    ``ny x nx`` grid): ``f0 [9, F, H + 2 hk, W + 2 hk]`` is its
    halo-extended region (``Halo.extended()``); domain cell (y, x) loads
    from region cell (y + hk, x + hk), which must lie inside the region,
    and the result is the shard's ``[9, F, H, W]``."""
    F = f0.shape[1]
    belt = cfg.belt
    R, L = sweep.coupled_reach(belt), sweep.coupled_lag(belt)
    hal = R * k
    ny, nx = f0.shape[2:]
    y_off = x_off = hk = 0
    if shard is not None:
        y_off, x_off, ny, nx, hk = shard
        assert hal <= hk
    rows_d, cols_d = f0.shape[2] - 2 * hk, f0.shape[3] - 2 * hk
    D = sweep.PREFETCH
    pl = sweep.plan(rows_d, cols_d, hal, F, slots)
    strip = torch.arange(pl.strips).repeat_interleave(pl.segments)
    seg = torch.arange(pl.segments).repeat(pl.strips)
    xs, ys = strip * pl.wo, seg * pl.seg
    width = torch.clamp(cols_d - xs, max=pl.wo) + 2 * hal  # region columns
    rows = torch.clamp(rows_d - ys, max=pl.seg)            # rows written
    inputs = rows + 2 * hal
    n, W = len(xs), sweep.strip_width(F)
    assert int(width.max()) <= W
    cols = torch.arange(W)
    lx = xs[:, None] - hal + cols                 # domain columns [n, W]
    gx = (x_off + lx) % nx                        # global columns
    inside = cols < width[:, None]
    nan = float("nan")
    rings = [torch.full((n, sweep.level_rows(s == 0, L), F, W + 2), nan)
             for s in range(k)]
    tags = [np.full((n, 3, 8), -1) for _ in range(k)]
    dens = [torch.full((n, sweep.DENSITY_SLOTS, F, W + 2), nan)
            for _ in range(k)]
    dtags = [np.full((n, sweep.DENSITY_SLOTS), -1) for _ in range(k)]
    out = torch.full((9, F, rows_d, cols_d), nan)
    written = torch.zeros(rows_d, cols_d, dtype=torch.int64)

    def load(t):
        """The input row of phase t into the input ring (cp.async: issued
        now, read from phase t + 1)."""
        act = t < inputs
        if not act.any():
            return
        y = ys - hal + t                                   # domain rows [n]
        if shard is None:
            r, c = y % ny, lx % nx
        else:
            r, c = y + hk, lx + hk
            used = act[:, None] & inside
            assert ((r[:, None] >= 0) & (r[:, None] < f0.shape[2]) & (c >= 0)
                    & (c < f0.shape[3]))[used].all(), t
            r, c = r.clamp(0, f0.shape[2] - 1), c.clamp(0, f0.shape[3] - 1)
        vals = f0[:, :, r[:, None], c].permute(2, 0, 1, 3)  # [n, 9, F, W]
        row, slot = _ring_rows(t, lambda g: 0, True, L)
        sel = (act[:, None] & inside)[:, None, None, :]
        rings[0][:, row, :, 1:-1] = torch.where(sel, vals,
                                                rings[0][:, row, :, 1:-1])
        tags[0][np.nonzero(act.numpy())[0][:, None], _GROUPS, slot] = t

    def pulled(s, t, lag, items):
        """The 9 pulls of every column of level s's input (ring s - 1),
        from the rows written lag(g) phases ago: [9, F, B, W]."""
        row, slot = _ring_rows(t, lag, s == 1, L)
        held = tags[s - 1][items.numpy()][:, _GROUPS, slot]
        want = t - np.asarray([lag(g) for g in _GROUPS])
        assert (held == want).all(), (s, t)
        picked = rings[s - 1][items][:, row]              # [B, 9, F, W + 2]
        idx = (cols[None, :] - torch.tensor(CX)[:, None] + 1)  # [9, W]
        idx = idx[None, :, None, :].expand(len(items), 9, F, W)
        # contiguous, as the plain step's state: its densities add the 9
        # directions in the same order
        return picked.gather(-1, idx).permute(1, 2, 0, 3).contiguous()

    for t in range(D):
        load(t)
    for t in range(int(rows.max()) + (R + L) * k):
        load(t + D)
        for s in range(1, k + 1):
            if belt:  # the density stage: row t - L s + 2 of its input
                dr, lo = t - L * s + 2, R * (s - 1) + 1
                act = (dr >= lo) & (dr < inputs - lo)
                items = act.nonzero(as_tuple=True)[0]
                if len(items):
                    rho = pulled(s, t, lambda g: 1 + g, items).sum(dim=0)
                    valid = (cols >= lo) & (cols < (width[items] - lo)[:, None])
                    sl = t % sweep.DENSITY_SLOTS
                    cur = dens[s - 1][items, sl, :, 1:-1]
                    dens[s - 1][items, sl, :, 1:-1] = torch.where(
                        valid[:, None, :], rho.permute(1, 0, 2), cur)
                    dtags[s - 1][items.numpy(), sl] = t
            u = t - L * s                                     # region rows
            act = (u >= R * s) & (u < inputs - R * s)
            items = act.nonzero(as_tuple=True)[0]
            if not len(items):
                continue
            post = pulled(s, t, lambda g: L - 1 + g, items)
            y = ys[items] - hal + u                           # domain rows
            gy = (y_off + y) % ny
            belt_of = None
            if belt:
                def belt_of(g, s=s, items=items, t=t):
                    """The belt sums of g(rho) from the density ring: row
                    y + cy written at phase t - 2 + cy."""
                    def shifted(cx, cy):
                        sl = (t - 2 + cy) % sweep.DENSITY_SLOTS
                        assert (dtags[s - 1][items.numpy(), sl]
                                == t - 2 + cy).all(), (s, t)
                        nb = dens[s - 1][items, sl, :, 1 + cx:1 + cx + W]
                        return g(nb.permute(1, 0, 2))         # [B, W]
                    return _belt_terms(shifted)
            e = (ext[:, gy[:, None], gx[items]] if cfg.reads_ext else None)
            new = _update(cfg, post, belt_of, e)              # [9, F, B, W]
            valid = (cols >= R * s) & (cols < (width[items] - R * s)[:, None])
            assert not torch.isnan(new.permute(2, 3, 0, 1)[valid]).any(), t
            if s < k:
                row, slot = _ring_rows(t, lambda g: 0, False, L)
                cur = rings[s][items][:, row, :, 1:-1]
                rings[s][items[:, None], torch.tensor(row)[None, :], :,
                         1:-1] = torch.where(valid[:, None, None, :],
                                             new.permute(2, 0, 1, 3), cur)
                tags[s][items.numpy()[:, None], _GROUPS, slot] = t
                continue
            bb, cc = valid.nonzero(as_tuple=True)
            yy, xx = y[bb], lx[items[bb], cc]
            out[:, :, yy, xx] = new[:, :, bb, cc]
            written.index_put_((yy, xx), torch.ones_like(yy), accumulate=True)
    assert (written == 1).all()
    return out
