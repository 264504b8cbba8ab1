"""K2's, K4's and K9's row sweep on the CPU: its schedule, emulated in plain
torch.

The kernels (``lb2d_tpu_torch/csrc/temporal_step.cu``,
``multifield_step.cu``, on ``row_sweep.cuh``) run only on the card. What
they do with the numbers of :mod:`lb2d_tpu_torch.ops.sweep` is written out
here, used by these tests only: the work items of the plan (strips of
columns wrapped in x, segments of rows with K warm-up rows each end,
wrapped in y), the input ring and the ring of each level with their slots
per direction group, the mask ring, which level computes which row at
which phase, the prefetch of the next input row, and the last level's
writes. Every ring slot starts as NaN and every mask slot as -1; each ring
slot carries the phase of the row it holds, checked at every read, and
every cell of the result must be written exactly once.

A level's cells go through the plain step of their physics on a batch of
rows: the pulled values, un-streamed (the inverse roll of each direction,
so the step's own stream gives them back exactly), with the cells' global
coordinates (``GridCoords``), their mask and their noise. So the emulated
sweep must equal ``K`` plain steps bit for bit, for flow (compressible and
incompressible, with and without an obstacle), the velocity inlet (both
outlets and equilibria, with and without an obstacle; the zero-gradient
outlet takes its cell's own column from the rings), diffusion, the noisy
Fisher wave, FisherExpansion at F = 1, 2, 5, 8 and Expansion at F = 2, 5, 8: at every K
from 1 to the kernels' maximum at 7x300, 45x33 and 64x64, and at K = 1 and
the maximum at 254x382 (up to F = 2). At 7x300 and 254x382 K2's strips of
128 columns are several, and the first strip's halo wraps at x = 0 into
the outlet's columns.

The schedule test runs the same emulation on identities instead of values:
each kept cell checks that every pull, and its own column's directions 3,
6 and 7, come from the right level, row, column and direction (and its
mask from the right cell), at every K and at all four grids for strips of
128 and 64 columns, at K = 1 and 8 at 254x382 for strips of 32. And the
budget: shared memory and blocks per SM for each F and K against the 227 KB
a block may have; the plan's cut, pinned at the main paths' grids and
shards; and K2's block layout.

K9 is the same sweep on one shard: it reads its rows through the shard's
halo-extended region (``Halo.extended()``), every cell with its global
coordinates, and writes only the shard's rows. Shards cut 2x1, 1x3 and 2x2
from 37x53 and 30x47 grids (ragged, narrower than one strip, x wrapping
within the shard in the 2x1 cuts) go through the emulation with
identities at every K (and a 40x301 cut whose shards take two strips) and
with the flow, velocity inlet, diffusion and noisy Fisher plain updates at
K = 1, 4, 8,
against K9's plain twin and the plain whole-grid steps.
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.ops import sweep
from lb2d_tpu_torch.halo_cases import shard_cuts
from lb2d_tpu_torch.ops.boundary import GridCoords
from lb2d_tpu_torch.ops.fused import (
    MAX_MULTIFIELD_FIELDS,
    MAX_TEMPORAL_K,
    diffusion_run_reference,
    diffusion_step_reference,
    expansion_step_reference,
    fisher_step_reference,
    multifield_max_k,
    multifield_run_reference,
    noisy_fisher_step_reference,
    pipe_run_reference,
    pipe_step_reference,
    velocity_step_reference,
)
from lb2d_tpu_torch.ops.fused_halo import (
    Halo,
    cut_region,
    temporal_halo_step_reference,
)
from lb2d_tpu_torch.ops.random import (
    normals_reference,
    population_normals_reference,
)

torch.set_num_threads(1)

CX, CY = D2Q9.cx, D2Q9.cy
SHAPES = ((7, 300), (45, 33), (64, 64), (254, 382))
# resident blocks the plan fills: for the schedule, the H100's 132 SMs at
# two blocks at 7x300 (segments of one row, fewer rows than the plan's
# segments), a few segments elsewhere (a card's wave of them costs the
# emulation 2K rows of warm-up each); for the physics, a few everywhere
SLOTS = {(7, 300): 264, (45, 33): 6, (64, 64): 4, (254, 382): 12}
PHYSICS_SLOTS = {**SLOTS, (7, 300): 8}
STEP0 = 2**32 - 3  # K steps that cross the noise counter's high word


def _unstream(pulled):
    """The state whose stream (``ops/stream.py``) gives ``pulled``."""
    planes = []
    for j in range(9):
        p = pulled[j]
        if CY[j]:
            p = torch.roll(p, -CY[j], dims=-2)
        if CX[j]:
            p = torch.roll(p, -CX[j], dims=-1)
        planes.append(p)
    return torch.stack(planes)


def _rows(t, first, lagged):
    """The ring row of each direction and its (group, slot): for the row
    of phase t, or with ``lagged`` for the row direction j is read from at
    phase t, written at t - 1 - group (row_sweep.cuh: sweep_load_offset,
    SweepPhase)."""
    rows, slots = [], []
    for j in range(9):
        g = sweep.GROUP[j]
        slot = (t - (1 + g if lagged else 0)) % sweep.depth(g, first)
        rows.append(sweep.group_base(g, first) + 3 * slot + sweep.SLOT[j])
        slots.append(slot)
    return rows, slots


def emulate(f0, k, slots, update, mask=None, shard=None):
    """``k`` steps of ``f0 [9, P, ny, nx]`` by the row sweep's schedule.
    ``update(pulled [9, P, B, C], gy [B], gx [B, C], stage [B], solid [B, C]
    or None, valid [B, C], own [3, P, B, C])`` computes one level's cells of
    B rows (stage is s - 1; ``valid``: the columns the level keeps; ``own``:
    directions 3, 6, 7 of each cell's own column in the group rows its
    pulls read, rows y, y - 1, y + 1, which the zero-gradient outlet
    reads). The rings hold the C
    columns of the widest region (no block touches the columns past its
    region) and a blank column each side, where a pull from outside the
    region lands. A float ``f0`` starts every slot as NaN, an integer one
    as -1.

    With ``shard = (y0, x0, ny, nx, hk)`` the sweep is K9's on one shard
    (the domain ``[H, W]`` at global row ``y0`` and column ``x0`` of an
    ``ny x nx`` grid): ``f0 [9, P, H + 2 hk, W + 2 hk]`` is its
    halo-extended region (``Halo.extended()``) and ``mask`` the region's
    mask. Domain cell (y, x) loads from region cell (y + hk, x + hk), which
    must lie inside the region (a strip reads at most k cells past the
    shard); the update gets the cells' global coordinates, and the result
    is the shard's rows ``[9, P, H, W]``."""
    _, P, ny, nx = f0.shape
    y_off = x_off = hk = 0
    if shard is not None:
        y_off, x_off, ny, nx, hk = shard
        assert k <= hk
    rows_d, cols_d = f0.shape[2] - 2 * hk, f0.shape[3] - 2 * hk
    D = sweep.PREFETCH
    pl = sweep.plan(rows_d, cols_d, k, P, slots)
    strip = torch.arange(pl.strips).repeat_interleave(pl.segments)
    seg = torch.arange(pl.segments).repeat(pl.strips)
    xs, ys = strip * pl.wo, seg * pl.seg
    width = torch.clamp(cols_d - xs, max=pl.wo) + 2 * k  # region columns
    rows = torch.clamp(rows_d - ys, max=pl.seg)          # rows written
    inputs = rows + 2 * k
    n, W = len(xs), int(width.max())
    assert W <= sweep.strip_width(P)
    cols = torch.arange(W)
    lx = xs[:, None] - k + cols                       # domain columns [n, W]
    gx = (x_off + lx) % nx                            # global columns
    inside = cols < width[:, None]
    blank = float("nan") if f0.is_floating_point() else -1
    ring_in = torch.full((n, sweep.level_rows(True), P, W + 2), blank,
                         dtype=f0.dtype)
    rings = torch.full((k - 1, n, sweep.level_rows(False), P, W + 2), blank,
                       dtype=f0.dtype)
    tag_in = np.full((n, 3, 3 + D + 1), -1)
    tags = np.full((k - 1, n, 3, 4), -1)
    mask_rows = 2 * k + D + 1
    mring = torch.full((n, mask_rows, W), -1, dtype=torch.int8)
    out = torch.full((9, P, rows_d, cols_d), blank, dtype=f0.dtype)
    written = torch.zeros(rows_d, cols_d, dtype=torch.int64)
    # the pull of direction j at column c reads ring column c - cx_j
    pull_cols = (cols[None, :] - torch.tensor(CX)[:, None] + 1).view(
        9, 1, W)
    groups = torch.tensor(sweep.GROUP)

    def source(t):
        """The items that load at phase t, and the cells of f0 (and mask)
        their input row's columns come from."""
        act = t < inputs
        y = ys - k + t                                # domain rows [n]
        if shard is None:  # K2: the grid, wrapped
            return act, y % ny, lx % nx
        r, c = y + hk, lx + hk
        used = act[:, None] & inside
        assert ((r[:, None] >= 0) & (r[:, None] < f0.shape[2]) & (c >= 0)
                & (c < f0.shape[3]))[used].all(), t
        return act, r.clamp(0, f0.shape[2] - 1), c.clamp(0, f0.shape[3] - 1)

    def load(t):  # the input row of phase t, for the items that have one
        act, r, c = source(t)
        if not act.any():
            return None
        vals = f0[:, :, r[:, None], c].permute(2, 0, 1, 3)  # [n, 9, P, W]
        row, slot = _rows(t, True, False)
        sel = (act[:, None] & inside)[:, None, None, :]
        ring_in[:, row, :, 1:-1] = torch.where(sel, vals,
                                               ring_in[:, row, :, 1:-1])
        tag_in[np.nonzero(act.numpy())[0][:, None], groups.numpy(), slot] = t
        return r, c

    def put_mask(t, rc):
        if mask is None or rc is None:
            return
        r, c = rc
        act = (t < inputs)[:, None] & inside
        m = t % mask_rows
        mring[:, m] = torch.where(act, mask[r[:, None], c].to(torch.int8),
                                  mring[:, m])

    def pulled(ring, tag, first, t, act):
        """The 9 pulls of every column from a level's group rows written at
        phases t - 1, t - 2, t - 3 (rows y + 1, y, y - 1), and directions
        3, 6, 7 of the column itself: [..., 12, P, W]."""
        row, slot = _rows(t, first, True)
        held = tag[..., groups.numpy(), slot]         # [..., 9]
        assert (held[act] == t - 1 - groups.numpy()).all(), t
        picked = ring[..., row, :, :]                 # [..., 9, P, W + 2]
        idx = pull_cols.expand(picked.shape[:-1] + (W,))
        own = picked[..., [3, 6, 7], :, 1:-1]
        return torch.cat([picked.gather(-1, idx), own], dim=-3)

    for t in range(D):
        put_mask(t, load(t))
    s = torch.arange(1, k + 1)[:, None]
    for t in range(int(rows.max()) + 3 * k):
        r_next = load(t + D)
        active = (t >= 3 * s) & (t < inputs[None, :] + s)   # [k, n]
        if active.any():
            an = active.numpy()
            parts = [pulled(ring_in, tag_in, True, t, an[0])[None]]
            if k > 1:
                parts.append(pulled(rings, tags, False, t, an[1:]))
            lev, item = active.nonzero(as_tuple=True)
            batch = torch.cat(parts)[lev, item].transpose(0, 1)  # [12, B, P, W]
            batch, own = batch.transpose(1, 2).split([9, 3])  # [9, P, B, W]
            y = ys[item] - k + t - 2 * (lev + 1)      # domain rows
            gy = (y_off + y) % ny
            solid = None
            if mask is not None:
                m = mring[item, (t - 2 * (lev + 1)) % mask_rows]
                solid = m > 0
            valid = (cols >= (lev + 1)[:, None]) & (
                cols < (width[item] - lev - 1)[:, None])
            if mask is not None:
                assert (m[valid] >= 0).all(), t
            new = update(batch, gy, gx[item], lev, solid, valid, own)
            kept = new.permute(2, 3, 0, 1)[valid]
            assert not (torch.isnan(kept) if kept.is_floating_point()
                        else kept < 0).any(), t
            last = lev == k - 1
            b = (~last).nonzero(as_tuple=True)[0]
            if len(b):  # levels 1..K-1 into their rings
                row, slot = _rows(t, False, False)
                li, ii = lev[b][:, None], item[b][:, None]
                cur = rings[li, ii, torch.tensor(row)[None, :], :, 1:-1]
                rings[li, ii, torch.tensor(row)[None, :], :, 1:-1] = \
                    torch.where(valid[b][:, None, None, :],
                                new[:, :, b].permute(2, 0, 1, 3), cur)
                tags[lev[b].numpy()[:, None], item[b].numpy()[:, None],
                     groups.numpy(), slot] = t
            b = last.nonzero(as_tuple=True)[0]
            bb, cc = valid[b].nonzero(as_tuple=True)
            yy, xx = y[b][bb], lx[item[b]][bb, cc]
            out[:, :, yy, xx] = new[:, :, b[bb], cc]
            written.index_put_((yy, xx), torch.ones_like(yy), accumulate=True)
        put_mask(t + D, r_next)
    assert (written == 1).all()
    return out


# -- the physics: one level's batch, and K plain steps ------------------------

def _coords(gy, gx, ny, nx):
    return GridCoords(gy[:, None], gx, ny, nx)


FLOW_KW = dict(omega=1.7, inlet_rho=1.003, outlet_rho=0.997)
DIFFUSION_KW = dict(omega=1.6, u_lb=0.02, v_lb=-0.03, lb_G=0.02)
NOISE_SEED, NOISE_DG = 11, 0.05


def _flow_case(incompressible, obstacle):
    kw = dict(FLOW_KW, incompressible=incompressible)

    def update(ny, nx):
        def fn(p, gy, gx, stage, solid, valid, own):
            return pipe_step_reference(_unstream(p[:, 0]), mask=solid,
                                       at=_coords(gy, gx, ny, nx), **kw)[:, None]
        return fn

    def plain(f, mask, step):
        return pipe_run_reference(f[:, 0], 1, mask=mask, **kw)[:, None]
    return 1, update, plain, obstacle


VELOCITY_KW = dict(omega=1.7, u_w=0.05, u_e=0.04)


def _velocity_case(outlet, incompressible, obstacle):
    kw = dict(VELOCITY_KW, outlet=outlet, incompressible=incompressible)

    def update(ny, nx):
        def fn(p, gy, gx, stage, solid, valid, own):
            return velocity_step_reference(
                _unstream(p[:, 0]), mask=solid, at=_coords(gy, gx, ny, nx),
                **kw)[:, None]
        return fn

    def plain(f, mask, step):
        return velocity_step_reference(f[:, 0], mask=mask, **kw)[:, None]
    return 1, update, plain, obstacle


def _diffusion_case(noisy):
    kw = DIFFUSION_KW
    seed, dg = NOISE_SEED, NOISE_DG

    def update(ny, nx):
        if not noisy:
            return lambda p, gy, gx, stage, solid, valid, own: (
                diffusion_step_reference(_unstream(p[:, 0]), **kw)[:, None])
        eta = torch.stack([normals_reference(seed, STEP0 + s, ny, nx)
                           for s in range(MAX_TEMPORAL_K)])

        def fn(p, gy, gx, stage, solid, valid, own):
            e = eta[stage[:, None], gy[:, None], gx]
            return noisy_fisher_step_reference(
                _unstream(p[:, 0]), lb_Dg=dg, seed=seed, step=0, eta=e,
                **kw)[:, None]
        return fn

    def plain(f, mask, step):
        return diffusion_run_reference(f[:, 0], 1, noisy=noisy, seed=seed,
                                       step0=step, lb_Dg=dg if noisy else 0.0,
                                       **kw)[:, None]
    return 1, update, plain, False


def _multifield_case(physics, F):
    rng = np.random.RandomState(F)
    omegas = (1.2 + 0.5 * rng.rand(F)).astype(np.float32)
    kw = dict(omegas=omegas, lb_G=(0.05 * rng.rand(F)).astype(np.float32),
              u_lb=0.01, v_lb=-0.02)
    if physics == "expansion":
        P = F - 1
        kw.update(omegas=omegas[:P], omega_nutrient=omegas[P],
                  lb_G=kw["lb_G"][:P], cutoff=0.01,
                  lb_Dg=np.where(np.arange(P) % 3 == 1, 0.0,
                                 0.03).astype(np.float32))
    seed = 2**40 + 7

    def update(ny, nx):
        if physics == "fisher":
            args = (kw["omegas"], kw["lb_G"], kw["u_lb"], kw["v_lb"])
            return lambda p, gy, gx, stage, solid, valid, own: (
                fisher_step_reference(_unstream(p), *args,
                                      at=_coords(gy, gx, ny, nx)))
        eta = torch.stack([population_normals_reference(
            seed, STEP0 + s, F - 1, ny, nx) for s in range(multifield_max_k(F))])
        args = (kw["omegas"], kw["omega_nutrient"], kw["lb_G"], kw["lb_Dg"],
                kw["cutoff"], kw["u_lb"], kw["v_lb"])

        def fn(p, gy, gx, stage, solid, valid, own):
            e = eta[stage[:, None], :, gy[:, None], gx].permute(2, 0, 1)
            return expansion_step_reference(_unstream(p), *args, seed=seed,
                                            step=0, eta=e)
        return fn

    def plain(f, mask, step):
        return multifield_run_reference(f, 1, physics=physics, seed=seed,
                                        step0=step, **kw)
    return F, update, plain, False


# label: (planes, update, plain step, obstacle)
CASES = {
    "flow": _flow_case(False, False),
    "flow obstacle": _flow_case(False, True),
    "flow incompressible": _flow_case(True, False),
    "flow incompressible obstacle": _flow_case(True, True),
    "diffusion": _diffusion_case(False),
    "noisy_fisher": _diffusion_case(True),
    "velocity_inlet zero_gradient": _velocity_case(
        "zero_gradient", False, False),
    "velocity_inlet zero_gradient incompressible obstacle": _velocity_case(
        "zero_gradient", True, True),
    "velocity_inlet velocity obstacle": _velocity_case(
        "velocity", False, True),
    "velocity_inlet velocity incompressible": _velocity_case(
        "velocity", True, False),
    **{f"fisher F={F}": _multifield_case("fisher", F) for F in (1, 2, 5, 8)},
    **{f"expansion F={F}": _multifield_case("expansion", F)
       for F in (2, 5, 8)},
}


def _state(case, P, ny, nx):
    """A random state [9, P, ny, nx] (numpy seed 3) near each physics'
    equilibrium, and a random int32 obstacle mask (one cell in ten)."""
    rng = np.random.RandomState(3)
    w = np.asarray(D2Q9.w, np.float64)[:, None, None, None]
    if case.startswith(("flow", "velocity")):
        rho = np.ones((1, ny, nx))
    elif case.startswith("expansion"):
        rho = rng.rand(P, ny, nx) * 0.5
        rho[rng.rand(P, ny, nx) < 0.1] = 0.005  # below the cutoff
    else:  # densities in (0, 1), a few at 1 where the noise's slope is steep
        rho = rng.rand(P, ny, nx) / max(P, 1)
        rho[rng.rand(P, ny, nx) < 0.02] = 1.0 / max(P, 1)
    f = w * rho * (1 + 0.05 * rng.randn(9, P, ny, nx))
    mask = (rng.rand(ny, nx) < 0.1).astype(np.int32)
    return (torch.tensor(f, dtype=torch.float32),
            torch.tensor(mask))


def _code(level, j, p, y, x, P, ny, nx):
    """The identity of direction j of field p of cell (y, x) at level s."""
    return (((level * 9 + j) * P + p) * ny + y) * nx + x


def _provenance(P, ny, nx, mask):
    """An update that checks where every kept cell's pulls come from (level
    s - 1, direction j, the cell (y - cy_j, x - cx_j) wrapped), its mask
    and its level, and gives each of its values its own identity."""
    J = torch.arange(9)[:, None, None, None]
    F = torch.arange(P)[None, :, None, None]
    cx = torch.tensor(CX)[:, None, None, None]
    cy = torch.tensor(CY)[:, None, None, None]

    def fn(pulled, gy, gx, stage, solid, valid, own):
        s = stage[None, None, :, None] + 1
        y, x = gy[None, None, :, None], gx[None, None]
        want = _code(s - 1, J, F, (y - cy) % ny, (x - cx) % nx, P, ny, nx)
        assert (pulled == want).permute(2, 3, 0, 1)[valid].all()
        mine = [3, 6, 7]  # the cell's own column: rows y, y - 1, y + 1
        want = _code(s - 1, J[mine], F, (y - cy[mine]) % ny, x, P, ny, nx)
        assert (own == want).permute(2, 3, 0, 1)[valid].all()
        if mask is not None:
            assert (solid == (mask[gy[:, None], gx] != 0))[valid].all()
        return _code(s, J, F, y, x, P, ny, nx).expand(pulled.shape)
    return fn


def _schedule(planes, shape, ks):
    """Emulate the sweep on identities at each K of ``ks`` and check the
    last level's rows."""
    ny, nx = shape
    Y = torch.arange(ny)[:, None]
    X = torch.arange(nx)[None, :]
    J = torch.arange(9)[:, None, None, None]
    F = torch.arange(planes)[None, :, None, None]
    mask = torch.tensor((np.random.RandomState(1).rand(ny, nx) < 0.3
                         ).astype(np.int32)) if planes == 1 else None
    f0 = _code(0, J, F, Y, X, planes, ny, nx).expand(9, planes, ny, nx)
    for k in ks:
        got = emulate(f0, k, SLOTS[shape], _provenance(planes, ny, nx, mask),
                      mask)
        assert torch.equal(got, _code(k, J, F, Y, X, planes, ny, nx).expand(
            f0.shape)), (planes, shape, k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("planes", (1, 2, 4))  # strips of 128, 64, 32
def test_sweep_schedule(planes, shape):
    """At every K, every kept cell of level s pulls each direction from the
    right row, column and slot of level s - 1 (and its mask row), and the
    last level writes every cell of the grid once."""
    ks = range(1, sweep.max_k(planes) + 1)
    if planes > 2 and shape == (254, 382):  # the strips of 32 columns
        ks = (1, sweep.max_k(planes))      # cost the emulation the most
    _schedule(planes, shape, ks)


K2_COLS = 2  # temporal_sweep.cuh: kCols, the cells of a thread


def test_temporal_block_layout():
    """Each K2/K9 block (temporal_sweep.cuh): its threads' cells (columns c
    and c + W / 2 of levels lane + 1, lane + 1 + lanes, ..., an idle cell
    reading column s) cover every kept column of every level once, for
    every region width and K; its load lanes cover the 9 planes of every
    column once. And the zero-gradient outlet's own-column reads, written
    out in sweep_steps as group rows 1, 2, 0 at offsets 2W, 2W, W:
    directions 3, 6, 7 there."""
    assert [(sweep.GROUP[j], sweep.SLOT[j]) for j in (3, 6, 7)] == [
        (1, 2), (2, 2), (0, 1)]
    threads, W = sweep.SWEEP_THREADS, sweep.strip_width(1)
    span = W // K2_COLS
    lanes, load_lanes = threads // span, threads // W
    planes = sorted(l + i * load_lanes for l in range(load_lanes)
                    for i in range(-(-9 // load_lanes))
                    if l + i * load_lanes < 9)
    assert planes == list(range(9))
    for k in range(1, sweep.max_k(1) + 1):
        for width in range(2 * k + 1, W + 1):
            for s in range(1, k + 1):
                lane = (s - 1) % lanes
                cols = [t % span + i * span for t in range(threads)
                        if t // span == lane for i in range(K2_COLS)
                        if s <= t % span + i * span < width - s]
                assert sorted(cols) == list(range(s, width - s)), (
                    k, width, s)


def _physics_ks(P, shape):
    """The K of the bit-for-bit runs: every K at the small grids, 1 and the
    largest at 254x382."""
    if shape == (254, 382):
        return (1, sweep.max_k(P))
    return range(1, sweep.max_k(P) + 1)


# F >= 5 (strips of 32 columns, 45-72 planes) at 254x382 would cost the
# emulation most of this file's time: the small grids at every K and the
# schedule test there cover them
PHYSICS_RUNS = [(case, shape) for case in CASES for shape in SHAPES
                if shape != (254, 382) or CASES[case][0] <= 2]


@pytest.mark.parametrize("case,shape", PHYSICS_RUNS,
                         ids=[f"{c}-{s[0]}x{s[1]}" for c, s in PHYSICS_RUNS])
def test_sweep_equals_plain_steps(case, shape):
    """The emulated sweep with each physics' plain per-cell update equals K
    plain steps bit for bit."""
    P, update, plain, obstacle = CASES[case]
    ny, nx = shape
    f0, mask = _state(case, P, ny, nx)
    mask = mask if obstacle else None
    fn = update(ny, nx)
    ks = _physics_ks(P, shape)
    want = {0: f0}
    for k in range(1, ks[-1] + 1):
        want[k] = plain(want[k - 1], mask, STEP0 + k - 1)
    for k in ks:
        got = emulate(f0, k, PHYSICS_SLOTS[shape], fn, mask)
        assert torch.equal(got, want[k]), (case, shape, k)


def test_max_k_and_budget():
    """K2 and K4 take every K up to 8 whose rings fit one block (227 KB);
    the blocks per SM by shared memory."""
    assert MAX_TEMPORAL_K == sweep.max_k(1) == sweep.MAX_SWEEP_K == 8
    assert [multifield_max_k(F) for F in range(1, 9)] == [8] * 8
    for P in range(1, MAX_MULTIFIELD_FIELDS + 1):
        W = sweep.strip_width(P)
        assert sweep.SWEEP_THREADS % W == 0
        for k in range(1, 17):
            rows = 27 + 9 * sweep.PREFETCH + 27 * (k - 1)
            assert sweep.smem_bytes(k, P) == rows * P * W * 4
            fits = (sweep.smem_bytes(k, P, P == 1) <= sweep.SMEM_PER_BLOCK
                    and k <= sweep.MAX_SWEEP_K)
            assert fits == (k <= sweep.max_k(P)), (P, k)
    assert sweep.level_rows(False) == 27
    assert sweep.level_rows(True) == 27 + 9 * sweep.PREFETCH
    # K2: four blocks per SM up to K = 3, three up to 5, two up to 8; at K
    # = 16 one (the sweep's cap, K = 8, comes from the card: PERF.md)
    assert [sweep.blocks_per_sm(k, 1) for k in range(1, 10)] == [
        12, 7, 4, 3, 3, 2, 2, 2, 1]
    assert sweep.blocks_per_sm(8, 1, True) == 1
    assert sweep.smem_bytes(16, 1, True) == 230144 <= sweep.SMEM_PER_BLOCK
    # the largest F at the cap still fits one block
    assert sweep.smem_bytes(8, 8) == 230400 <= sweep.SMEM_PER_BLOCK
    # K4 at the models' F = 2 and 3, K = 4: 3 and 2 blocks per SM
    assert sweep.blocks_per_sm(4, 2) == 3 and sweep.blocks_per_sm(4, 3) == 2


@pytest.mark.parametrize("rows,cols,k,P,slots,want", [
    (4096, 4096, 5, 1, 396, (35, 118, 11, 373)),
    (4096, 4096, 8, 1, 264, (37, 111, 7, 586)),
    (2048, 2048, 4, 2, 396, (37, 56, 10, 205)),
    (1024, 1024, 4, 3, 264, (19, 54, 13, 79)),
    (7, 300, 8, 1, 264, (3, 100, 7, 1)),
    (45, 33, 3, 1, 264, (1, 33, 45, 1)),
    (100, 10, 1, 8, 5, (1, 10, 5, 20)),
    (3, 1000, 2, 1, 4, (9, 112, 1, 3)),
    # K2 and K9 on an H100's 132 SMs (three blocks per SM up to K = 5, two
    # from K = 6): the 401^2 inlet's sweep (with its tiles off) and its
    # 100 x 401 shard (the grid cut 4 x 1), K2 flow 4096^2, diffusion and
    # noisy Fisher 2048^2, K9's flow 2048 x 8192 and diffusion family
    # 1024^2 shards
    (401, 401, 4, 1, 396, (4, 101, 81, 5)),
    (100, 401, 3, 1, 396, (4, 101, 50, 2)),
    (4096, 4096, 4, 1, 396, (35, 118, 11, 373)),
    (2048, 2048, 8, 1, 264, (19, 108, 13, 158)),
    (2048, 2048, 4, 1, 396, (18, 114, 22, 94)),
    (2048, 8192, 4, 1, 396, (69, 119, 5, 410)),
    (1024, 1024, 8, 1, 264, (10, 103, 26, 40)),
    (1024, 1024, 4, 1, 396, (9, 114, 43, 24)),
])
def test_plan(rows, cols, k, P, slots, want):
    """Strips evened out to at most strip_width - 2K stored columns, one
    wave of segments; every row and column stored by exactly one item."""
    pl = sweep.plan(rows, cols, k, P, slots)
    assert tuple(pl) == want
    assert pl.wo <= sweep.strip_width(P) - 2 * k
    assert (pl.strips - 1) * pl.wo < cols <= pl.strips * pl.wo
    assert (pl.segments - 1) * pl.seg < rows <= pl.segments * pl.seg


# -- K9: the sweep on one shard of a grid, from its halo ---------------------

# grids with ragged cuts, every shard narrower than one strip of 128 columns
# (40x301 cut 2x2: two strips per shard); x wraps within the shard when it
# spans the grid's width (cuts 2x1)
HALO_GRIDS = ((37, 53), (30, 47))
HALO_CUTS = ((2, 1), (1, 3), (2, 2))
HALO_KS = (1, 4, 8)
HALO_SLOTS = 6  # a few segments per shard: each has 2K warm-up rows
HALO_FLOW_TOL = 5e-7  # the plain steps' flow on the region against the
# grid's: the same per-cell operations, held below the parity bar


def _halo_physics(case):
    """K9's physics and its arguments for a case of CASES."""
    if case.startswith("flow"):
        return "flow", dict(FLOW_KW, incompressible="incompressible" in case)
    if case.startswith("velocity_inlet"):
        outlet = case.split()[1]
        return "velocity_inlet", dict(
            VELOCITY_KW, outlet=outlet, incompressible="incompressible" in case)
    if case == "diffusion":
        return "diffusion", DIFFUSION_KW
    return "noisy_fisher", dict(DIFFUSION_KW, lb_Dg=NOISE_DG, seed=NOISE_SEED)


def _shards(f, mask, ny, nx, cut, k):
    """Each shard of the ``cut`` of ``f [9, ny, nx]``: its place, its
    ``k``-cell halo and its region's mask (or None)."""
    for y0, x0, H, W in shard_cuts(ny, nx, *cut):
        region = None if mask is None else cut_region(mask, y0, x0, H, W, k)
        yield (y0, x0, H, W), Halo.cut(f, y0, x0, H, W, k), region


def _emulate_shard(halo, k, fn, region, slots=HALO_SLOTS):
    ext = halo.extended()
    return emulate(ext.view(9, -1, *ext.shape[1:]), k, slots, fn, region,
                   shard=(halo.y0, halo.x0, halo.ny, halo.nx, halo.width))


HALO_GRID_CUTS = [(g, c) for g in HALO_GRIDS for c in HALO_CUTS]


@pytest.mark.parametrize("grid,cut", HALO_GRID_CUTS + [((40, 301), (2, 2))],
                         ids=lambda v: f"{v[0]}x{v[1]}")
def test_halo_sweep_schedule(grid, cut):
    """K9's sweep at every K: each kept cell of a shard pulls each
    direction from the right cell of level s - 1 (global coordinates,
    through the halo-extended region) and its mask, no strip reads past
    the region, and the shard's cells are written once each."""
    ny, nx = grid
    Y = torch.arange(ny)[:, None]
    X = torch.arange(nx)[None, :]
    J = torch.arange(9)[:, None, None]
    mask = torch.tensor((np.random.RandomState(1).rand(ny, nx) < 0.3
                         ).astype(np.int32))
    f0 = _code(0, J, 0, Y, X, 1, ny, nx).expand(9, ny, nx)
    fn = _provenance(1, ny, nx, mask)
    for k in range(1, sweep.max_k(1) + 1):
        want = _code(k, J, 0, Y, X, 1, ny, nx).expand(9, ny, nx)
        for (y0, x0, H, W), halo, region in _shards(f0, mask, ny, nx, cut, k):
            got = _emulate_shard(halo, k, fn, region)
            assert torch.equal(got[:, 0], want[:, y0:y0 + H, x0:x0 + W]), (
                grid, cut, k, y0, x0)


# K2's physics on K9's shards
K2_CASES = [c for c in CASES if not c.startswith(("fisher", "expansion"))]
HALO_RUNS = [(case, g, c) for case in K2_CASES for g, c in HALO_GRID_CUTS]


@pytest.mark.parametrize("case,grid,cut", HALO_RUNS, ids=[
    f"{case}-{g[0]}x{g[1]}-{c[0]}x{c[1]}" for case, g, c in HALO_RUNS])
def test_halo_sweep_equals_twin_and_plain_steps(case, grid, cut):
    """The emulated K9 sweep on each shard, at K = 1, 4 and 8, equals K9's
    plain twin (``temporal_halo_step_reference``) and K plain steps of the
    whole grid: flow and the velocity inlet within HALO_FLOW_TOL, diffusion
    and noisy Fisher bit for bit."""
    P, update, plain, obstacle = CASES[case]
    physics, kw = _halo_physics(case)
    ny, nx = grid
    f0, mask = _state(case, P, ny, nx)
    mask = mask if obstacle else None
    fn = update(ny, nx)
    want = {0: f0}
    for k in range(1, max(HALO_KS) + 1):
        want[k] = plain(want[k - 1], mask, STEP0 + k - 1)
    tol = HALO_FLOW_TOL if physics in ("flow", "velocity_inlet") else 0.0
    for k in HALO_KS:
        for (y0, x0, H, W), halo, region in _shards(f0[:, 0], mask, ny, nx,
                                                    cut, k):
            got = _emulate_shard(halo, k, fn, region)[:, 0]
            twin = temporal_halo_step_reference(halo, k, physics, mask=region,
                                                step0=STEP0, **kw)
            whole = want[k][:, 0, y0:y0 + H, x0:x0 + W]
            for ref in (twin, whole):
                d = float((got - ref).abs().max())
                assert d <= tol, (case, grid, cut, k, y0, x0, d)
