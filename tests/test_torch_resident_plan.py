"""K3's plan and schedule, emulated in plain torch on the CPU.

The one-launch run K3 (``csrc/resident_run.cu``) keeps each band of rows
in a ring in shared memory and exchanges halo planes with its two
neighbours through the receiver's inbox (inside a cluster) or a buffer
and flags in ``scratch`` (between clusters).
``lb2d_tpu_torch.ops.resident_plan`` mirrors its plan; here every band runs on its own as a generator from only
its rows and the planes it fetched, with the plan's ring slots (each new
row written into the slot of the old row above it, group by group), edge
planes, buffer offsets and exchange slots, under a scheduler that resumes
any band whose neighbours have published (at random, or greedily, which
lets one band run a whole exchange ahead). Halo planes that are not sent
are NaN, so a cell that pulled one would show. Each group's update is the
plain step of the physics on the group's rows and the row on each side
(``fused_halo._plain_step``, the BCs by global row, the noise by global
cell), as each cell of the kernel computes its update from the 9 values it
pulled.

The emulation equals the plain steps (``pipe_run_reference``,
``velocity_step_reference``, ``diffusion_run_reference``) bit for bit for
the diffusion family and within 5e-7 for flow and the velocity inlet (the
reference's kernel-vs-XLA bar), on grids of one band that wraps onto
itself (5x7), of one cluster (31x61, 32x256; also through scratch), of
bands through scratch (133x67: more rows than bands, not an even cut) and
clusters of 2, 3, 6 at 133x67 mixing both, each also cut into strips of
columns (the kernel's layout where rows are too wide: the transposed
grid, ring plane q holding direction ``transpose_dir(q)``), on the plan's
own strips of 5x2053 and 3x2100, and against JAX's resident Pallas kernel
in interpret mode (5e-7 for flow, 2e-6 for diffusion, the bars of
tests/test_torch_fused.py and tests/test_torch_diffusion.py). With one
exchange slot in place of two, the greedy schedule reads an edge that its
neighbour has overwritten.
"""

import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lb2d_tpu.models as jax_models
from lb2d_tpu.models.pipe_flow import PipeFlow as JaxPipeFlow
from lb2d_tpu.ops.fused import make_resident_pipe_step
from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.ops import resident_plan as rp
from lb2d_tpu_torch.ops.boundary import GridCoords
from lb2d_tpu_torch.ops.fused import (
    RESIDENT_MAX_CELLS,
    RESIDENT_MAX_CELLS_DIFFUSION,
    diffusion_run_reference,
    pipe_run_reference,
    supports_resident,
    velocity_step_reference,
)
from lb2d_tpu_torch.ops.fused_halo import _plain_step

torch.set_num_threads(1)

TOL = 5e-7
FLOW = dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0)
VELOCITY = dict(omega=1.3, u_w=0.05, u_e=0.04)
# the diffusion family as tests/test_torch_kernel_cuda.py runs it: step0
# just below 2^32, so that the run crosses into the counter's high word
DIFFUSION = dict(omega=1.6, u_lb=0.0029, v_lb=-0.0017, lb_G=0.0025)
NOISE = dict(lb_Dg=0.05, seed=2**40 + 7)
STEP0 = 2**32 - 3
# physics case -> (physics, step keywords, obstacle)
CASES = {
    "flow": ("flow", dict(FLOW, incompressible=False), False),
    "flow-incompressible": ("flow", dict(FLOW, incompressible=True), False),
    "flow-obstacle": ("flow", dict(FLOW, incompressible=False), True),
    "flow-incompressible-obstacle": ("flow", dict(FLOW, incompressible=True),
                                     True),
    "velocity-zero-gradient": ("velocity_inlet", dict(
        VELOCITY, outlet="zero_gradient", incompressible=False), False),
    "velocity-zero-gradient-obstacle": ("velocity_inlet", dict(
        VELOCITY, outlet="zero_gradient", incompressible=True), True),
    "velocity-outlet": ("velocity_inlet", dict(
        VELOCITY, outlet="velocity", incompressible=False), False),
    "velocity-outlet-obstacle": ("velocity_inlet", dict(
        VELOCITY, outlet="velocity", incompressible=True), True),
    "diffusion": ("diffusion", dict(DIFFUSION), False),
    "noisy_fisher": ("noisy_fisher", dict(DIFFUSION, **NOISE), False),
}
# one band wrapping onto itself; one cluster (31x61, 32x256); bands
# through scratch (133x67, an uneven cut with more rows than bands); the
# one-cluster grids through scratch too
SHAPES = [(5, 7), (31, 61), (32, 256), (133, 67)]
CUTS = [(shape, None) for shape in SHAPES] + [((31, 61), 1), ((32, 256), 1)]
CUT_IDS = [f"{ny}x{nx}" for ny, nx in SHAPES] + ["31x61-scratch",
                                                 "32x256-scratch"]


def _mask(ny, nx):
    m = np.zeros((ny, nx), np.int32)
    m[ny // 3:ny // 2 + 2, nx // 3:nx // 2] = 1
    m[0, nx // 2] = m[-1, -1] = 1  # on a wall and a corner too
    return torch.from_numpy(m)


def _state(physics, ny, nx, seed=0):
    rng = np.random.RandomState(seed)
    if physics in ("diffusion", "noisy_fisher"):
        rho = 0.1 + 0.8 * rng.rand(ny, nx)
        w = np.asarray(D2Q9.w)[:, None, None]
        f = w * rho * (1.0 + 0.01 * rng.randn(9, ny, nx))
    else:
        f = (1.0 + 0.01 * rng.randn(9, ny, nx)) / 9.0
    return torch.tensor(f, dtype=torch.float32)


def _reference(physics, kw, f, n, mask, step0):
    if physics == "flow":
        return pipe_run_reference(f, n, **kw, mask=mask)
    if physics == "velocity_inlet":
        for _ in range(n):
            f = velocity_step_reference(f, **kw, mask=mask)
        return f
    return diffusion_run_reference(f, n, **kw, noisy=physics == "noisy_fisher",
                                   step0=step0)


class _Exchange:
    """The buffers of one launch: each band's inbox, ``scratch`` (the
    flags as numbers beside it) and the cluster barrier's arrivals."""

    def __init__(self, plan, slots):
        P, L = rp.HALO_PLANES, plan.length
        self.inbox = [torch.full((slots * 2 * P * L,), math.nan)
                      for _ in range(plan.bands)]
        self.scratch = torch.full((rp.FLAG_WORDS * plan.bands
                                   + slots * plan.bands * 2 * P * L,),
                                  math.nan)
        self.flags = [0] * plan.bands
        self.arrived = [0] * plan.bands


# ring plane q holds direction TRANSPOSED[q] of a strip's transposed grid
TRANSPOSED = [rp.transpose_dir(q) for q in range(9)]


def _band(b, plan, f, out, ex, slots, physics, kw, mask, n, step0):
    """The kernel's block ``b`` as a generator: it yields a predicate that
    says when its wait is over."""
    ny, nx, bands, cs = plan.ny, plan.nx, plan.bands, plan.cluster
    rows, L, strip = plan.rows, plan.length, plan.strip
    P = rp.HALO_PLANES
    y0 = rp.band_first_row(b, rows, bands)
    R = rp.band_first_row(b + 1, rows, bands) - y0
    S = R + 2
    assert R >= 1 and S <= rp.rows_max(rows, bands) + 2
    assert rp.smem_bytes(rows, L, bands, cs) == plan.smem
    ring = torch.full((S, 9, L), math.nan)
    off = 1

    def slot(r):
        assert -1 <= r <= R
        return (r + off) % S

    for r in range(R):  # a strip's ring row is a column, transposed
        ring[slot(r)] = f[TRANSPOSED, :, y0 + r] if strip else f[:, y0 + r]
    up, down = (b - 1) % bands, (b + 1) % bands
    local = {0: rp.local_edge(b, up, bands, cs),
             1: rp.local_edge(b, down, bands, cs)}
    neighbour = {0: up, 1: down}  # the band above, the band below
    sender_row = {0: 0, 1: R - 1}  # edge 0 the first row, 1 the last
    members = range(b // cs * cs, b // cs * cs + cs)
    G = rp.group_rows(L)

    def box(s, edge, sender, receiver, local):
        """Edge ``edge`` of ``sender`` in slot ``s``: in the receiver's
        inbox where the two share a cluster, else in scratch."""
        if local:
            at = rp.inbox_offset(s, edge, L)
            return ex.inbox[receiver][at:at + P * L]
        at = rp.gbuf_offset(s, sender, edge, bands, L)
        assert at + P * L <= rp.exchange_floats(bands, L)
        return ex.scratch[at:at + P * L]

    def update(g0, group, step):
        """The plain step on ring rows g0 - 1 .. g0 + group, in the grid's
        own frame; the new rows g0 .. g0 + group - 1 in the ring's."""
        ring_rows = range(g0 - 1, g0 + group + 1)
        block = torch.stack([ring[slot(r)] for r in ring_rows], 1)
        at = torch.tensor([(y0 + r) % rows for r in ring_rows])
        if not strip:
            coords = GridCoords(at[:, None], torch.arange(nx)[None, :],
                                ny, nx)
            new = _plain_step(physics, kw, None if mask is None
                              else mask[at])(block, coords, step)
            return new[:, 1:-1]
        coords = GridCoords(torch.arange(ny)[:, None], at[None, :], ny, nx)
        new = _plain_step(physics, kw, None if mask is None
                          else mask[:, at])(
            block[TRANSPOSED].transpose(1, 2).contiguous(), coords, step)
        return new[TRANSPOSED].transpose(1, 2)[:, 1:-1]

    for edge in (0, 1):  # exchange 0's edges, from the band as loaded:
        dst = box(0, edge, b, neighbour[edge], local[edge])  # 0 up, 1 down
        for p in range(P):
            dst[p * L:(p + 1) * L] = ring[slot(sender_row[edge]),
                                          rp.edge_plane(edge, p)]
    for e in range(n):
        s = e % slots
        ex.flags[b] = ex.arrived[b] = e + 1
        yield lambda e=e: (
            all(ex.arrived[c] > e for c in members)
            and all(local[i] or ex.flags[neighbour[i]] > e for i in (0, 1)))
        # row -1 from the band above's edge 1, row R from below's edge 0
        for edge, band, r in ((1, up, -1), (0, down, R)):
            src = box(s, edge, band, b, local[1 - edge])
            ring[slot(r)] = math.nan  # a plane not sent stays NaN
            for p in range(P):
                ring[slot(r), rp.edge_plane(edge, p)] = src[p * L:(p + 1) * L]
        publish = e + 1 < n  # the step sends exchange e + 1's edges
        for g0 in range(0, R, G):
            group = min(G, R - g0)
            new = update(g0, group, step0 + e)
            for q in range(group):  # new row r into old row r - 1's slot
                r = g0 + q
                ring[slot(r - 1)] = new[:, q]
                for edge in (0, 1):
                    if not (publish and r == sender_row[edge]):
                        continue
                    dst = box((e + 1) % slots, edge, b, neighbour[edge],
                              local[edge])
                    for j in range(9):
                        p = rp.plane_of(edge, j)
                        if p >= 0:
                            dst[p * L:(p + 1) * L] = new[j, q]
        off = (off - 1) % S
    for r in range(R):
        if strip:
            out[TRANSPOSED, :, y0 + r] = ring[slot(r)]
        else:
            out[:, y0 + r] = ring[slot(r)]


def emulate(plan, f, n, physics, kw, mask=None, step0=0, slots=rp.SLOTS,
            order="random", seed=0):
    """``n`` steps of K3's schedule on ``f`` (a new tensor)."""
    out = torch.full_like(f, math.nan)
    ex = _Exchange(plan, slots)
    bands = {b: _band(b, plan, f, out, ex, slots, physics, kw, mask, n,
                      step0) for b in range(plan.bands)}
    waits = {b: next(g) for b, g in bands.items()}
    rng = random.Random(seed)
    while bands:
        ready = [b for b in sorted(bands) if waits[b]()]
        assert ready, "deadlock"
        b = rng.choice(ready) if order == "random" else ready[0]
        try:
            waits[b] = next(bands[b])
        except StopIteration:
            del bands[b], waits[b]
    return out


def _check(physics, got, want):
    if physics in ("diffusion", "noisy_fisher"):
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        d = float((got - want).abs().max())
        assert d <= TOL, d


def _with_cluster(p, cluster):
    """Plan ``p`` in clusters of ``cluster`` (a divisor of its bands), as
    the kernel takes any cluster size; the plan itself makes one cluster of
    the whole grid, or none."""
    assert p.bands % cluster == 0
    return p._replace(cluster=cluster,
                      smem=rp.smem_bytes(p.rows, p.length, p.bands, cluster),
                      exchange=(rp.exchange_floats(p.bands, p.length)
                                if p.bands > cluster else 0))


def _plan(shape, layout="rows", cluster=None):
    """The plan's cut of ``shape`` in bands of rows, or in strips of
    columns (the kernel's layout for rows too wide, run here on small
    grids as well); in clusters of ``cluster`` where given."""
    p = rp.cut(*shape, layout == "columns")
    return p if cluster is None else _with_cluster(p, cluster)


def _case(name, plan, n, order="random", seed=0):
    physics, kw, obstacle = CASES[name]
    ny, nx = plan.ny, plan.nx
    f = _state(physics, ny, nx)
    mask = _mask(ny, nx) if obstacle else None
    step0 = STEP0 if physics == "noisy_fisher" else 0
    got = emulate(plan, f, n, physics, kw, mask, step0, order=order,
                  seed=seed)
    return physics, got, _reference(physics, kw, f, n, mask, step0)


@pytest.mark.parametrize("layout", ["rows", "columns"])
@pytest.mark.parametrize("shape,cluster", CUTS, ids=CUT_IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_plain_steps(name, shape, cluster, layout):
    """Nine steps: both exchange slots, and an odd count; in bands of rows
    and in strips of columns."""
    _check(*_case(name, _plan(shape, layout, cluster), 9,
                  seed=hash((name, shape, layout)) % 1000))


@pytest.mark.parametrize("layout", ["rows", "columns"])
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("shape", [(31, 61), (133, 67)],
                         ids=["31x61", "133x67"])
@pytest.mark.parametrize("name", ["flow-incompressible-obstacle",
                                  "velocity-zero-gradient-obstacle",
                                  "noisy_fisher"])
def test_emulation_step_counts(name, shape, n, layout):
    _check(*_case(name, _plan(shape, layout), n, seed=n))


# rows too wide for a block: the plan's own strips (21 through scratch, an
# uneven cut; 13 in one cluster)
WIDE = [(5, 2053), (3, 2100)]


@pytest.mark.parametrize("shape", WIDE, ids=[f"{ny}x{nx}" for ny, nx in WIDE])
@pytest.mark.parametrize("name", ["flow-obstacle", "velocity-zero-gradient",
                                  "velocity-outlet-obstacle", "noisy_fisher"])
def test_emulation_of_wide_rows(name, shape):
    plan = rp.plan(*shape)
    assert plan.strip and plan == rp.cut(*shape, True)
    assert rp.cut(*shape, False) is None  # rows wider than 2048 cells
    _check(*_case(name, plan, 5, seed=len(name)))


@pytest.mark.parametrize("cluster", [2, 3, 6])
@pytest.mark.parametrize("name", ["flow-obstacle", "noisy_fisher"])
def test_emulation_clusters_and_scratch(name, cluster):
    """133x67 in 18 bands, clusters of 2, 3 or 6: edges inside a cluster
    through inboxes, between clusters through scratch."""
    assert rp.plan(133, 67).bands == 18
    _check(*_case(name, _plan((133, 67), cluster=cluster), 9,
                  order="greedy"))


@pytest.mark.parametrize("cluster", [1, 2])
def test_one_slot_would_race(cluster):
    """The greedy schedule runs band 0 a whole exchange ahead of band 1:
    with one slot it overwrites the edge band 1 has not read yet."""
    physics, kw, _ = CASES["diffusion"]
    plan = _plan((31, 61), cluster=cluster)
    assert plan.bands == 4
    f = _state(physics, 31, 61)
    want = _reference(physics, kw, f, 4, None, 0)
    two = emulate(plan, f, 4, physics, kw, order="greedy")
    one = emulate(plan, f, 4, physics, kw, slots=1, order="greedy")
    assert torch.equal(two, want)
    assert not torch.equal(one, want)


def test_edges_carry_what_the_pulls_need():
    """Edge 1 fills row -1 and edge 0 row R with exactly the directions
    that the band's rows pull across the edge (2, 5, 6 from above, 4, 7, 8
    from below), each once."""
    cy = np.asarray(D2Q9.cy)
    for edge, dirs in ((1, rp.UP_DIRS), (0, rp.DOWN_DIRS)):
        got = [rp.edge_plane(edge, p) for p in range(rp.HALO_PLANES)]
        assert tuple(got) == dirs
        assert [rp.plane_of(edge, j) for j in got] == list(range(len(got)))
        assert sum(rp.plane_of(edge, j) >= 0 for j in range(9)) == len(got)
    assert tuple(j for j in range(9) if cy[j] == 1) == rp.UP_DIRS
    assert tuple(j for j in range(9) if cy[j] == -1) == rp.DOWN_DIRS


def test_transpose_dir_swaps_the_axes():
    """A strip's ring plane q holds the direction with q's (cx, cy)
    swapped, so the bands' pulls and edges serve the transposed grid."""
    cx, cy = np.asarray(D2Q9.cx), np.asarray(D2Q9.cy)
    for q in range(9):
        j = rp.transpose_dir(q)
        assert (cx[j], cy[j]) == (cy[q], cx[q])
        assert rp.transpose_dir(j) == q


@pytest.mark.parametrize("shape,strip,bands,cluster", [
    ((32, 256), False, 16, 16), ((5, 7), False, 1, 1),
    ((31, 61), False, 4, 4), ((133, 67), False, 18, 1),
    ((256, 256), False, 128, 1), ((512, 512), False, 132, 1),
    ((401, 401), False, 132, 1), ((724, 724), False, 132, 1),
    ((16, 4096), True, 128, 1), ((5, 2053), True, 21, 1),
    ((3, 2100), True, 13, 13)],
    ids=["32x256", "5x7", "31x61", "133x67", "256x256", "512x512", "401x401",
         "724x724", "16x4096", "5x2053", "3x2100"])
def test_plan_at_the_main_paths(shape, strip, bands, cluster):
    ny, nx = shape
    p = rp.plan(ny, nx)
    assert (p.strip, p.bands, p.cluster) == (strip, bands, cluster)
    assert (p.rows, p.length) == ((nx, ny) if strip else (ny, nx))
    assert p.smem <= rp.SMEM_PER_BLOCK
    assert p.exchange == (0 if cluster == bands
                          else rp.exchange_floats(bands, p.length))
    if bands <= rp.MAX_CLUSTER:  # the whole grid in one cluster
        assert p.cluster == bands and p.exchange == 0
    rows = [rp.band_first_row(b + 1, p.rows, bands)
            - rp.band_first_row(b, p.rows, bands) for b in range(bands)]
    assert sum(rows) == p.rows and max(rows) - min(rows) <= 1
    assert max(rows) == rp.rows_max(p.rows, bands)
    assert rp.group_rows(p.length) * p.length <= (rp.CELLS_PER_THREAD
                                                  * rp.THREADS)


def test_supports_resident_only_where_the_plan_holds():
    assert supports_resident(724, 724)
    # diffusion: K2 at 8 steps a launch wins at 724^2 (PERF.md)
    assert supports_resident(512, 512, "diffusion")
    assert not supports_resident(724, 724, "diffusion")
    assert supports_resident(724, 724, "noisy_fisher")
    assert rp.plan(800, 800) is None and not supports_resident(800, 800)
    # 1024^2's state (37.7 MB) is more than the H100's 132 x 227 KB of
    # shared memory: no cut holds it
    assert rp.plan(1024, 1024) is None
    assert 36 * 1024 * 1024 > rp.H100_SMS * rp.SMEM_PER_BLOCK
    assert rp.plan(16, 4096).strip  # rows too wide: strips of columns
    for n in range(64, 1025, 16):
        if supports_resident(n, n):
            assert n * n <= RESIDENT_MAX_CELLS and rp.plan(n, n) is not None
        if supports_resident(n, n, "diffusion"):
            assert n * n <= RESIDENT_MAX_CELLS_DIFFUSION


def _jax_flow(ny, nx, equilibrium, obstacle):
    N = ny - 1
    mask = _mask(ny, nx).numpy() if obstacle else None
    return JaxPipeFlow(N=N, pipe_length=(nx - 1.5) / N, backend="xla",
                       equilibrium=equilibrium, obstacle_mask=mask,
                       diameter=1.0, rho=10.0, viscosity=5.0,
                       pressure_grad=-100.0), mask


@pytest.mark.parametrize("equilibrium,obstacle", [
    ("compressible", False), ("incompressible", True)],
    ids=["compressible", "incompressible-obstacle"])
def test_emulation_matches_jax_resident_kernel(equilibrium, obstacle):
    """32x128 (8 bands in one cluster), 7 steps, against JAX's resident
    Pallas kernel in interpret mode."""
    ny, nx, n = 32, 128, 7
    sim, mask = _jax_flow(ny, nx, equilibrium, obstacle)
    run = make_resident_pipe_step(
        ny=ny, nx=nx, omega=sim.omega, inlet_rho=sim.inlet_rho,
        outlet_rho=sim.outlet_rho, equilibrium=equilibrium,
        has_obstacle=obstacle, interpret=True)
    want = np.asarray(run(sim.state, n, jnp.asarray(mask)) if obstacle
                      else run(sim.state, n))
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho,
              incompressible=equilibrium == "incompressible")
    plan = rp.plan(ny, nx)
    assert (plan.bands, plan.cluster) == (8, 8)
    got = emulate(plan, torch.from_numpy(np.array(sim.state)), n, "flow", kw,
                  None if mask is None else torch.from_numpy(mask))
    d = float(np.abs(want - got.numpy()).max())
    assert d < TOL, d


def test_emulation_matches_jax_resident_diffusion_kernel():
    """128x128 ReactionAdvectionDiffusion (32 bands through scratch), 7
    steps, against JAX's physics="diffusion" resident kernel."""
    grid = dict(N=42, z=0.1, Lx=0.31, Ly=0.31, D=0.01, vx=1.0, vy=0.5,
                vc=1.0, g=5.0)
    jax_sim = jax_models.ReactionAdvectionDiffusion(**grid)
    state = jax_sim.state
    f0 = np.array(state[0] if isinstance(state, tuple) else state)
    jax_sim._install_resident_run(interpret=True)
    want = np.asarray(jax_sim._run_compiled(jnp.asarray(f0), jnp.int32(7)))
    import lb2d_tpu_torch.models as torch_models
    sim = torch_models.ReactionAdvectionDiffusion(device="cpu", **grid)
    kw = dict(omega=sim.omega, u_lb=sim.u_lb, v_lb=sim.v_lb, lb_G=sim.G)
    plan = rp.plan(*f0.shape[1:])
    assert plan.bands == 32 and plan.cluster == 1
    got = emulate(plan, torch.from_numpy(f0), 7, "diffusion", kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
