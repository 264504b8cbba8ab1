"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device. Imports no JAX, so it
runs on a machine that has none; ``tests/conftest.py`` imports JAX, so run
it there with ``python -m pytest --noconftest tests/test_torch_kernel_cuda.py``.
Tolerance 1e-6 after up to 9 steps (~30 ulp at |f| <= 0.45): nvcc
contracts multiply-adds into FMAs where PyTorch runs separate elementwise
kernels. The diffusion family's kernels round every operation on their own
and, on an H100 with torch 2.11, match the plain step bit for bit, noise
included; they are held to the same 1e-6 (densities away from 1, where
the noise's sqrt(rho (1 - rho)) would magnify an ulp of rho). The
multifield kernels K4 and K5 round every operation on their own too:
K4 ``fisher`` is held to 1e-6, K4 ``expansion`` and K5, whose clips turn an
ulp next to the cutoff into a jump, to 0 with the noise on. K6, the
multicomponent step, is held to 1e-6 after 5 steps (FMA contraction, as
the flow kernels), in each configuration of ``lb2d_tpu_torch.mc_cases``
(those of chip_smoke.py's checks) and for 1-4 fluids on both lattices.
K8, the screened-gradient solve, is held to its plain ``torch.fft``
version at 1e-5 of max |g| (two FFTs in float32, the kernel's sums in
another order), at any grid; its 1-D pass to ``torch.fft.fft`` at 1e-6 of
the scale. K7, the coupled families' K-step sweep, is held to its plain
steps at 1e-6 at every K from 1 to its limit (FMA contraction) and to K
one-step launches, and BASELINE config 5 through K6 + K8 to the eager
runner. K3, the one-launch run, holds its diffusion family to the plain steps bit
for bit on every cut. K9, the step of one shard from its halos, is held
to its plain twin at 1e-6 for the flow physics and at 0 for the diffusion
and multifield physics, on shards of an unaligned grid, and the sharded
models to the unsharded K2 / K4 runs (1e-6 for flow, 0 for the rest).
K6h and K7h, K6 and K7 on a shard and its halo, are held to the unsharded
K6 / K7 and to their plain twins at 1e-6 (K6h after 5 steps, K7h at K =
1, 2, 3 and its limit; the same per-cell code, so the unsharded kernels
are expected to agree exactly), and the
sharded runner (config 5, stale or not) and ``ShardedCoupled`` to the
unsharded kernel runs. P2, the transpose, is exact. The flow moments'
kernel is held to the plain moments at 1e-6 of max |field| (the same
float32 terms added in another order; see ``MOMENTS_TOL``).
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.core import D2Q9, D2Q25
from lb2d_tpu_torch.halo_cases import (
    HALO_CASES,
    HALO_MESHES,
    SMALL_HALO_CUTS,
    compare_coupled_halo,
    compare_halo_case,
    compare_mc_halo,
    halo_case_ks,
    halo_case_state,
    halo_tolerance,
    shard_cuts,
)
from lb2d_tpu_torch.mc_cases import MC_CASES, mc_case
from lb2d_tpu_torch.models import (
    ClumpySurfactantNutrientWave,
    Expansion,
    FisherExpansion,
    Fluid,
    NoisyAdvectedFisherWave,
    PipeFlow,
    PipeFlowVelocityInlet,
    ReactionAdvectionDiffusion,
    RocketYeast,
    RocketYeastForcesOnly,
    ScreenedFisherWave,
    SimulationRunner,
    SurfactantNutrientWave,
)
from lb2d_tpu_torch.ops.fused import (
    MAX_MULTIFIELD_FIELDS,
    MAX_TEMPORAL_K,
    band_max_k,
    diffusion_run_reference,
    expansion_band_reference,
    expansion_band_step,
    multifield_max_k,
    multifield_run_reference,
    pipe_run_reference,
    pipe_step,
    pipe_step_reference,
    resident_diffusion_run,
    resident_pipe_run,
    resident_scratch,
    resident_velocity_run,
    temporal_diffusion_step,
    temporal_multifield_step,
    temporal_pipe_step,
    temporal_velocity_step,
    velocity_step_reference,
)
from lb2d_tpu_torch.ops.fused_coupled import (
    COUPLED_PHYSICS,
    CoupledConfig,
    coupled_density,
    coupled_max_k,
    coupled_sweep,
    coupled_sweep_reference,
    _coupled_cell_step,
)
from lb2d_tpu_torch.ops import _build, band_plan, fused, random, resident_plan
from lb2d_tpu_torch.ops.fused_halo import (
    HALO_SWEEP_PHYSICS,
    temporal_halo_step,
)
from lb2d_tpu_torch.ops.fused_coupled import coupled_sweep_halo
from lb2d_tpu_torch.ops.fused_mc import (
    mc_density,
    mc_density_halo,
    mc_step,
    mc_step_halo,
    mc_step_reference,
)
from lb2d_tpu_torch.ops.spectral import (
    dft_axis0,
    dft_axis0_reference,
    screened_gradients,
    screened_gradients_reference,
    solve_launches,
    solve_plan,
)
from lb2d_tpu_torch.ops.random import (
    normals,
    normals_per_cell,
    normals_reference,
    philox4x32_10,
    philox_bits,
)
from lb2d_tpu_torch.ops.transpose import transpose, transpose_reference
from lb2d_tpu_torch.ops import moments
from lb2d_tpu_torch.ops.equilibrium import feq_quadratic
from lb2d_tpu_torch.parallel import (
    ShardedCoupled,
    ShardedDiffusion,
    ShardedMultifield,
    ShardedPipeFlow,
    make_mesh,
)

pytestmark = pytest.mark.cuda

TOL = 1e-6
VARIANTS = [("compressible", False), ("incompressible", False),
            ("compressible", True), ("incompressible", True)]
IDS = ["compressible", "incompressible", "compressible-obstacle",
       "incompressible-obstacle"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, shape, equilibrium, obstacle):
    ny, nx = shape
    rng = np.random.RandomState(0)
    f = torch.tensor((1.0 + 0.01 * rng.randn(9, ny, nx)) / 9.0,
                     dtype=torch.float32, device=device)
    mask = None
    if obstacle:
        m = np.zeros((ny, nx), np.int32)
        m[ny // 3:ny // 2 + 2, nx // 3:nx // 2] = 1
        m[0, nx // 2] = m[-1, -1] = 1  # on a wall and a corner too
        mask = torch.tensor(m, device=device)
    kw = dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0,
              incompressible=equilibrium == "incompressible", mask=mask)
    return f, kw


@pytest.mark.parametrize("shape", [(254, 382), (31, 61)], ids=["254x382", "31x61"])
@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_kernel_matches_reference(cuda, equilibrium, obstacle, shape):
    f, kw = _inputs(cuda, shape, equilibrium, obstacle)
    a, spare, b = f.clone(), torch.empty_like(f), f
    before = pipe_step.launches
    for _ in range(4):
        a, spare = pipe_step(a, spare, **kw), a
        b = pipe_step_reference(b, **kw)
    torch.cuda.synchronize()
    assert pipe_step.launches == before + 4
    d = float((a - b).abs().max())
    assert d <= TOL, d


# K2's row sweep: 45x33, 31x61 and 5x7 are narrower than one strip, which
# then wraps onto itself; 7x300 and 5x7 have fewer rows than the card's
# segments; 3751x1251 is the cylinder's grid (ragged strips and segments)
K2_SHAPES = [(254, 382), (254, 254), (401, 401), (1251, 3751), (45, 33),
             (7, 300), (31, 61), (5, 7)]
K2_IDS = [f"{ny}x{nx}" for ny, nx in K2_SHAPES]
K2_KS = range(1, MAX_TEMPORAL_K + 1)


@pytest.mark.parametrize("shape", K2_SHAPES, ids=K2_IDS)
@pytest.mark.parametrize("k", K2_KS)
@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_temporal_kernel_matches_reference(cuda, equilibrium, obstacle, k,
                                           shape):
    f, kw = _inputs(cuda, shape, equilibrium, obstacle)
    before = temporal_pipe_step.launches
    out = temporal_pipe_step(f, torch.empty_like(f), k, **kw)
    want = pipe_run_reference(f, k, **kw)
    torch.cuda.synchronize()
    assert temporal_pipe_step.launches == before + 1
    d = float((out - want).abs().max())
    assert d <= TOL, d


@pytest.mark.parametrize("shape", K2_SHAPES, ids=K2_IDS)
@pytest.mark.parametrize("k", K2_KS)
@pytest.mark.parametrize("outlet", ["zero_gradient", "velocity"])
@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_temporal_velocity_kernel_matches_reference(cuda, equilibrium,
                                                    obstacle, outlet, k,
                                                    shape):
    f, kw = _inputs(cuda, shape, equilibrium, obstacle)
    kw = dict(kw, outlet=outlet, u_w=0.05, u_e=0.04)
    del kw["inlet_rho"], kw["outlet_rho"]
    before = temporal_velocity_step.launches
    out = temporal_velocity_step(f, torch.empty_like(f), k, **kw)
    want = f
    for _ in range(k):
        want = velocity_step_reference(want, **kw)
    torch.cuda.synchronize()
    assert temporal_velocity_step.launches == before + 1
    d = float((out - want).abs().max())
    assert d <= TOL, d


# K3's cuts (ops/resident_plan.py): 32x256 one cluster of 16 bands, 31x61
# one of 4, 5x7 one band that is its own neighbour, 133x67 18 uneven bands
# through scratch, 724^2 the largest grid auto sends to K3 (132 bands)
K3_SHAPES = [(32, 256), (31, 61), (5, 7), (133, 67)]
K3_IDS = [f"{ny}x{nx}" for ny, nx in K3_SHAPES]
K3_NS = [1, 2, 8, 9]


@pytest.mark.parametrize("shape", K3_SHAPES + [(724, 724)],
                         ids=K3_IDS + ["724x724"])
@pytest.mark.parametrize("n", K3_NS)
@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_resident_kernel_matches_reference(cuda, equilibrium, obstacle, n,
                                           shape):
    f, kw = _inputs(cuda, shape, equilibrium, obstacle)
    g = f.clone()
    before = resident_pipe_run.launches
    assert resident_pipe_run(g, torch.empty_like(g), n, **kw) is g
    want = pipe_run_reference(f, n, **kw)
    torch.cuda.synchronize()
    assert resident_pipe_run.launches == before + 1
    d = float((g - want).abs().max())
    assert d <= TOL, d


def test_model_kernel_backend_matches_eager(cuda):
    kw = dict(N=30, diameter=1.5, rho=10.0, viscosity=5.0,
              pressure_grad=-100.0, pipe_length=3.0, device=cuda)
    eager = PipeFlow(backend="eager", **kw)
    eager.run(50)
    assert PipeFlow(**kw).backend == "resident"
    for backend in ("resident", "temporal", "kernel"):
        sim = PipeFlow(backend=backend, **kw)
        sim.run(50)
        d = float((sim.state - eager.state).abs().max())
        assert d <= 1e-5, (backend, d)


def test_velocity_model_kernel_backend_matches_eager(cuda):
    kw = dict(u_w=0.05, omega=1.2, lx=127, ly=95, device=cuda)
    eager = PipeFlowVelocityInlet(backend="eager", **kw)
    sim = PipeFlowVelocityInlet(**kw)
    assert sim.backend == "temporal"
    before = temporal_velocity_step.launches
    f0 = eager.state_numpy() * np.float32(1.001)  # start off equilibrium
    for model in (eager, sim):
        model.load_numpy_state(f0)
        model.run(50)
    assert temporal_velocity_step.launches > before
    d = float((sim.state - eager.state).abs().max())
    assert d <= 1e-5, d


# the diffusion family: omega, imposed velocity and growth of
# ReactionAdvectionDiffusionStochastic at 2048^2 (chip_smoke.py), noise
# amplitude Dg = 0.05; step0 just below 2^32, so that the K steps cross
# into the counter's high word
DIFFUSION = dict(omega=1.6, u_lb=0.0029, v_lb=-0.0017, lb_G=0.0025)
NOISE = dict(noisy=True, lb_Dg=0.05, seed=2**40 + 7, step0=2**32 - 3)
PHYSICS = {"diffusion": {}, "noisy_fisher": NOISE}


def _diffusion_inputs(device, shape):
    ny, nx = shape
    rng = np.random.RandomState(1)
    rho = 0.1 + 0.8 * rng.rand(ny, nx)
    w = np.asarray(D2Q9.w)[:, None, None]
    f = w * rho * (1.0 + 0.01 * rng.randn(9, ny, nx))
    return torch.tensor(f, dtype=torch.float32, device=device)


@pytest.mark.parametrize("shape", [(254, 382), (128, 128), (45, 33),
                                   (7, 300)],
                         ids=["254x382", "128x128", "45x33", "7x300"])
@pytest.mark.parametrize("k", K2_KS)
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_temporal_diffusion_kernel_matches_reference(cuda, physics, k,
                                                     shape):
    """Bit for bit: the diffusion update rounds each operation alone."""
    f = _diffusion_inputs(cuda, shape)
    kw = dict(DIFFUSION, **PHYSICS[physics])
    before = temporal_diffusion_step.launches
    out = temporal_diffusion_step(f, torch.empty_like(f), k, **kw)
    want = diffusion_run_reference(f, k, **kw)
    torch.cuda.synchronize()
    assert temporal_diffusion_step.launches == before + 1
    assert torch.equal(out, want), float((out - want).abs().max())


@pytest.mark.parametrize("shape", [(401, 401), (45, 33), (7, 300),
                                   (130, 700)],
                         ids=["401x401", "45x33", "7x300", "130x700"])
@pytest.mark.parametrize("outlet", ["zero_gradient", "velocity"])
def test_temporal_velocity_sweep_small_grids(cuda, outlet, shape,
                                             monkeypatch):
    """K2's velocity inlet on its row sweep where the wrapper would run the
    tiles (VELOCITY_TILE_MAX_CELLS set to 0): incompressible, with the
    obstacle, at every K against the plain steps; one strip (45x33) and
    several, whose first halo wraps at x = 0 into the outlet's columns."""
    monkeypatch.setattr(fused, "VELOCITY_TILE_MAX_CELLS", 0)
    f, kw = _inputs(cuda, shape, "compressible", True)
    kw = dict(omega=kw["omega"], mask=kw["mask"], u_w=0.05, u_e=0.04,
              outlet=outlet, incompressible=True)
    for k in K2_KS:
        want = f
        for _ in range(k):
            want = velocity_step_reference(want, **kw)
        out = temporal_velocity_step(f, torch.empty_like(f), k, **kw)
        d = float((out - want).abs().max())
        assert d <= TOL, (k, d)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", K3_SHAPES + [(256, 256), (724, 724)],
                         ids=K3_IDS + ["256x256", "724x724"])
@pytest.mark.parametrize("n", K3_NS)
@pytest.mark.parametrize("physics", list(PHYSICS))
def test_resident_diffusion_kernel_matches_reference(cuda, physics, n, shape):
    """Bit for bit: the diffusion update rounds each operation alone."""
    f = _diffusion_inputs(cuda, shape)
    kw = dict(DIFFUSION, **PHYSICS[physics])
    g = f.clone()
    before = resident_diffusion_run.launches
    assert resident_diffusion_run(g, torch.empty_like(g), n, **kw) is g
    want = diffusion_run_reference(f, n, **kw)
    torch.cuda.synchronize()
    assert resident_diffusion_run.launches == before + 1
    assert torch.equal(g, want), float((g - want).abs().max())


@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
@pytest.mark.parametrize("n", K3_NS)
@pytest.mark.parametrize("outlet", ["zero_gradient", "velocity"])
@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_resident_velocity_kernel_matches_reference(cuda, equilibrium,
                                                    obstacle, outlet, n,
                                                    shape):
    f, kw = _inputs(cuda, shape, equilibrium, obstacle)
    kw = dict(kw, outlet=outlet, u_w=0.05, u_e=0.04)
    del kw["inlet_rho"], kw["outlet_rho"]
    g = f.clone()
    before = resident_velocity_run.launches
    assert resident_velocity_run(g, torch.empty_like(g), n, **kw) is g
    want = f
    for _ in range(n):
        want = velocity_step_reference(want, **kw)
    torch.cuda.synchronize()
    assert resident_velocity_run.launches == before + 1
    d = float((g - want).abs().max())
    assert d <= TOL, d


@pytest.mark.parametrize("layout,cluster", [
    ("rows", 1), ("rows", 9), ("columns", None), ("columns", 1)],
    ids=["rows-scratch", "rows-clusters", "columns", "columns-scratch"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=K3_IDS)
@pytest.mark.parametrize("physics", ["flow", "velocity_inlet", "diffusion",
                                     "noisy_fisher"])
def test_resident_kernel_other_plans(cuda, monkeypatch, physics, shape,
                                     layout, cluster):
    """K3's other plans, 9 steps: no clusters (every edge through
    scratch), clusters of the largest divisor of the bands up to 9 (31x61
    and 32x256 in clusters of 4 and 8, 133x67's 18 bands in two of 9
    with scratch between them), and strips of columns (the layout of rows
    too wide, here on small grids: one strip of 5x7, 133x67's 67 columns
    in 18 strips through scratch) as the plan cuts them or with no
    clusters."""
    def other(ny, nx, sms=resident_plan.H100_SMS):
        p = resident_plan.cut(ny, nx, layout == "columns", sms)
        c = (p.cluster if cluster is None else
             max(c for c in range(1, min(cluster, p.bands) + 1)
                 if p.bands % c == 0))
        return p._replace(
            cluster=c, smem=resident_plan.smem_bytes(p.rows, p.length,
                                                     p.bands, c),
            exchange=(resident_plan.exchange_floats(p.bands, p.length)
                      if p.bands > c else 0))

    monkeypatch.setattr(resident_plan, "plan", other)
    _check_resident(cuda, physics, shape, 9)


def _check_resident(device, physics, shape, n):
    """K3 against its plain steps on ``shape``, ``n`` steps: the diffusion
    family bit for bit, noise on; flow and the zero-gradient inlet with
    the incompressible equilibrium and an obstacle."""
    if physics in PHYSICS:
        f = _diffusion_inputs(device, shape)
        kw = dict(DIFFUSION, **PHYSICS[physics])
        g = f.clone()
        resident_diffusion_run(g, resident_scratch(g), n, **kw)
        want = diffusion_run_reference(f, n, **kw)
        torch.cuda.synchronize()
        assert torch.equal(g, want), float((g - want).abs().max())
        return
    f, kw = _inputs(device, shape, "incompressible", True)
    g = f.clone()
    if physics == "flow":
        resident_pipe_run(g, resident_scratch(g), n, **kw)
        want = pipe_run_reference(f, n, **kw)
    else:
        kw = dict(kw, outlet="zero_gradient", u_w=0.05, u_e=0.04)
        del kw["inlet_rho"], kw["outlet_rho"]
        resident_velocity_run(g, resident_scratch(g), n, **kw)
        want = f
        for _ in range(n):
            want = velocity_step_reference(want, **kw)
    torch.cuda.synchronize()
    d = float((g - want).abs().max())
    assert d <= TOL, d


# rows wider than a block's 2048 cells: the plan's strips of columns (128
# strips through scratch at 16x4096, 21 uneven ones at 5x2053)
K3_WIDE = [(16, 4096), (5, 2053)]


@pytest.mark.parametrize("n", [1, 8, 9])
@pytest.mark.parametrize("shape", K3_WIDE,
                         ids=[f"{ny}x{nx}" for ny, nx in K3_WIDE])
@pytest.mark.parametrize("physics", ["flow", "velocity_inlet", "diffusion",
                                     "noisy_fisher"])
def test_resident_kernel_wide_rows(cuda, physics, shape, n):
    assert resident_plan.plan(*shape).strip
    _check_resident(cuda, physics, shape, n)


def test_resident_scratch_is_the_plans_exchange(cuda):
    """The wrappers take the exchange buffer at the plan's size, and raise
    on a smaller one or a grid that no cut holds (1024^2's state is more
    than the card's shared memory)."""
    f = _diffusion_inputs(cuda, (133, 67))
    p = resident_plan.plan(133, 67)
    assert resident_scratch(f).numel() == p.exchange > 0
    assert resident_scratch(_diffusion_inputs(cuda, (32, 256))).numel() == 0
    with pytest.raises(ValueError, match="exchange"):
        resident_diffusion_run(f, torch.empty(p.exchange - 1, device=cuda), 2,
                               **DIFFUSION)
    big = torch.zeros((9, 1024, 1024), device=cuda)
    with pytest.raises(ValueError, match="cannot hold"):
        resident_diffusion_run(big, torch.empty_like(big), 2, **DIFFUSION)


NORMALS_SHAPES = [(254, 382), (1, 1), (3, 5), (2049, 7)]


@pytest.mark.parametrize("shape", NORMALS_SHAPES,
                         ids=[f"{ny}x{nx}" for ny, nx in NORMALS_SHAPES])
@pytest.mark.parametrize("step", [0, 5, 2**32 + 1])
def test_normals_kernel_matches_reference(cuda, step, shape):
    """The Philox words bit for bit; the normals bit for bit against P1's
    first one-cell-a-thread loop (``normals_per_cell``), also into an
    ``out`` 4, 8 and 12 bytes past a 16-byte boundary, and within 5e-6 of
    the plain version, the card's logf/cosf against torch's (|eta| < 6, a
    few ulp each)."""
    seed = 2**33 + 12345
    ny, nx = shape
    n = ny * nx
    bits = philox_bits(seed, step, n, cuda)
    cell = torch.arange(n, dtype=torch.int64, device=cuda)
    want_bits = philox4x32_10((cell, step & 0xFFFFFFFF, step >> 32, 0),
                              (seed & 0xFFFFFFFF, seed >> 32))
    assert torch.equal(bits, want_bits)
    before = normals.launches, normals_per_cell.launches
    eta = normals(seed, step, (ny, nx), cuda)
    first = normals_per_cell(seed, step, (ny, nx), cuda)
    want = normals_reference(seed, step, ny, nx, device=cuda)
    torch.cuda.synchronize()
    assert (normals.launches, normals_per_cell.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(eta).all()
    assert torch.equal(eta, first)
    d = float((eta - want).abs().max())
    assert d <= 5e-6, d
    buf = torch.empty(n + 4, dtype=torch.float32, device=cuda)
    for skip in (1, 2, 3):
        out = buf[skip:skip + n]
        assert out.data_ptr() % 16 == 4 * skip
        random._call_philox("lb2d_normals", out, n, seed, step)
        torch.cuda.synchronize()
        assert torch.equal(out, first.reshape(-1)), skip


@pytest.mark.parametrize("noisy", [False, True], ids=["det", "noisy"])
def test_diffusion_model_kernel_backends_match_eager(cuda, noisy):
    """20 steps through each backend from one state: K3 in one launch, K2 as
    launches of temporal_k steps and one of the rest."""
    grid = dict(N=42, z=0.1, Lx=0.31, Ly=0.31, device=cuda)
    if noisy:
        make = lambda b: NoisyAdvectedFisherWave(vx=1.0, vy=0.5, vc=1.0,
                                                 backend=b, **grid)
    else:
        make = lambda b: ReactionAdvectionDiffusion(g=5.0, D=0.01, vx=1.0,
                                                    vy=0.5, backend=b, **grid)
    eager = make("eager")
    eager.run(7)
    eager.run(13)
    assert make("auto").backend == "resident"
    for backend in ("resident", "temporal"):
        sim = make(backend)
        sim.run(7)
        sim.run(13)
        d = float((sim.state - eager.state).abs().max())
        assert d <= 1e-5, (backend, d)


def test_velocity_model_resident_backend_matches_eager(cuda):
    kw = dict(u_w=0.05, omega=1.2, lx=127, ly=95, device=cuda)
    eager = PipeFlowVelocityInlet(backend="eager", **kw)
    sim = PipeFlowVelocityInlet(backend="resident", **kw)
    before = resident_velocity_run.launches
    f0 = eager.state_numpy() * np.float32(1.001)  # start off equilibrium
    for model in (eager, sim):
        model.load_numpy_state(f0)
        model.run(50)
    assert resident_velocity_run.launches == before + 1
    d = float((sim.state - eager.state).abs().max())
    assert d <= 1e-5, d


# the multifield kernels: per-field constants of the 2048^2
# FisherExpansion / 1024^2 Expansion of chip_smoke.py, with an imposed
# velocity; Expansion noise on every other population (one Philox call
# serves a pair, a population with Dg = 0 draws nothing), step0 just below
# 2^32 so that the K steps cross into the counter's high word
MF_FIELDS = [1, 2, 3, 4, 5, 6, 7, MAX_MULTIFIELD_FIELDS]
MF_SHAPES = [(254, 382), (128, 128), (45, 33), (7, 300)]
MF_IDS = ["254x382", "128x128", "45x33", "7x300"]


def _mf_kwargs(F, physics):
    rs = np.random.RandomState(F)
    P = F if physics == "fisher" else F - 1
    kw = dict(omegas=(1.9 + 0.09 * rs.rand(P)).astype(np.float32),
              lb_G=(1e-4 * (1 + rs.rand(P))).astype(np.float32),
              u_lb=0.0021, v_lb=-0.0013, physics=physics)
    if physics == "expansion":
        kw.update(omega_nutrient=np.float32(1.95), cutoff=0.01,
                  lb_Dg=np.where(np.arange(P) % 3 == 1, 0.0,
                                 0.02 * (1 + rs.rand(P))).astype(np.float32),
                  seed=2**40 + 7, step0=2**32 - 3)
    return kw


def _mf_inputs(device, F, shape, physics):
    """f = w rho (1 + 1% noise): Fisher densities summing to at most 0.9;
    Expansion densities in [0, 0.3] (many below the 0.01 cutoff) and a
    nutrient in [0, 1]."""
    ny, nx = shape
    rs = np.random.RandomState(2)
    if physics == "fisher":
        rho = 0.9 * rs.rand(F, ny, nx) / F
    else:
        rho = 0.3 * rs.rand(F, ny, nx) ** 2
        rho[-1] = rs.rand(ny, nx)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    f = w * rho * (1.0 + 0.01 * rs.randn(9, F, ny, nx))
    return torch.tensor(f, dtype=torch.float32, device=device)


@pytest.mark.parametrize("shape", MF_SHAPES, ids=MF_IDS)
@pytest.mark.parametrize("F", MF_FIELDS)
def test_temporal_multifield_fisher_matches_reference(cuda, F, shape):
    f = _mf_inputs(cuda, F, shape, "fisher")
    kw = _mf_kwargs(F, "fisher")
    for k in range(1, multifield_max_k(F) + 1):
        before = temporal_multifield_step.launches
        out = temporal_multifield_step(f, torch.empty_like(f), k, **kw)
        want = multifield_run_reference(f, k, **kw)
        torch.cuda.synchronize()
        assert temporal_multifield_step.launches == before + 1
        assert torch.equal(out, want), (k, float((out - want).abs().max()))


@pytest.mark.parametrize("shape", MF_SHAPES, ids=MF_IDS)
@pytest.mark.parametrize("F", MF_FIELDS[1:])
def test_temporal_multifield_expansion_is_exact(cuda, F, shape):
    f = _mf_inputs(cuda, F, shape, "expansion")
    kw = _mf_kwargs(F, "expansion")
    for k in range(1, multifield_max_k(F) + 1):
        out = temporal_multifield_step(f, torch.empty_like(f), k, **kw)
        want = multifield_run_reference(f, k, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and (out >= 0).all()
        assert torch.equal(out, want), (k, float((out - want).abs().max()))


@pytest.mark.parametrize("nx", [382, 37, 7])
@pytest.mark.parametrize("F", [2, 3, 5, MAX_MULTIFIELD_FIELDS])
@pytest.mark.parametrize("extra", [0, 5], ids=["B=2K", "B=2K+5"])
def test_expansion_band_kernel_is_exact_and_gives_k4_rows(cuda, extra, F, nx):
    """K5 on the band of rows [-B, B) equals its plain version and rows
    [-K, K) of K4 on the whole grid, bit for bit, noise on, at every K:
    strips of 3 columns at 382 (128 blocks), of one at 37 and 7."""
    assert band_plan.plan(F, 1, nx).width == (3 if nx == 382 else 1)
    f = _mf_inputs(cuda, F, (254, nx), "expansion")
    kw = _mf_kwargs(F, "expansion")
    physics = kw.pop("physics")
    step0 = kw.pop("step0")
    ny = f.shape[2]
    for k in range(1, band_max_k(F) + 1):
        B = 2 * k + extra
        band = torch.cat([f[:, :, -B:], f[:, :, :B]], dim=2).contiguous()
        args = [kw[n] for n in ("omegas", "omega_nutrient", "lb_G", "lb_Dg",
                                "cutoff", "u_lb", "v_lb")]
        band_kw = dict(seed=kw["seed"], step0=step0, row0=ny - B, ny=ny)
        before = expansion_band_step.launches
        got = expansion_band_step(band, k, *args, **band_kw)
        want = expansion_band_reference(band, k, *args, **band_kw)
        whole = temporal_multifield_step(f, torch.empty_like(f), k,
                                         physics=physics, step0=step0, **kw)
        torch.cuda.synchronize()
        assert expansion_band_step.launches == before + 1
        assert torch.equal(got, want), k
        rows = torch.cat([whole[:, :, -k:], whole[:, :, :k]], dim=2)
        assert torch.equal(got, rows), k


def test_multifield_models_kernel_backend_matches_eager(cuda):
    """20 steps through K4 (launches of temporal_k steps and one of the
    rest) against the eager step: FisherExpansion within 1e-6, Expansion
    (noise on) bit for bit."""
    grid = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
                D_standard=1.0, D_list=[1.0, 1.2], N=63, device=cuda)
    makers = {
        "fisher": lambda b: FisherExpansion(
            initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1],
            backend=b, **grid),
        "expansion": lambda b: Expansion(Nb=10.0, Dc=1.0, backend=b, **grid),
    }
    for name, make in makers.items():
        eager, sim = make("eager"), make("auto")
        assert sim.backend == "temporal"
        before = temporal_multifield_step.launches
        for model in (eager, sim):
            model.run(7)
            model.run(13)
        torch.cuda.synchronize()
        k = sim.temporal_k
        assert temporal_multifield_step.launches - before == (
            -(-7 // k) + -(-13 // k))
        d = float((sim.state - eager.state).abs().max())
        assert d <= (TOL if name == "fisher" else 0.0), (name, d)


# K6, the multicomponent step: the configurations (a)-(g) of mc_cases and
# runners of 1-4 fluids on D2Q9 and D2Q25
def _k6_against_plain(sim, steps=5):
    cfg, ext, lat = sim.config(), sim.ext_planes(), sim.lattice
    a, spare, rho = sim.f.clone(), torch.empty_like(sim.f), torch.empty_like(
        sim.rho)
    b = sim.f
    before = (mc_step.launches, mc_density.launches)
    for _ in range(steps):
        if cfg.interactions:
            mc_density(a, rho, cfg, lat)
        a, spare = mc_step(a, spare, rho, ext, cfg, lat), a
        b = mc_step_reference(b, cfg, lat, ext)
    torch.cuda.synchronize()
    dens = steps if cfg.interactions else 0
    assert (mc_step.launches, mc_density.launches) == (
        before[0] + steps, before[1] + dens)
    assert torch.isfinite(a).all()
    return float((a - b).abs().max())


@pytest.mark.parametrize("shape", [(254, 382), (128, 128)],
                         ids=["254x382", "128x128"])
@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_kernel_matches_reference(cuda, case, shape):
    sim = mc_case(case, *shape, device=cuda)
    assert sim.backend == "kernel"
    d = _k6_against_plain(sim)
    assert d <= TOL, d


@pytest.mark.parametrize("shape", [(3, 3), (5, 37), (9, 65)],
                         ids=["3x3", "5x37", "9x65"])
@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_step_tiles_match_reference_on_small_grids(cuda, case, shape):
    """mc_step's 32 x 8 tiles and psi windows on grids smaller than a tile
    or with a ragged last tile, the belts wrapping or clamped several
    times around the grid."""
    sim = mc_case(case, *shape, device=cuda)
    d = _k6_against_plain(sim)
    assert d <= TOL, d


def _mc_fluids(device, C, lattice, porous, shape=(254, 382)):
    """C fluids: Shan-Chen between neighbours, a second-belt interaction
    between the first and the last, a constant force, growth and eating."""
    ny, nx = shape
    sim = SimulationRunner(nx=nx, ny=ny, num_populations=C, porous=porous,
                           lattice=lattice, device=device)
    rs = np.random.RandomState(C)
    for i in range(C):
        sim.add_fluid(Fluid(sim, i, nu_e=0.3 + 0.1 * i,
                            epsilon=0.8 if porous else 1.0, nu_fluid=0.4,
                            K=2.0, Fe=0.5))
    sim.complete_setup()
    for i in range(C):
        sim.fluid_list[i].initialize((0.8 + 0.1 * rs.rand(ny, nx)) / C,
                                     f_amp=0.01)
    for i in range(C - 1):
        sim.add_interaction_force(i, i + 1, G_int=1.2, potential="shan_chen",
                                  potential_parameters=[1.0])
    if C > 1:
        sim.add_interaction_force_second_belt(0, C - 1, G_int=0.5)
        sim.add_eating_rate(C - 1, 0, 0.01)
    sim.add_constant_body_force(0, 1e-5, -2e-6)
    sim.add_growth(0, 0.1, 2.0, 1e-4)
    return sim


@pytest.mark.parametrize("porous", [True, False], ids=["porous", "plain"])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("lattice", [D2Q9, D2Q25], ids=["D2Q9", "D2Q25"])
def test_mc_kernel_fluids_matches_reference(cuda, lattice, C, porous):
    d = _k6_against_plain(_mc_fluids(cuda, C, lattice, porous))
    assert d <= TOL, (C, d)


def test_mc_runner_auto_runs_the_kernel(cuda):
    """``auto`` picks K6 on CUDA, zero-gradient edges and the radial g
    force included; 20 steps match the eager runner within 1e-5."""
    kw = dict(device=cuda)
    eager = mc_case("e", 64, 96, backend="eager", **kw)
    sim = mc_case("e", 64, 96, **kw)
    assert sim.backend == "kernel" and eager.backend == "eager"
    before = mc_step.launches
    for model in (eager, sim):
        model.run(7)
        model.run(13, k_steps=4)  # accepted, changes nothing
    torch.cuda.synchronize()
    assert mc_step.launches - before == 20 and sim.steps_per_call == 1
    assert sim.backend_used == "kernel"
    d = float((sim.f - eager.f).abs().max())
    assert d <= 1e-5, d
    with pytest.raises(ValueError, match="backend='eager'"):
        SimulationRunner(nx=16, ny=16, device=cuda, dtype=torch.float64)


# K8, the screened-gradient solve, and its 1-D pass
K8_PATHS = {(48, 48): "tile", (50, 50): "tile", (45, 64): "tile",
            (256, 384): "tile",
            (1024, 1024): "tile", (2048, 48): "four-step",
            (4096, 96): "four-step", (127, 250): None, (8191, 16): None,
            (16, 20000): None}


@pytest.mark.parametrize("shape", list(K8_PATHS),
                         ids=[f"{y}x{x}" for y, x in K8_PATHS])
def test_screened_gradients_kernel_matches_reference(cuda, shape):
    """Every path of the wrapper: the tiled plan with one column launch
    (powers of two, mixed radices) or the four-step split, and the
    whole-line kernel (a prime line, one too long for shared memory: the
    scratch-buffer path)."""
    plan = solve_plan(*shape)
    assert (plan and plan.path) == K8_PATHS[shape]
    rho = torch.tensor(np.random.RandomState(0).rand(*shape).astype(
        np.float32), device=cuda)
    before = screened_gradients.launches
    got = screened_gradients(rho, 16.0, out_scale=-0.5)
    want = screened_gradients_reference(rho, 16.0, out_scale=-0.5)
    torch.cuda.synchronize()
    assert screened_gradients.launches == before + solve_launches(*shape)
    d = float((got - want).abs().max() / want.abs().max())
    assert d <= 1e-5, d
    out = torch.empty_like(got)
    xg, yg = screened_gradients(rho, 16.0, out=out)
    assert xg.data_ptr() == out.data_ptr()
    assert float((yg * -0.5 - got[1]).abs().max()) <= 1e-6 * float(
        want.abs().max())


@pytest.mark.parametrize("n,W", [(256, 256), (8192, 128), (127, 64),
                                 (8191, 8)])
@pytest.mark.parametrize("real,inverse", [(True, False), (False, False),
                                          (False, True)],
                         ids=["real", "complex", "inverse"])
def test_dft_axis0_kernel_matches_torch_fft(cuda, n, W, real, inverse):
    rs = np.random.RandomState(1)
    xr = torch.tensor(rs.rand(n, W).astype(np.float32), device=cuda)
    xi = None if real else torch.tensor(rs.rand(n, W).astype(np.float32),
                                        device=cuda)
    rows = n // 2 + 1 if real else None
    got = dft_axis0(xr, xi, inverse=inverse, out_rows=rows)
    want = dft_axis0_reference(xr, xi, inverse=inverse, out_rows=rows)
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * scale


# K7, the coupled families' step
def _coupled_config(physics):
    return CoupledConfig(physics, omega=1.6, lb_G=1e-3, omega2=1.2,
                         lb_G2=2e-3, epsilon=0.05, rho_o=1.0, G_chen=-0.5,
                         c_o=0.25, alpha=2.5 if physics.endswith("only")
                         else 2.0)


def _coupled_state(cfg, shape, device, seed=7):
    """A random state near rest with a random velocity field."""
    rs = np.random.RandomState(seed)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    f = torch.tensor(w * (0.2 + rs.rand(9, cfg.fields, *shape)),
                     dtype=torch.float32, device=device)
    ext = torch.tensor(0.02 * (rs.rand(2, *shape) - 0.5),
                       dtype=torch.float32, device=device)
    return f, ext


@pytest.mark.parametrize("shape", [(254, 382), (128, 128)],
                         ids=["254x382", "128x128"])
@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_coupled_kernel_matches_reference(cuda, physics, shape):
    """K7 on a random state with a random velocity field, 5 steps as one
    launch of 5 and as 5 launches of 1, against 5 plain steps; the two
    launches agree bit for bit."""
    cfg = _coupled_config(physics)
    f, ext = _coupled_state(cfg, shape, cuda)
    before = coupled_sweep.launches
    a = coupled_sweep(f, torch.empty_like(f), ext, cfg, 5)
    b = f
    for _ in range(5):
        b = coupled_sweep(b, torch.empty_like(b), ext, cfg, 1)
    want = coupled_sweep_reference(f, cfg, 5, ext)
    torch.cuda.synchronize()
    assert coupled_sweep.launches == before + 6
    assert torch.isfinite(a).all() and torch.equal(a, b)
    d = float((a - want).abs().max())
    assert d <= TOL, d
    if cfg.reads_ext:  # one step by the one-step kernel on the densities
        rho = coupled_density(f, torch.empty((cfg.fields, *shape),
                                             device=cuda))
        got = _coupled_cell_step(f, torch.empty_like(f), rho, ext, cfg)
        d = float((got - coupled_sweep_reference(f, cfg, 1, ext)).abs().max())
        assert d <= TOL, d


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_coupled_sweep_every_k_matches_its_twin(cuda, physics, k):
    """K7 at every K up to its limit against its plain twin, on a 45x33
    grid narrower than one strip and a 37x301 grid of several strips; the
    limit equals the Python mirror's."""
    cfg = _coupled_config(physics)
    assert coupled_max_k(cfg) == _build.load_library().lb2d_coupled_max_k(
        COUPLED_PHYSICS[physics]) == 8
    for shape in ((45, 33), (37, 301)):
        f, ext = _coupled_state(cfg, shape, cuda, seed=k)
        got = coupled_sweep(f, torch.empty_like(f), ext, cfg, k)
        d = float((got - coupled_sweep_reference(f, cfg, k, ext)).abs().max())
        assert d <= TOL, (shape, d)


COUPLED_MODELS = {
    "ScreenedFisherWave": lambda **kw: ScreenedFisherWave(
        Lx=1.0, Ly=1.0, vc=5.0, lam=0.1, R0=0.2, N=128, **kw),
    "SurfactantNutrientWave": lambda **kw: SurfactantNutrientWave(
        Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=128, **kw),
    "ClumpySurfactantNutrientWave": lambda **kw: ClumpySurfactantNutrientWave(
        Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=128, rho_o=1.0,
        G_chen=-5.0, **kw),
    "RocketYeast": lambda **kw: RocketYeast(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=128, G_chen=-0.1,
        **kw),
    "RocketYeastForcesOnly": lambda **kw: RocketYeastForcesOnly(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=128, G_chen=-0.1,
        **kw),
}


COUPLED_RUNS = ([(name, 1) for name in COUPLED_MODELS]
                + [(name, 4) for name in COUPLED_MODELS
                   if not name.startswith("Rocket")])


@pytest.mark.parametrize("name,stale", COUPLED_RUNS,
                         ids=[f"{n}-stale{k}" for n, k in COUPLED_RUNS])
def test_coupled_model_kernel_backend_matches_eager(cuda, name, stale):
    """``auto`` runs K7 (and K6's density pass and K8, the screened models)
    on CUDA; ``run(11)`` (the rocket yeasts: two launches of 4 and one of
    3; at ``stale_velocity=4``: two sweeps and three exact steps by the
    one-step kernel) matches the eager backend with the plain solve."""
    kw, eager_kw = dict(device=cuda), dict(device=cuda, backend="eager")
    if not name.startswith("Rocket"):
        kw["stale_velocity"] = eager_kw["stale_velocity"] = stale
    sim, eager = COUPLED_MODELS[name](**kw), COUPLED_MODELS[name](**eager_kw)
    assert sim.backend == "kernel" and eager.backend == "eager"
    before = (coupled_sweep.launches, screened_gradients.launches,
              mc_density.launches)
    sim.run(11)
    eager.run(11)
    torch.cuda.synchronize()
    if name.startswith("Rocket"):
        assert sim.steps_per_call == 4
        want = (3, 0, 0)
    else:
        solves = 11 if stale == 1 else 5
        want = (solves, solve_launches(sim.ny, sim.nx) * solves, solves)
    assert (coupled_sweep.launches - before[0],
            screened_gradients.launches - before[1],
            mc_density.launches - before[2]) == want
    d = float((sim.state - eager.state).abs().max())
    assert d <= 1e-5, d


def _config5(n, stale=None, backend="auto", device="cuda"):
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=True, device=device, backend=backend,
                           stale_force=stale)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1 / 6, epsilon=0.8, nu_fluid=1 / 6,
                            K=10.0, Fe=0.1))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(0).rand(n, n).astype(
        np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    return sim


@pytest.mark.parametrize("stale", [None, 4], ids=["exact", "stale4"])
def test_config5_kernel_matches_eager(cuda, stale):
    """BASELINE config 5 at 256^2 through mc_density + K8 + mc_step against
    the eager runner (the plain solve inside the plain step), 9 steps."""
    sim, eager = _config5(256, stale), _config5(256, stale, "eager")
    before = (mc_density.launches, screened_gradients.launches)
    sim.run(9)
    eager.run(9)
    torch.cuda.synchronize()
    solves = 9 if stale is None else 3
    assert (mc_density.launches - before[0],
            screened_gradients.launches - before[1]) == (
                9, solve_launches(256, 256) * solves)
    d = float((sim.f - eager.f).abs().max())
    assert d <= TOL, d


# K9, the sharded step
@pytest.mark.parametrize("mesh", HALO_MESHES,
                         ids=[f"{my}x{mx}" for my, mx in HALO_MESHES])
@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_kernel_matches_twin(cuda, case, mesh):
    """K9 on each shard of a 254x382 random state (shards of unequal edges,
    with and without x strips) at every K up to 8 for the physics of K2's
    row sweep, at K = 1, 2, 3 and the physics' K for the others, from a
    global step whose sweep crosses the noise counter's high word."""
    physics = HALO_CASES[case][0]
    f, mask = halo_case_state(case, 254, 382, cuda)
    cuts = shard_cuts(254, 382, *mesh)
    before = temporal_halo_step.launches
    for k in halo_case_ks(case):
        d = compare_halo_case(case, f, mask, cuts, k, step0=2**32 - 3)
        assert d <= halo_tolerance(physics), (k, d)
    torch.cuda.synchronize()
    assert temporal_halo_step.launches == before + len(
        halo_case_ks(case)) * len(cuts)


SWEEP_CASES = [c for c, v in HALO_CASES.items()
               if v[0] in HALO_SWEEP_PHYSICS]


@pytest.mark.parametrize("grid,cut", SMALL_HALO_CUTS, ids=[
    f"{g[0]}x{g[1]}-{c[0]}x{c[1]}" for g, c in SMALL_HALO_CUTS])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_halo_sweep_small_shards(cuda, case, grid, cut):
    """K9's row sweep on small ragged shards (narrower than one strip, a
    few rows high, x wrapping within the shard in the 2x1 cut) at every K
    that the shards take, against the plain twin."""
    physics = HALO_CASES[case][0]
    ny, nx = grid
    f, mask = halo_case_state(case, ny, nx, cuda)
    cuts = shard_cuts(ny, nx, *cut)
    edge = min(min(H, W) if cut[1] > 1 else H for _, _, H, W in cuts)
    for k in [k for k in halo_case_ks(case) if k <= edge]:
        d = compare_halo_case(case, f, mask, cuts, k, step0=2**32 - 3)
        assert d <= halo_tolerance(physics), (k, d)


PIPE_64x132 = dict(N=63, pipe_length=1.5 * 130.5 / 63, diameter=1.5,
                   rho=10.0, viscosity=5.0, pressure_grad=-100.0)


@pytest.mark.parametrize("obstacle", [False, True], ids=["open", "obstacle"])
@pytest.mark.parametrize("mesh", HALO_MESHES,
                         ids=[f"{my}x{mx}" for my, mx in HALO_MESHES])
def test_sharded_pipe_flow_matches_unsharded_kernel(cuda, mesh, obstacle):
    """ShardedPipeFlow (four shards on one card, ``auto``: K9) against
    PipeFlow through K2, from the same bits, over 10 steps: two sweeps of
    HALO_TEMPORAL_K["flow"] = 4 and a remainder sweep of two steps."""
    kw = dict(PIPE_64x132)
    if obstacle:
        m = np.zeros((64, 132), np.int32)
        m[20:40, 30:50] = 1
        kw["obstacle_mask"] = m
    single = PipeFlow(device=cuda, backend="temporal", **kw)
    sh = ShardedPipeFlow(mesh=make_mesh(devices=[cuda] * 4, shape=mesh),
                         **kw)
    assert sh.backend == "temporal" and sh.steps_per_call == 4
    assert np.array_equal(sh.state_numpy(), single.state_numpy())
    before = temporal_halo_step.launches
    single.run(10)
    sh.run(10)
    torch.cuda.synchronize()
    assert temporal_halo_step.launches == before + 4 * 3
    d = float(np.abs(sh.state_numpy() - single.state_numpy()).max())
    assert d <= TOL, d


DIFFUSION_132 = dict(N=130, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0,
                     Lx=0.101, Ly=0.101, g=1.0)
MULTIFIELD_132 = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
                      D_standard=1.0, D_list=[1.0, 1.0], N=130)


def _sharded_runs():
    from lb2d_tpu_torch.models import ReactionAdvectionDiffusionStochastic
    return {
        "diffusion": (ReactionAdvectionDiffusion, DIFFUSION_132,
                      ShardedDiffusion),
        "noisy_fisher": (ReactionAdvectionDiffusionStochastic,
                         dict(DIFFUSION_132, Dg=0.2), ShardedDiffusion),
        "fisher": (FisherExpansion, dict(
            MULTIFIELD_132, initial_frac_widths=[0.5, 0.5],
            initial_frac_indices=[0, 1]), ShardedMultifield),
        "expansion": (Expansion, MULTIFIELD_132, ShardedMultifield),
    }


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("name", ["diffusion", "noisy_fisher", "fisher",
                                  "expansion"])
def test_sharded_models_equal_unsharded_kernels(cuda, name, mesh):
    """The sharded diffusion and multifield models (K9 on four shards of
    one card) equal the unsharded K2 / K4 runs bit for bit, noise included,
    over two sweeps and a shorter one."""
    cls, kw, sharded = _sharded_runs()[name]
    single = cls(device=cuda, backend="temporal", **kw)
    sh = sharded(cls(device=cuda, **kw),
                 mesh=make_mesh(devices=[cuda] * 4, shape=mesh))
    n = 2 * sh.steps_per_call + 1
    single.run(n)
    sh.run(n)
    want = single.state_numpy().reshape(sh.state_numpy().shape)
    assert np.array_equal(sh.state_numpy(), want)


# K6h and K7h: K6 and K7 on a shard and its halo
HALO_IDS = [f"{my}x{mx}" for my, mx in HALO_MESHES]


@pytest.mark.parametrize("mesh", HALO_MESHES, ids=HALO_IDS)
@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_halo_kernel_matches_k6_and_twin(cuda, case, mesh):
    """K6h on the shards of a 254x382 runner state (shards of unequal edges,
    with and without x strips; D2Q25 and zero-gradient edges among the
    cases), 5 steps, against K6 on the whole grid and the plain twins."""
    sim = mc_case(case, 254, 382, device=cuda)
    cuts = shard_cuts(254, 382, *mesh)
    before = (mc_density_halo.launches, mc_step_halo.launches)
    d_k6, d_twin, d_rho = compare_mc_halo(sim.f, sim.config(), sim.lattice,
                                          sim.ext_planes(), cuts)
    torch.cuda.synchronize()
    assert (mc_density_halo.launches - before[0],
            mc_step_halo.launches - before[1]) == (5 * len(cuts),) * 2
    assert d_k6 <= TOL and d_twin <= TOL and d_rho <= TOL, (d_k6, d_twin,
                                                            d_rho)


@pytest.mark.parametrize("case", list(MC_CASES))
def test_mc_halo_kernel_equals_k6(cuda, case):
    """K6h's shards hold the same cells as K6's grid, bit for bit on D2Q9:
    the same tile code on the same values (2x2 shards of a 254x382 state).
    nvcc contracts the D2Q25 instantiations' multiply-adds differently
    (a few 1e-9), so case (d) is held to the kernels' tolerance."""
    sim = mc_case(case, 254, 382, device=cuda)
    d_k6, _, d_rho = compare_mc_halo(sim.f, sim.config(), sim.lattice,
                                     sim.ext_planes(),
                                     shard_cuts(254, 382, 2, 2))
    limit = 0.0 if sim.lattice.q == 9 else TOL
    assert d_k6 <= limit and d_rho <= limit, (d_k6, d_rho)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("mesh", HALO_MESHES, ids=HALO_IDS)
@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_coupled_halo_kernel_matches_k7_and_twin(cuda, physics, mesh, k):
    """K7h on the shards of a random 254x382 state with a random velocity
    field (x halos on the 2x2 and 1x4 cuts), K steps in one launch, against
    K7's launch on the whole grid, the plain twin and K one-step
    launches."""
    cfg = _coupled_config(physics)
    f, ext = _coupled_state(cfg, (254, 382), cuda)
    cuts = shard_cuts(254, 382, *mesh)
    before = coupled_sweep_halo.launches
    d = compare_coupled_halo(f, cfg, ext, cuts, k)
    torch.cuda.synchronize()
    one_step = len(cuts) if cfg.reads_ext else 0  # the one-step kernel
    assert coupled_sweep_halo.launches == before + (1 + k) * len(cuts) + \
        one_step
    assert max(d) <= TOL, d


@pytest.mark.parametrize("stale", [None, 4], ids=["exact", "stale4"])
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_sharded_config5_matches_unsharded_kernel(cuda, mesh, stale):
    """BASELINE config 5 at 256^2 ``shard_over`` four shards of one card
    (K6h, K8 once per step or sweep on the gathered density) against the
    unsharded K6 + K8 runner, 9 steps."""
    single = _config5(256, stale)
    sh = _config5(256, stale).shard_over(make_mesh(devices=[cuda] * 4,
                                                   shape=mesh))
    assert sh.f is None
    before = (mc_step_halo.launches, screened_gradients.launches)
    single.run(9)
    sh.run(9)
    torch.cuda.synchronize()
    solves = 9 if stale is None else 3
    assert (mc_step_halo.launches - before[0],
            screened_gradients.launches - before[1]) == (
                4 * 9, 2 * solve_launches(256, 256) * solves)
    d = float(np.abs(sh.state_numpy() - single.state_numpy()).max())
    assert d <= TOL, d
    assert float((sh.rho - single.rho).abs().max()) <= TOL


@pytest.mark.parametrize("name,stale", COUPLED_RUNS,
                         ids=[f"{n}-stale{k}" for n, k in COUPLED_RUNS])
def test_sharded_coupled_matches_unsharded_kernel(cuda, name, stale):
    """ShardedCoupled on 2x2 shards of one card (K7h; K6h and K8 on the
    gathered density for the screened models) against the unsharded kernel
    run, ``run(11)``."""
    kw = dict(device=cuda)
    if not name.startswith("Rocket"):
        kw["stale_velocity"] = stale
    single = COUPLED_MODELS[name](**kw)
    sh = ShardedCoupled(COUPLED_MODELS[name](**kw),
                        mesh=make_mesh(devices=[cuda] * 4, shape=(2, 2)))
    before = coupled_sweep_halo.launches
    single.run(11)
    sh.run(11)
    torch.cuda.synchronize()
    launches = (-(-11 // sh.steps_per_call) if name.startswith("Rocket")
                else (11 if stale == 1 else 5))
    assert coupled_sweep_halo.launches == before + 4 * launches
    d = float(np.abs(sh.state_numpy().ravel()
                     - single.state_numpy().ravel()).max())
    assert d <= TOL, d


@pytest.mark.parametrize("name", ["RocketYeast", "ScreenedFisherWave",
                                  "ClumpySurfactantNutrientWave"])
def test_eager_sharded_coupled_launches_no_kernel(cuda, name):
    """ShardedCoupled of a model built with ``backend="eager"`` on the card
    runs the plain twins, as the unsharded eager model does: ``run(5)``
    launches no K7h, K6h density pass or K7 and equals the unsharded eager
    run."""
    kw = dict(device=cuda, backend="eager")
    single = COUPLED_MODELS[name](**kw)
    sh = ShardedCoupled(COUPLED_MODELS[name](**kw),
                        mesh=make_mesh(devices=[cuda] * 4, shape=(2, 2)))
    before = (coupled_sweep_halo.launches, coupled_sweep.launches,
              mc_density_halo.launches)
    single.run(5)
    sh.run(5)
    torch.cuda.synchronize()
    assert (coupled_sweep_halo.launches, coupled_sweep.launches,
            mc_density_halo.launches) == before
    d = float(np.abs(sh.state_numpy().ravel()
                     - single.state_numpy().ravel()).max())
    assert d <= TOL, d


# P2, the transpose
@pytest.mark.parametrize("shape", [(4224, 8192), (254, 382), (1, 33),
                                   (33, 1)])
def test_transpose_kernel_is_exact(cuda, shape):
    x = torch.randn(shape, device=cuda)
    before = transpose.launches
    got = transpose(x)
    torch.cuda.synchronize()
    assert transpose.launches == before + 1
    assert torch.equal(got, transpose_reference(x))


# the flow moments (device_field, get_fields)
# The kernel adds the populations in direction order, torch.sum in its own:
# each order rounds to a few ulp of the partial sums (|f| sums to rho ~ 1),
# ~1e-7 apart; of max |field| that is below 1e-6 for rho and for velocities
# of order 0.1, as in these states (speeds up to 0.14, Mach 0.25)
MOMENTS_TOL = 1e-6
MOMENT_SUBSETS = [("rho",), ("u",), ("v",), ("u", "v"), ("v", "rho"),
                  ("rho", "u", "v")]


def _moving_state(device, ny, nx, offset=0):
    """feq of rho in [0.9, 1.1] and u, v in [-0.1, 0.1] times 1 + 1% noise
    (numpy seed 4), ``offset`` floats into its buffer (contiguous)."""
    rng = np.random.RandomState(4)
    rho, u, v = (torch.tensor(rng.uniform(lo, hi, (ny, nx)),
                              dtype=torch.float32)
                 for lo, hi in ((0.9, 1.1), (-0.1, 0.1), (-0.1, 0.1)))
    f = feq_quadratic(rho, u, v) * torch.tensor(
        1.0 + 0.01 * rng.randn(9, ny, nx), dtype=torch.float32)
    buf = torch.empty(offset + f.numel(), device=device)
    state = buf[offset:].view(9, ny, nx)
    state.copy_(f)
    return state


@pytest.mark.parametrize("incompressible", [False, True],
                         ids=["compressible", "incompressible"])
@pytest.mark.parametrize("shape,offset", [((254, 382), 0), ((31, 61), 0),
                                          ((64, 64), 1), ((1, 1), 0)],
                         ids=["254x382", "31x61", "64x64-unaligned", "1x1"])
def test_moments_kernel_matches_plain_moments(cuda, shape, offset,
                                              incompressible):
    f = _moving_state(cuda, *shape, offset)
    want = dict(zip(moments.FIELDS,
                    moments._hydro_plain(f, D2Q9, incompressible)))
    for fields in MOMENT_SUBSETS:
        before = moments.flow_moments.launches
        got = moments.flow_moments(f, fields, incompressible)
        planes = moments.hydro_planes(f, fields, incompressible)
        torch.cuda.synchronize()
        assert moments.flow_moments.launches == before + 2
        for name, a, b in zip(fields, got, planes):
            scale = float(want[name].abs().max())
            assert torch.equal(a, b), (fields, name)
            d = float((a - want[name]).abs().max())
            assert d <= MOMENTS_TOL * scale, (fields, name, d, scale)


def test_device_field_on_the_card_is_one_launch(cuda):
    sim = PipeFlow(N=31, diameter=1.5, rho=10.0, viscosity=5.0,
                   pressure_grad=-100.0, pipe_length=1.5 * 62.5 / 31,
                   device=cuda)
    sim.run(100)
    want = dict(zip(moments.FIELDS, moments._hydro_plain(
        sim.state, D2Q9, False)))
    before = moments.flow_moments.launches
    for name in moments.FIELDS:
        got = sim.device_field(name)
        d = float((got - want[name]).abs().max())
        # near rest: a few ulp of rho ~ 1 (not of the field's own max)
        assert d <= MOMENTS_TOL, (name, d)
    rho, u, v = sim._hydro_fn()(sim.state)
    assert moments.flow_moments.launches == before + 4
    assert torch.equal(rho, sim.device_field("rho"))
    assert torch.equal(u, sim.device_field("u"))


# the C++ CPU engine (backend="native") on a CUDA model
NATIVE_PIPE = dict(N=31, diameter=1.5, rho=10.0, viscosity=5.0,
                   pressure_grad=-100.0, pipe_length=1.5 * 62.5 / 31)


def _native_mask():
    mask = np.zeros((32, 64), np.int32)
    mask[12:20, 20:30] = 1
    return mask


@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_native_model_on_a_cuda_state(cuda, equilibrium, obstacle):
    """``run(n)`` of a ``device="cuda"`` native model copies the state to
    the host and back: it keeps the state on the card, launches no hand
    kernel, equals the same model on the CPU bit for bit and stays within
    1e-5 (tests/test_native.py's bar) of K2 and of the eager step on the
    card."""
    kw = dict(NATIVE_PIPE, equilibrium=equilibrium,
              obstacle_mask=_native_mask() if obstacle else None)
    on_card = PipeFlow(backend="native", device=cuda, **kw)
    on_host = PipeFlow(backend="native", device="cpu", **kw)
    k2 = PipeFlow(backend="temporal", device=cuda, **kw)
    eager = PipeFlow(backend="eager", device=cuda, **kw)
    before = (pipe_step.launches, temporal_pipe_step.launches,
              resident_pipe_run.launches)
    on_card.run(13)
    on_card.run(7, timed=True)
    torch.cuda.synchronize()
    assert (pipe_step.launches, temporal_pipe_step.launches,
            resident_pipe_run.launches) == before
    assert on_card.state.is_cuda and on_card.steps_taken == 20
    assert on_card.last_mlups > 0
    on_host.run(20)
    assert torch.equal(on_card.state.cpu(), on_host.state)
    k2.run(20)
    eager.run(20)
    for other in (k2, eager):
        d = float((on_card.state - other.state).abs().max())
        assert d < 1e-5, d


def test_native_getters_on_a_cuda_state(cuda):
    """The native model's step and getters are the eager step's on the
    card."""
    sim = PipeFlow(backend="native", device=cuda, **NATIVE_PIPE)
    eager = PipeFlow(backend="eager", device=cuda, **NATIVE_PIPE)
    sim.run(10)
    eager.load_numpy_state(sim.state_numpy())
    assert torch.equal(sim.make_step()(sim.state), eager._step(eager.state))
    fields = sim.get_fields()
    assert fields["u"].shape == (sim.nx, sim.ny)
    assert np.isfinite(fields["rho"]).all()
