"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lb2d_tpu_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the main paths through
the kernels that ``backend="auto"`` picks, each path with the launch counts
set to 0 just before it and read just after:

* the flow slice: ``PipeFlow`` at 4096^2 (the ``bench.py`` workload) and at
  the reference's 32x256 benchmark grid, ``PipeFlowVelocityInlet`` at its
  default 401x401 (K2), and the same through ``backend="resident"`` (K3);
* the diffusion slice, at the reference's own sizes: ``AdvectionDiffusion``
  at 2048^2 (K2 diffusion), ``ReactionAdvectionDiffusionStochastic`` at
  2048^2 (K2 noisy_fisher), ``NoisyAdvectedFisherWave`` at 256^2 (K3
  noisy_fisher, and the Philox normals of its next step, P1) and
  ``ReactionAdvectionDiffusion`` at 512^2 (K3 diffusion);
* the multifield slice, at the reference's own sizes: ``FisherExpansion``
  at 2048^2 with 2 populations (K4 fisher), ``Expansion`` at 1024^2 with 2
  populations and the nutrient (K4 expansion), and K5, the Expansion's
  seam-band op, through its own entry point on that model's band (K5 and
  P1 timed by CUDA events and by CUDA-graph replay; P1 held bit for bit to
  its first one-cell-a-thread loop, ``normals_per_cell``);
* the multicomponent slice (K6, ``mc_density`` + ``mc_step``): the porous
  two-fluid Shan-Chen ``SimulationRunner`` of BASELINE config 5 at 8192^2
  without its screened-Poisson hook, the spinodal decomposition at 1024^2
  and a D2Q25 two-fluid runner at 1024^2;
* the spectral slice (K8, ``screened_gradients``, and K7,
  ``coupled_sweep``, K steps a launch): BASELINE config 5 whole at 8192^2
  (K6 + K8, its screened-Poisson force solved every step) and its
  ``stale_force=8`` variant, then the coupled models at
  ``examples/zoo_drive.py``'s sizes: ``ScreenedFisherWave`` at 1024^2
  (and ``stale_velocity=8``), ``SurfactantNutrientWave`` at 512^2 (and
  ``stale_velocity=8`` at 1024^2), ``ClumpySurfactantNutrientWave`` at
  512^2, ``RocketYeast`` and ``RocketYeastForcesOnly`` at 1024^2, with K7
  held to its plain steps and its one-step launches at K = 1, 2 and the
  path's K from each model's state and a random 254x382 state. K8 is held to its plain solve at
  8192^2, 1024^2, 512^2, 48^2, 50^2, 45x64, 127x250 and 8191x16 (the tiled
  plan's four-step and one-launch column paths, and the whole-line
  kernel) and timed per solve and per pass at 8192^2 and 1024^2 beside
  cuFFT (``torch.fft``) computing the same function;
* the sharded slice (K9, ``temporal_halo_step``): K9 on the shards of
  random 254x382 states cut 2x2, 4x1 and 1x4, per physics, against its
  plain twin (the physics of K2's row sweep at every K from 1 to 8);
  ``ShardedPipeFlow`` at 8192^2 (``benchmarks/run_all.py``'s
  ``bench_sharded_8192``) on 4x1 and 2x2 meshes of shards on one card
  against ``PipeFlow`` through K2, and the sharded diffusion and
  multifield models against their unsharded K2 / K4 runs, all bit for bit
  but flow; then the 8192^2 ``run(100)`` on 4x1 in its own counted window
  beside the unsharded K2 run and the halo exchange's share, and the other
  sharded models' shorter runs in theirs;
* the sharded runner and coupled families (K6h, ``mc_density_halo`` +
  ``mc_step_halo``, and K7h, ``coupled_sweep_halo``): BASELINE config 5 at
  8192^2 ``shard_over`` 4x1 shards of one card (``benchmarks/run_all.py``'s
  ``bench_porous_poisson_8192`` and its ``stale_force=8`` variant), held to
  the unsharded K6 + K8 run and timed beside it in counted windows, with
  the halo exchange's and the density sharing's ms per step; K6h against K6
  and its twins on 2x2 shards of the 1024^2 spinodal, a D2Q25 and a
  zero-gradient runner; ``ShardedCoupled`` over each coupled model at
  ``zoo_drive.py``'s sizes, K7h held to K7, its twin and its one-step
  launches at K = 1, 2 and the run's K, ``run(64)`` each in its own window;
  and P2 (``transpose``) at the probe's [4224, 8192],
  equal to ``x.t().contiguous()`` and timed beside it;
* the Poisson slice (plain torch ops, no hand kernel: each path must
  launch none): ``PoissonSolver`` at 1024^2 for a fixed 2,000 iterations,
  its blocks of ``check_every`` iterations replayed as CUDA graphs (a
  replayed block held to the eager one on the card), at 48^2 against the
  CPU and at 32^2 to its steady state; ``RepellingFisherWave`` at N = 128
  (``examples/zoo_drive.py``'s) in its exact, gated and tracking modes,
  20 timed outer steps each (MLUPS, inner iterations, host reads and
  graph replays per outer step, gated and tracking against exact, the
  tracking mode's replayed outer step against its eager step); and the
  ``utils`` on the card: ``save_model`` / ``restore_model`` of its tuple
  state, ``accumulated_sum(..., "f64")`` and one frame of
  ``render_field`` with an explicit LUT;
* the C++ CPU engine (``backend="native"``, no hand kernel: its runs must
  launch none): against the eager step on this machine's CPU with an
  obstacle in both equilibria, on a ``device="cuda"`` state against K2,
  and timed on the reference's cylinder at N = 50 (MLUPS of the host CPU,
  printed with its ``/proc/cpuinfo`` names and thread count);
* the flow moments (``flow_moments``, the readout's kernel): against the
  plain moments at 4096^2, 3751x1251 and 32x256 in both forms, every plane
  and all three, and timed per plane beside its bound and the plain
  moments; a flow model's readout (``device_field`` u and v,
  ``get_fields``) in a counted window, one launch each;
* the examples (``examples_torch``) on the card: ``zoo_drive.main()`` at
  its default sizes (every row ok, every model with a kernel on it),
  ``backend_comparison.main(steps=1000)`` on the 3751x1251 cylinder (K2)
  and ``poiseuille_verification`` at N = 10 and 50 (K3, the error falling
  with N), each in a counted window.

It checks the physics (Poiseuille profile through each flow backend,
cylinder mass, Gaussian spreading, advection, mass, noise amplitude and
normal moments, wall mass conservation and the logistic cap, nutrient
consumption, the Darcy balance, mass per fluid and spinodal separation,
the screened Fisher wave's outward velocity, the surfactant wave's growth
and consumption, rocket yeast's surfactant production),
sweeps K2's steps per launch for the flow and the diffusion physics and
K4's for the multifield physics (K = 1..8), holds K2 and K4 (the row
sweeps) to their plain steps at every K and on grids narrower than a strip
or shorter than the card's segments (K2's velocity inlet in its small
grids' tiles and on its row sweep, and on the sweep on every grid), and
prints the measured numbers. Every phase raises on failure; the last line
is the JSON result and is printed only when all phases passed. Uses no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from examples_torch import (
    backend_comparison,
    poiseuille_verification,
    zoo_drive,
)
from lb2d_tpu_torch.core import D2Q9, D2Q25
from lb2d_tpu_torch.halo_cases import (
    HALO_CASES,
    HALO_MESHES,
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
    AdvectionDiffusion,
    ClumpySurfactantNutrientWave,
    Diffusion,
    Expansion,
    FisherExpansion,
    Fluid,
    NoisyAdvectedFisherWave,
    PipeFlow,
    PipeFlowCylinder,
    PipeFlowObstacles,
    PipeFlowVelocityInlet,
    PoissonSolver,
    ReactionAdvectionDiffusion,
    ReactionAdvectionDiffusionStochastic,
    RepellingFisherWave,
    RocketYeast,
    RocketYeastForcesOnly,
    ScreenedFisherWave,
    SimulationRunner,
    SurfactantNutrientWave,
)
from lb2d_tpu_torch.models.diffusion import (
    DIFFUSION_TEMPORAL_K,
    NOISY_TEMPORAL_K,
)
from lb2d_tpu_torch.models.multifield import (
    EXPANSION_TEMPORAL_K,
    FISHER_TEMPORAL_K,
)
from lb2d_tpu_torch.models.pipe_flow import TEMPORAL_K, VELOCITY_TEMPORAL_K
from lb2d_tpu_torch.ops import _build, band_plan, fused
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
    resident_diffusion_run,
    resident_pipe_run,
    resident_velocity_run,
    temporal_diffusion_step,
    temporal_multifield_step,
    temporal_pipe_step,
    temporal_velocity_step,
    velocity_step_reference,
)
from lb2d_tpu_torch.ops.fused_coupled import (
    COUPLED_TEMPORAL_K,
    coupled_density,
    coupled_density_halo,
    coupled_max_k,
    coupled_params,
    coupled_sweep,
    coupled_sweep_halo,
    coupled_sweep_halo_reference,
    coupled_sweep_reference,
    _coupled_cell_step,
    _coupled_cell_step_halo,
)
from lb2d_tpu_torch.ops.fused_halo import (
    HALO_TEMPORAL_K,
    Halo,
    temporal_halo_step,
    temporal_halo_step_reference,
)
from lb2d_tpu_torch.ops.fused_mc import (
    mc_density,
    mc_density_halo,
    mc_density_halo_reference,
    mc_density_reference,
    mc_params,
    mc_step,
    mc_step_halo,
    mc_step_halo_reference,
    mc_step_reference,
    shard_cells,
)
from lb2d_tpu_torch.ops import moments
from lb2d_tpu_torch.ops.equilibrium import feq_quadratic
from lb2d_tpu_torch.ops.moments import density, flow_moments
from lb2d_tpu_torch.ops.spectral import (
    dft_axis0,
    dft_axis0_reference,
    screened_gradients,
    screened_gradients_passes,
    screened_gradients_reference,
    solve_launches,
    solve_plan,
    spectral_grids,
)
from lb2d_tpu_torch.ops.random import (
    normals,
    normals_per_cell,
    normals_reference,
    philox4x32_10,
    philox_bits,
    philox_key,
)
from lb2d_tpu_torch.ops.transpose import transpose, transpose_reference
from lb2d_tpu_torch.parallel import (
    ShardedCoupled,
    ShardedDiffusion,
    ShardedMultifield,
    ShardedPipeFlow,
    make_mesh,
)
from lb2d_tpu_torch.parallel.halo import (
    exchange_bands,
    exchange_halos,
    gather_bands,
)
from lb2d_tpu_torch.utils import (
    accumulated_sum,
    render_field,
    restore_model,
    save_model,
)

BENCH_PHYS = dict(diameter=1.0, rho=1.0, viscosity=0.1, pressure_grad=-0.01,
                  pipe_length=1.0)   # bench.py's workload, N=4095 -> 4096^2
POISEUILLE = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
                  pipe_length=3.0)   # tests/test_pipe_flow.py
SMALL = dict(POISEUILLE, pipe_length=1.5 * 254.5 / 31)  # N=31 -> 32x256,
# the reference's launch-bound benchmark grid (benchmarks/run_all.py)
CYLINDER = dict(diameter=1.0, rho=1.0, viscosity=1.0, pressure_grad=-10.0,
                pipe_length=3.0, cylinder_center=(0.75, 0.5),
                cylinder_radius=0.1)  # examples/backend_comparison.py
# the diffusion slice's workloads, at the sizes the reference runs them
ADVECTION = dict(N=341, z=0.1, D=0.005, vx=1.0, vy=0.0, vc=1.0, Lx=0.61,
                 Ly=0.61)   # 2048^2, benchmarks/run_all.py:93
STOCHASTIC = dict(N=341, z=0.1, Lx=0.61, Ly=0.61, g=1.0, vx=1.0, vy=1.0,
                  vc=1.0, Dg=0.05)  # 2048^2, examples/zoo_drive.py:80-83
NOISY_WAVE = dict(N=127, z=0.1, D=1.0, g=50.0, Nc=10.0, Lx=0.202,
                  Ly=0.202)  # 256^2, benchmarks/tpu_tests.py:87
REACTION = dict(N=170, g=5.0, z=0.1, D=0.01, vx=1.0, vy=0.5, vc=1.0,
                Lx=0.302, Ly=0.302)  # 512^2, benchmarks/profile_r4.py:65-70
# the multifield slice's workloads, at the sizes the reference runs them
FISHER_EXP = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 1.0],
                  D_standard=1.0, D_list=[1.0, 1.0], N=1023,
                  initial_frac_widths=[0.5, 0.5],
                  initial_frac_indices=[0, 1])  # 2048^2, run_all.py:100-110
EXPANSION = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
                 D_standard=1.0, D_list=[1.0, 1.2], N=511, Nb=10.0,
                 Dc=1.0)  # 1024^2, benchmarks/profile_r4.py:38-48
KERNEL_TOL = 1e-6   # ~30 ulp at |f| <= 0.45: nvcc's FMA contraction; the
# noisy kernels too: their Philox bits are exact, their normals a few ulp off
NORMALS_TOL = 5e-6  # |eta| < 6: the card's logf/cosf against torch's
BYTES_PER_CELL = 72  # 9 float32 reads + 9 writes per cell-step
MAIN_STEPS = 1000    # 4096^2: 250 K2 launches of TEMPORAL_K = 4 steps
SMALL_STEPS = 20000  # 32x256: one K3 launch
KERNEL_STEPS = 100   # 4096^2 through backend="kernel": 100 K1 launches
INLET_STEPS = 1000   # 401x401 velocity inlet: 125 K2 launches of
# VELOCITY_TEMPORAL_K = 8 steps, or one K3
DIFFUSION_STEPS = 2000  # 2048^2: run_all.py's step count
RESIDENT_DIFFUSION_STEPS = 20000  # 256^2 and 512^2: one K3 launch each
RESIDENT_CHECK_STEPS = (8, 9)  # both parities of K3's exchange slots
# K3's ragged cuts: 4 bands in one cluster; 18 uneven bands through
# scratch; rows too wide for bands, 128 strips of columns through scratch
K3_RAGGED = ((31, 61), (133, 67), (16, 4096))
FISHER_STEPS = 1000     # 2048^2 FisherExpansion
EXPANSION_STEPS = 2048  # 1024^2 Expansion, profile_r4.py's step count
BAND_LAUNCHES = 100     # K5 on the Expansion's seam band
MC_CHECK_STEPS = 5      # K6 against the plain step, from one state
MC_BIG_STEPS = 100      # the 8192^2 porous runner
MC_SPINODAL_STEPS = 1000  # the 1024^2 spinodal decomposition
MC_Q25_STEPS = 200      # the 1024^2 D2Q25 runner
MC_LEAST_BYTES = 144    # K6's step: f of 2 D2Q9 fluids read and written once
MC_TWO_PASS_BYTES = 232  # mc_density (80) + mc_step (152)
# the spectral slice: BASELINE config 5 (benchmarks/c5_one.py) and the
# coupled models at examples/zoo_drive.py's "big" sizes
C5_LAM, C5_AMP = 10.0, 1e-4  # its interaction length and amplitude
C5_STEPS = 100          # the 8192^2 config-5 runs, exact and stale_force=8
C5_STALE = 8
C5_CHECK_STEPS = 3      # K6 + K8 against the eager step at 8192^2
K8_TOL = 1e-5           # of max |g|: two float32 FFTs, sums in other orders
K8_PASS_TOL = 1e-6      # of the scale: the 1-D pass against torch.fft.fft
K8_SHAPES = ((8192, 8192), (1024, 1024), (512, 512), (48, 48), (50, 50),
             (45, 64), (127, 250), (8191, 16))  # the main paths' grids
# (the tiled plan's four-step and one-launch columns), mixed radices, an
# odd row count, and primes (the whole-line kernel)
COUPLED_STEPS = 256     # each coupled model's run (64 launches at K = 4)
SCREENED_FISHER = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=1024)
SURFACTANT = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=512)
CLUMPY = dict(SURFACTANT, rho_o=1.0, G_chen=-5.0)
ROCKET = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=1024,
              G_chen=-0.1)
ROCKET_FORCES = dict(ROCKET, c_o=0.25, alpha=2.0)  # rocket yeast's recipe
# operations per cell of one K7 step, counted from its arithmetic (expf and
# divisions as one): per field and direction the linear feq and BGK (10),
# the densities (8 per field), the stencils (2 per neighbour term, 5 for a
# psi or S), growth and forces
COUPLED_OPS = {"screened_fisher": 110, "surfactant": 210,
               "clumpy_surfactant": 310, "rocket_yeast": 330,
               "rocket_yeast_forces_only": 290}
STEP0 = 2**32 - 3   # a global step whose K steps cross the counter's high word
H100_SXM = "H100 80GB HBM3"
H100_SXM_HBM = 3.35e12  # B/s, NVIDIA's H100 SXM data sheet
H100_SXM_FP32 = 67e12   # FLOP/s outside the tensor cores, the same data sheet
# operations per cell-step, counted from the kernels' arithmetic (integer
# Philox operations and logf/sqrtf/cosf counted as one each at the float32
# rate, which only lowers the bound)
FLOW_OPS = 150        # BCs, 3 moments, 9 x (feq + BGK)
DIFFUSION_OPS = 95    # density, growth, 9 x (linear feq + BGK + source)
NOISY_OPS = 220       # + noise, clip, 10 Philox rounds, Box-Muller
NORMAL_OPS = 112      # 10 Philox rounds (8 ops + 2 key adds), Box-Muller
FIELD_OPS = 70        # per field: walls, density, 9 x (linear feq + BGK + source)
POPULATION_NOISE_OPS = 70  # per noisy population: half a Philox call, one
# Box-Muller normal, the Milstein term and the clips


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test runs only on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if H100_SXM not in torch.cuda.get_device_name(0):
        raise RuntimeError(f"the roofline below assumes an {H100_SXM} (SXM) "
                           "card")
    return card


def build_phase():
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}",
          flush=True)


def _events_ms(fn, n):
    """Mean device time of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(fn, per_graph=20, replays=20):
    """Device time of one ``fn`` by CUDA-graph replay: ``per_graph`` calls
    captured in one graph (after a warm call outside it), the graph
    replayed ``replays`` times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    return _events_ms(graph.replay, replays) / per_graph


def _disk(ny, nx):
    Y, X = np.mgrid[:ny, :nx]
    return ((X - nx / 3) ** 2 + (Y - ny / 2) ** 2 <= (ny / 6) ** 2
            ).astype(np.int32)


def _inputs(sim, obstacle):
    """The model's state with a 1% perturbation (numpy seed 0), and the
    kernel arguments of its step."""
    rng = np.random.RandomState(0)
    f0 = sim.state * torch.tensor(
        (1 + 0.01 * rng.randn(9, sim.ny, sim.nx)).astype(np.float32),
        device="cuda")
    if obstacle is True:
        mask = torch.tensor(_disk(sim.ny, sim.nx), device="cuda")
    else:
        mask = obstacle  # None or the model's own mask
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho,
              incompressible=sim.equilibrium == "incompressible", mask=mask)
    return f0, kw


def _max_diff(a, b):
    torch.cuda.synchronize()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("non-finite populations in the comparison")
    return float((a - b).abs().max())


def compare_k1(sim, obstacle, steps=4):
    f0, kw = _inputs(sim, obstacle)
    a, spare = f0.clone(), torch.empty_like(f0)
    for _ in range(steps):
        a, spare = pipe_step(a, spare, **kw), a
    return _max_diff(a, pipe_run_reference(f0, steps, **kw))


def compare_k2(sim, obstacle, k=TEMPORAL_K):
    f0, kw = _inputs(sim, obstacle)
    out = temporal_pipe_step(f0, torch.empty_like(f0), k, **kw)
    return _max_diff(out, pipe_run_reference(f0, k, **kw))


def compare_k3(sim, obstacle, n):
    f0, kw = _inputs(sim, obstacle)
    f = f0.clone()
    resident_pipe_run(f, torch.empty_like(f), n, **kw)
    return _max_diff(f, pipe_run_reference(f0, n, **kw))


def _velocity_run(f, k, kw):
    for _ in range(k):
        f = velocity_step_reference(f, **kw)
    return f


def compare_k2_velocity(sim, obstacle, outlet, incompressible, k):
    """K2 with the velocity BCs against ``k`` plain velocity-inlet steps."""
    f0, kw = _inputs(sim, obstacle)
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=outlet,
              incompressible=incompressible, mask=kw["mask"])
    out = temporal_velocity_step(f0, torch.empty_like(f0), k, **kw)
    want = f0
    for _ in range(k):
        want = velocity_step_reference(want, **kw)
    return _max_diff(out, want)


def _checked(label, d):
    print(f"{label}: max|df| = {d:.3e}", flush=True)
    if not d <= KERNEL_TOL:
        raise RuntimeError(f"{label}: kernel disagrees, {d} > {KERNEL_TOL}")
    return d


def _checked_ks(label, compare, tol=KERNEL_TOL, ks=None):
    """``compare(k)`` (a max |df|) at every K from 1 to MAX_TEMPORAL_K (or
    ``ks``), on one line; raise above ``tol``. Returns the largest."""
    ds = {k: compare(k) for k in (ks or range(1, MAX_TEMPORAL_K + 1))}
    d = max(ds.values())
    print(f"{label}, K={min(ds)}..{max(ds)}: max|df| = {d:.3e} (limit "
          f"{tol:g}; per K " + " ".join(f"{v:.1e}" for v in ds.values())
          + ")", flush=True)
    if not d <= tol:
        raise RuntimeError(f"{label}: kernel disagrees, {d} > {tol}")
    return d


# K2's row sweep at every K on grids narrower than one strip (45x33: one
# strip wrapping onto itself), with fewer rows than the card's segments
# (7x300), ragged strips and segments (254x254, 401x401 and the cylinder's
# 3751x1251), and the main path's 4096^2
K2_SHAPES = ((254, 254), (401, 401), (45, 33), (7, 300))


def _flow_inputs(ny, nx, incompressible, obstacle):
    """A random state near rest (numpy seed 0) and the kernel arguments of
    a pressure-driven step, with a disk obstacle or none."""
    rng = np.random.RandomState(0)
    w = np.asarray(D2Q9.w)[:, None, None]
    f0 = torch.tensor(w * (1 + 0.01 * rng.randn(9, ny, nx)),
                      dtype=torch.float32, device="cuda")
    mask = torch.tensor(_disk(ny, nx), device="cuda") if obstacle else None
    kw = dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0,
              incompressible=incompressible, mask=mask)
    return f0, kw


def kernel_phase(main, small, cyl, inlet):
    """Each kernel against its plain version at the main path's shapes (and
    its four variants at an unaligned grid); K2 at every K from 1 to
    MAX_TEMPORAL_K, per physics, also at K2_SHAPES. Returns max |df| per
    kernel."""
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K2v": 0.0}
    for eq in ("compressible", "incompressible"):
        sim = PipeFlow(N=253, pipe_length=380.5 / 253, equilibrium=eq,
                       diameter=1.0, rho=10.0, viscosity=5.0,
                       pressure_grad=-100.0, device="cuda")
        assert (sim.ny, sim.nx) == (254, 382)
        tiny = PipeFlow(N=31, equilibrium=eq, device="cuda", **SMALL)
        for obstacle in (False, True):
            tag = f"{eq} obstacle={obstacle}"
            worst["K1"] = max(worst["K1"], _checked(
                f"K1 vs plain 254x382 {tag}, 4 steps",
                compare_k1(sim, obstacle or None)))
            worst["K2"] = max(worst["K2"], _checked_ks(
                f"K2 vs plain 254x382 {tag}",
                lambda k: compare_k2(sim, obstacle or None, k)))
            for ny, nx in K2_SHAPES:
                f0, kw = _flow_inputs(ny, nx, eq == "incompressible",
                                      obstacle)
                worst["K2"] = max(worst["K2"], _checked_ks(
                    f"K2 vs plain {ny}x{nx} random {tag}",
                    lambda k: _max_diff(temporal_pipe_step(
                        f0, torch.empty_like(f0), k, **kw),
                        pipe_run_reference(f0, k, **kw))))
            for n in RESIDENT_CHECK_STEPS:
                worst["K3"] = max(worst["K3"], _checked(
                    f"K3 vs plain 32x256 {tag}, {n} steps",
                    compare_k3(tiny, obstacle or None, n)))
                for ny, nx in K3_RAGGED:
                    f0, kw = _flow_inputs(ny, nx, eq == "incompressible",
                                          obstacle)
                    f = f0.clone()
                    resident_pipe_run(f, torch.empty_like(f), n, **kw)
                    worst["K3"] = max(worst["K3"], _checked(
                        f"K3 vs plain {ny}x{nx} random {tag}, {n} steps",
                        _max_diff(f, pipe_run_reference(f0, n, **kw))))
    n = f"{main.ny}x{main.nx} compressible"
    worst["K1"] = max(worst["K1"], _checked(
        f"K1 vs plain {n}, 4 steps", compare_k1(main, None)))
    cyl_mask = cyl.obstacle_mask.to(torch.int32)
    worst["K2"] = max(worst["K2"], _checked_ks(
        f"K2 vs plain {n}", lambda k: compare_k2(main, None, k)))
    worst["K2"] = max(worst["K2"], _checked_ks(
        f"K2 vs plain cylinder {cyl.ny}x{cyl.nx}",
        lambda k: compare_k2(cyl, cyl_mask, k)))
    for n in RESIDENT_CHECK_STEPS:
        worst["K3"] = max(worst["K3"], _checked(
            f"K3 vs plain {small.ny}x{small.nx} model state, {n} steps",
            compare_k3(small, None, n)))
    # as the wrapper picks (tiles up to VELOCITY_TILE_MAX_CELLS cells, the
    # sweep above), then the sweep on every grid
    worst["K2v"] = _k2_velocity_checks(inlet, "tiles or the sweep")
    tiles_max = fused.VELOCITY_TILE_MAX_CELLS
    fused.VELOCITY_TILE_MAX_CELLS = 0
    try:
        worst["K2v"] = max(worst["K2v"], _k2_velocity_checks(
            inlet, "the sweep"))
    finally:
        fused.VELOCITY_TILE_MAX_CELLS = tiles_max
    return worst


# K2's velocity inlet also on a grid above VELOCITY_TILE_MAX_CELLS
INLET_SHAPES = K2_SHAPES + ((1031, 1100),)


def _k2_velocity_checks(inlet, loop):
    """K2's velocity inlet against its plain steps at every K, with both
    outlets, both equilibria, with and without the obstacle, on the inlet's
    state and at INLET_SHAPES; returns the largest max |df|."""
    worst = 0.0
    for outlet in ("zero_gradient", "velocity"):
        for incompressible in (False, True):
            for obstacle in (False, True):
                tag = (f"outlet={outlet} incompressible={incompressible} "
                       f"obstacle={obstacle}, {loop}")
                worst = max(worst, _checked_ks(
                    f"K2 velocity inlet vs plain {inlet.ny}x{inlet.nx} {tag}",
                    lambda k: compare_k2_velocity(
                        inlet, obstacle or None, outlet, incompressible, k)))
                for ny, nx in INLET_SHAPES:
                    f0, kw = _flow_inputs(ny, nx, incompressible, obstacle)
                    kw = dict(omega=inlet.omega, u_w=inlet.u_w,
                              u_e=inlet.u_e, outlet=outlet,
                              incompressible=incompressible, mask=kw["mask"])
                    worst = max(worst, _checked_ks(
                        f"K2 velocity inlet vs plain {ny}x{nx} random {tag}",
                        lambda k: _max_diff(temporal_velocity_step(
                            f0, torch.empty_like(f0), k, **kw),
                            _velocity_run(f0, k, kw))))
    return worst


def timing_phase(main, small, inlet):
    """Device time of one launch of each kernel at the main path's shapes
    and of the plain version doing the same steps, by CUDA events, plus a
    device-to-device copy as the practical bandwidth ceiling. Launches here
    are not main-path launches."""
    kw = dict(omega=main.omega, inlet_rho=main.inlet_rho,
              outlet_rho=main.outlet_rho, incompressible=False)
    bufs = [main.state.clone(), torch.empty_like(main.state)]

    def k1():
        pipe_step(bufs[0], bufs[1], **kw)
        bufs.reverse()

    def k2():
        temporal_pipe_step(bufs[0], bufs[1], TEMPORAL_K, **kw)
        bufs.reverse()

    def plain(n):
        def run():
            bufs[0] = pipe_run_reference(bufs[0], n, **kw)
        return run

    times = {}
    for name, fn, reps in (("K1", k1, 200), ("K2", k2, 100)):
        fn()
        times[name] = _events_ms(fn, reps)
    plain(1)()
    times["plain K1"] = _events_ms(plain(1), 10)
    times["plain K2"] = _events_ms(plain(TEMPORAL_K), 4)
    src, dst = main.state, torch.empty_like(main.state)
    dst.copy_(src)
    copy_ms = _events_ms(lambda: dst.copy_(src), 50)
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    del bufs, dst

    n = 1000
    kw = dict(omega=small.omega, inlet_rho=small.inlet_rho,
              outlet_rho=small.outlet_rho, incompressible=False)
    f, scratch = small.state.clone(), torch.empty_like(small.state)
    resident_pipe_run(f, scratch, n, **kw)
    times["K3"] = _events_ms(lambda: resident_pipe_run(f, scratch, n, **kw), 5)
    g = [small.state.clone()]

    def plain_small():
        g[0] = pipe_run_reference(g[0], n, **kw)

    plain_small()
    times["plain K3"] = _events_ms(plain_small, 2)

    kw = dict(omega=inlet.omega, u_w=inlet.u_w, u_e=inlet.u_e,
              outlet=inlet.outlet, incompressible=False)
    bufs = [inlet.state.clone(), torch.empty_like(inlet.state)]
    k_inlet = VELOCITY_TEMPORAL_K

    def k2v():
        temporal_velocity_step(bufs[0], bufs[1], k_inlet, **kw)
        bufs.reverse()

    def plain_inlet():
        for _ in range(k_inlet):
            bufs[0] = velocity_step_reference(bufs[0], **kw)

    k2v()
    times["K2v"] = _events_ms(k2v, 200)
    # the kernel's own time: a launch at 401^2 is about as short as the
    # host's launch, so events around host launches also time the host
    graph_ms = _graph_ms(k2v)
    print(f"K2v at {inlet.ny}x{inlet.nx}: {graph_ms:.4f} ms per launch of "
          f"{k_inlet} steps by CUDA-graph replay, "
          f"{times['K2v']:.4f} by CUDA events", flush=True)
    plain_inlet()
    times["plain K2v"] = _events_ms(plain_inlet, 10)
    steps = {"K1": 1, "K2": TEMPORAL_K, "K3": n, "K2v": k_inlet}
    for k in ("K1", "K2", "K3", "K2v"):
        sim = {"K3": small, "K2v": inlet}.get(k, main)
        shape = f"{sim.ny}x{sim.nx}"
        print(f"{k} at {shape}: {times[k]:.4f} ms per launch of {steps[k]} "
              f"step(s); plain version {times['plain ' + k]:.4f} ms for the "
              f"same steps (CUDA events)", flush=True)
    print(f"copy_ of {src.numel() * 4 / 1e6:.0f} MB: {copy_ms:.4f} ms = "
          f"{copy_bw / 1e12:.3f} TB/s", flush=True)
    return times, steps, copy_bw


COUNTERS = {"K1": pipe_step, "K2": temporal_pipe_step,
            "K3": resident_pipe_run, "K2v": temporal_velocity_step,
            "K3v": resident_velocity_run,
            "K2 diffusion family": temporal_diffusion_step,
            "K3 diffusion family": resident_diffusion_run, "P1": normals,
            "P1 per cell": normals_per_cell, "philox_bits": philox_bits,
            "K4": temporal_multifield_step,
            "K5": expansion_band_step, "K6d": mc_density, "K6s": mc_step,
            "K7": coupled_sweep, "K8": screened_gradients,
            "K8 pass": dft_axis0, "K9": temporal_halo_step,
            "K6hd": mc_density_halo, "K6hs": mc_step_halo,
            "K7h": coupled_sweep_halo, "P2": transpose, "M": flow_moments}


def _window(label, drive, expected):
    """Drive one main path with every launch count set to 0 just before it;
    read the counts just after and require exactly ``expected``."""
    torch.cuda.synchronize()
    for wrapper in COUNTERS.values():
        wrapper.launches = 0
    drive()
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in COUNTERS.items()}
    want = {name: expected.get(name, 0) for name in COUNTERS}
    print(f"{label}: launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected {expected})",
          flush=True)
    if counts != want or min(expected.values()) < 1:
        raise RuntimeError(f"{label}: kernel launches {counts} != {want}")
    return counts


def main_path_phase(main, small, inlet, card, times, copy_bw):
    """The user's path: ``run(n, timed=True)`` on the models that
    ``backend="auto"`` built, with every kernel's launch count read around
    it."""
    main.run(2 * TEMPORAL_K + 1)  # warm every kernel this path launches
    small.run(10)
    inlet.run(VELOCITY_TEMPORAL_K + 1)

    def drive():
        main.run(1)  # one step short of a K2 launch: a K2 launch of 1 step
        main.run(MAIN_STEPS, timed=True)
        small.run(SMALL_STEPS, timed=True)
        inlet.run(INLET_STEPS, timed=True)

    expected = {"K2": 1 + -(-MAIN_STEPS // TEMPORAL_K), "K3": 1,
                "K2v": -(-INLET_STEPS // VELOCITY_TEMPORAL_K)}
    counts = _window("main path (flow)", drive, expected)
    launches = {k: counts[k] for k in expected}
    # K1 is the path of backend="kernel" only, asked for by name
    one = PipeFlow(N=4095, device="cuda", backend="kernel", **BENCH_PHYS)
    one.run(2)
    launches["K1"] = _window(
        f'main path (backend="kernel") {one.ny}x{one.nx}',
        lambda: one.run(KERNEL_STEPS, timed=True),
        {"K1": KERNEL_STEPS})["K1"]
    print(f"main path PipeFlow {one.ny}x{one.nx} backend=kernel: "
          f"{one.last_mlups:.1f} MLUPS over {KERNEL_STEPS} steps; card: "
          f"{card}", flush=True)
    if not torch.isfinite(one.state).all():
        raise RuntimeError("non-finite state after backend='kernel'")
    del one
    for sim in (main, small, inlet):
        if not torch.isfinite(sim.state).all():
            raise RuntimeError("non-finite state after the main path")
        fields = (sim.get_fields() if sim is inlet
                  else sim.get_physical_fields())
        if (fields["u"].shape != (sim.nx, sim.ny)
                or not np.isfinite(fields["u"]).all()):
            raise RuntimeError("bad physical fields after the main path")

    plain = PipeFlow(N=4095, device="cuda", backend="eager", **BENCH_PHYS)
    plain.run(2)
    plain.run(20, timed=True)
    plain_small = PipeFlow(N=31, device="cuda", backend="eager", **SMALL)
    plain_small.run(20)
    plain_small.run(500, timed=True)
    plain_inlet = PipeFlowVelocityInlet(device="cuda", backend="eager")
    plain_inlet.run(20)
    plain_inlet.run(200, timed=True)
    for sim, ref, steps in ((main, plain, MAIN_STEPS),
                            (small, plain_small, SMALL_STEPS),
                            (inlet, plain_inlet, INLET_STEPS)):
        print(f"main path {type(sim).__name__} {sim.ny}x{sim.nx} "
              f"backend={sim.backend}: "
              f"{sim.last_mlups:.1f} MLUPS over {steps} steps; plain (eager) "
              f"{ref.last_mlups:.1f} MLUPS; card: {card}", flush=True)
    equiv = main.last_mlups * 1e6 * BYTES_PER_CELL
    k1_bw = main.num_cells * BYTES_PER_CELL / (times["K1"] * 1e-3)
    print(f"4096^2 at {BYTES_PER_CELL} B/cell-step: the main path's "
          f"single-step-equivalent traffic {equiv / 1e12:.3f} TB/s = "
          f"{equiv / H100_SXM_HBM:.3f} of the {H100_SXM_HBM / 1e12:.2f} TB/s "
          f"data sheet (K2 moves fewer bytes per step); K1 alone "
          f"{k1_bw / 1e12:.3f} TB/s = {k1_bw / H100_SXM_HBM:.3f} of the data "
          f"sheet, {k1_bw / copy_bw:.3f} of the measured copy_; card: {card}",
          flush=True)
    del plain, plain_small, plain_inlet
    return launches


def physics_phase(cyl):
    for backend in ("resident", "temporal", "kernel"):
        sim = PipeFlow(N=10, device="cuda", backend=backend, **POISEUILLE)
        sim.run(int(10.0 / sim.units.delta_t))
        mean_u = sim.get_physical_fields()["u"].T.mean(axis=1)
        y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
        predicted = ((1.0 / (2 * POISEUILLE["rho"] * POISEUILLE["viscosity"]))
                     * POISEUILLE["pressure_grad"] * y
                     * (y - POISEUILLE["diameter"]))
        err = float(np.sqrt(((mean_u - predicted) ** 2).mean()))
        print(f"Poiseuille N=10 through backend={backend}: RMS error "
              f"{err:.5f} (u_max {predicted.max():.4f}, limit 5%)", flush=True)
        if not err < 0.05 * 0.5625:
            raise RuntimeError(f"Poiseuille RMS error {err} >= 5% of u_max")

    rho_before = float(cyl.device_field("rho").mean())
    cyl.run(200)
    rho = cyl.device_field("rho")
    drift = abs(float(rho.mean()) - rho_before)
    print(f"cylinder {cyl.ny}x{cyl.nx} backend={cyl.backend} 200 steps: mean "
          f"rho drift {drift:.3e}", flush=True)
    if not (torch.isfinite(rho).all() and drift < 0.1):
        raise RuntimeError("cylinder run is not finite or lost mass")


# -- the diffusion slice ---------------------------------------------------

def _random_state(ny, nx):
    """f = w rho (1 + 1% noise) with rho uniform in [0.1, 0.9] (numpy seed
    1): noise of full amplitude in every cell."""
    rng = np.random.RandomState(1)
    rho = 0.1 + 0.8 * rng.rand(ny, nx)
    w = np.asarray(D2Q9.w)[:, None, None]
    return torch.tensor(w * rho * (1.0 + 0.01 * rng.randn(9, ny, nx)),
                        dtype=torch.float32, device="cuda")


def compare_k2_diffusion(kw, f0, k):
    out = temporal_diffusion_step(f0, torch.empty_like(f0), k, step0=STEP0,
                                  **kw)
    return _max_diff(out, diffusion_run_reference(f0, k, step0=STEP0, **kw))


def compare_k3_diffusion(kw, f0, n):
    f = f0.clone()
    resident_diffusion_run(f, torch.empty_like(f), n, step0=STEP0, **kw)
    return _max_diff(f, diffusion_run_reference(f0, n, step0=STEP0, **kw))


def compare_k3_velocity(sim, obstacle, outlet, incompressible, n,
                        shape=None):
    """K3's velocity inlet against its plain steps on ``sim``'s state, or
    on a random state of ``shape`` with ``sim``'s constants."""
    if shape is None:
        f0, kw = _inputs(sim, obstacle)
    else:
        f0, kw = _flow_inputs(*shape, incompressible, obstacle)
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=outlet,
              incompressible=incompressible, mask=kw["mask"])
    f = f0.clone()
    resident_velocity_run(f, torch.empty_like(f), n, **kw)
    want = f0
    for _ in range(n):
        want = velocity_step_reference(want, **kw)
    return _max_diff(f, want)


def compare_normals(seed, step, ny, nx):
    """P1 against the plain Philox: the words bit for bit, and the normals
    bit for bit against P1's first one-cell-a-thread loop (returns the
    normals' max |d| from the plain version)."""
    cell = torch.arange(ny * nx, dtype=torch.int64, device="cuda")
    want = philox4x32_10((cell, step & 0xFFFFFFFF, step >> 32, 0),
                         philox_key(seed))
    if not torch.equal(philox_bits(seed, step, ny * nx, "cuda"), want):
        raise RuntimeError("P1: the Philox words differ from the plain ones")
    eta = normals(seed, step, (ny, nx), "cuda")
    if not torch.equal(eta, normals_per_cell(seed, step, (ny, nx), "cuda")):
        raise RuntimeError("P1: the normals differ from the one-cell-a-"
                           "thread loop's")
    return _max_diff(eta, normals_reference(seed, step, ny, nx, "cuda"))


def diffusion_kernel_phase(adv, sto, wave, rad, inlet):
    """Each new kernel against its plain version: at the main path's models
    and shapes (from step STEP0, noise on), and on random densities at an
    unaligned grid with the stochastic model's noise amplitude."""
    worst = dict.fromkeys(("K2d", "K2n", "K3d", "K3n", "K3v", "P1"), 0.0)

    def check(key, label, d, tol=KERNEL_TOL):
        print(f"{label}: max|d| = {d:.3e}", flush=True)
        if not d <= tol:
            raise RuntimeError(f"{label}: kernel disagrees, {d} > {tol}")
        worst[key] = max(worst[key], d)

    for key, sim in (("K2d", adv), ("K2n", sto)):
        kw = sim.step_kwargs()
        # bit for bit: the update rounds every operation alone
        worst[key] = max(worst[key], _checked_ks(
            f"{key} vs plain {sim.ny}x{sim.nx} model state",
            lambda k: compare_k2_diffusion(kw, sim.state, k), tol=0.0))
        for ny, nx in ((254, 382),) + K2_SHAPES:
            rand = _random_state(ny, nx)
            worst[key] = max(worst[key], _checked_ks(
                f"{key} vs plain {ny}x{nx} random rho",
                lambda k: compare_k2_diffusion(
                    dict(kw, **_noise_of(sto, key)), rand, k), tol=0.0))
    for key, sim in (("K3d", rad), ("K3n", wave)):
        kw = sim.step_kwargs()
        noisy_kw = dict(kw, **_noise_of(sto, key))
        for n in RESIDENT_CHECK_STEPS:
            # bit for bit, as K2: the update rounds every operation alone
            check(key, f"{key} vs plain {sim.ny}x{sim.nx} model state, n={n}",
                  compare_k3_diffusion(kw, sim.state, n), 0.0)
            for ny, nx in ((sim.ny, sim.nx),) + K3_RAGGED:
                check(key, f"{key} vs plain {ny}x{nx} random rho, n={n}",
                      compare_k3_diffusion(noisy_kw, _random_state(ny, nx),
                                           n), 0.0)
    for outlet in ("zero_gradient", "velocity"):
        for incompressible in (False, True):
            for obstacle in (False, True):
                for n in RESIDENT_CHECK_STEPS:
                    for shape in (None,) + K3_RAGGED:
                        at = (f"{inlet.ny}x{inlet.nx}" if shape is None
                              else f"{shape[0]}x{shape[1]} random")
                        check("K3v", f"K3 velocity inlet vs plain {at} "
                              f"outlet={outlet} "
                              f"incompressible={incompressible} "
                              f"obstacle={obstacle}, n={n}",
                              compare_k3_velocity(inlet, obstacle or None,
                                                  outlet, incompressible, n,
                                                  shape))
    for step in (0, 5, STEP0 + 4):  # STEP0 + 4 = 2^32 + 1
        for ny, nx in ((sto.ny, sto.nx), (2049, 7), (3, 5)):
            check("P1", f"P1 vs plain {ny}x{nx} step {step} (words and the "
                  "one-cell-a-thread loop's normals equal)",
                  compare_normals(sto.rng_seed, step, ny, nx), NORMALS_TOL)
    return worst


def _noise_of(sto, key):
    """The stochastic model's noise for the noisy kernels' random-density
    checks (none for the deterministic ones)."""
    if key in ("K2n", "K3n"):
        return dict(lb_Dg=sto.Dg, noisy=True, seed=sto.rng_seed)
    return {}


def k_sweep_phase(main, adv, sto, card):
    """Device ms per step of K2 at K = 1..MAX_TEMPORAL_K for the flow at the
    main path's 4096^2 and each diffusion physics at its 2048^2 (CUDA
    events, 50 launches each)."""
    best = {}
    flow = dict(omega=main.omega, inlet_rho=main.inlet_rho,
                outlet_rho=main.outlet_rho, incompressible=False)
    for label, sim in (("flow", main), ("diffusion", adv),
                       ("noisy_fisher", sto)):
        kw = sim.step_kwargs() if sim is not main else flow
        bufs = [sim.state.clone(), torch.empty_like(sim.state)]
        per_step = {}
        for k in range(1, MAX_TEMPORAL_K + 1):
            def launch(k=k):
                if sim is main:
                    temporal_pipe_step(bufs[0], bufs[1], k, **kw)
                else:
                    temporal_diffusion_step(bufs[0], bufs[1], k, step0=STEP0,
                                            **kw)
                bufs.reverse()

            launch()
            per_step[k] = _events_ms(launch, 50) / k
        best[label] = min(per_step, key=per_step.get)
        model_k = TEMPORAL_K if sim is main else sim.temporal_k
        print(f"K sweep, K2 {label} at {sim.ny}x{sim.nx}, ms per step: "
              + ", ".join(f"K={k} {t:.5f}" for k, t in per_step.items())
              + f"; fastest K={best[label]} (model uses "
              f"K={model_k}); card: {card}", flush=True)
        del bufs
    return best


def diffusion_timing_phase(adv, sto, wave, rad, inlet):
    """Device time per launch of each new kernel at the main path's shapes
    and of the plain version doing the same work (CUDA events)."""
    times, steps = {}, {}
    for key, sim in (("K2d", adv), ("K2n", sto)):
        kw, k = sim.step_kwargs(), sim.temporal_k
        bufs = [sim.state.clone(), torch.empty_like(sim.state)]

        def k2():
            temporal_diffusion_step(bufs[0], bufs[1], k, step0=STEP0, **kw)
            bufs.reverse()

        def plain():
            bufs[0] = diffusion_run_reference(bufs[0], k, step0=STEP0, **kw)

        k2()
        times[key] = _events_ms(k2, 100)
        plain()
        times["plain " + key] = _events_ms(plain, 4)
        steps[key] = k
        del bufs
    n = 1000
    for key, sim in (("K3d", rad), ("K3n", wave)):
        kw = sim.step_kwargs()
        f, scratch = sim.state.clone(), torch.empty_like(sim.state)
        resident_diffusion_run(f, scratch, n, step0=STEP0, **kw)
        times[key] = _events_ms(
            lambda: resident_diffusion_run(f, scratch, n, step0=STEP0, **kw),
            5)
        g = [sim.state.clone()]

        def plain_run(m):
            g[0] = diffusion_run_reference(g[0], m, step0=STEP0, **kw)

        plain_run(10)
        times["plain " + key] = _events_ms(lambda: plain_run(n), 1)
        steps[key] = n
    kw = dict(omega=inlet.omega, u_w=inlet.u_w, u_e=inlet.u_e,
              outlet=inlet.outlet, incompressible=False)
    f, scratch = inlet.state.clone(), torch.empty_like(inlet.state)
    resident_velocity_run(f, scratch, n, **kw)
    times["K3v"] = _events_ms(
        lambda: resident_velocity_run(f, scratch, n, **kw), 5)
    g = [inlet.state.clone()]

    def plain_inlet(m):
        for _ in range(m):
            g[0] = velocity_step_reference(g[0], **kw)

    plain_inlet(10)
    times["plain K3v"] = _events_ms(lambda: plain_inlet(n), 1)
    steps["K3v"] = n
    shape = (sto.ny, sto.nx)
    normals(sto.rng_seed, 0, shape, "cuda")
    times["P1"] = _events_ms(lambda: normals(sto.rng_seed, 0, shape, "cuda"),
                             100)
    times["P1 graph"] = _graph_ms(
        lambda: normals(sto.rng_seed, 0, shape, "cuda"))
    normals_reference(sto.rng_seed, 0, *shape, "cuda")
    times["plain P1"] = _events_ms(
        lambda: normals_reference(sto.rng_seed, 0, *shape, "cuda"), 5)
    steps["P1"] = 1
    randn_ms = _events_ms(lambda: torch.randn(shape, device="cuda"), 100)
    for key, sim in (("K2d", adv), ("K2n", sto), ("K3d", rad), ("K3n", wave),
                     ("K3v", inlet), ("P1", sto)):
        print(f"{key} at {sim.ny}x{sim.nx}: {times[key]:.4f} ms per launch "
              f"of {steps[key]} step(s); plain version "
              f"{times['plain ' + key]:.4f} ms for the same work (CUDA "
              f"events)", flush=True)
    print(f"P1 at {sto.ny}x{sto.nx}: {times['P1 graph']:.4f} ms per launch "
          "by CUDA-graph replay", flush=True)
    print(f"for scale, not the same function: torch.randn {shape} "
          f"(cuRAND's Philox normals) {randn_ms:.4f} ms", flush=True)
    return times, steps


def diffusion_main_path_phase(adv, sto, wave, rad, inlet_k3, card):
    """The diffusion slice's paths and the velocity inlet through K3, each
    as a user runs it (``run(n, timed=True)`` on the model ``backend``
    built), each in its own counted window; then the plain (eager) models
    at the same sizes."""
    for sim in (adv, sto):  # warm every kernel the paths launch
        sim.run(sim.temporal_k + 1)
    for sim in (wave, rad, inlet_k3):
        sim.run(10)
    wave.noise()
    launches, eta = {}, []
    k2 = "K2 diffusion family"
    k3 = "K3 diffusion family"
    launches["K2d"] = _window(
        f"AdvectionDiffusion {adv.ny}x{adv.nx}",
        lambda: adv.run(DIFFUSION_STEPS, timed=True),
        {k2: -(-DIFFUSION_STEPS // adv.temporal_k)})[k2]
    launches["K2n"] = _window(
        f"ReactionAdvectionDiffusionStochastic {sto.ny}x{sto.nx}",
        lambda: sto.run(DIFFUSION_STEPS, timed=True),
        {k2: -(-DIFFUSION_STEPS // sto.temporal_k)})[k2]

    def drive_wave():
        wave.run(RESIDENT_DIFFUSION_STEPS, timed=True)
        eta.append(wave.noise())  # the normals its next step draws

    counts = _window(f"NoisyAdvectedFisherWave {wave.ny}x{wave.nx}",
                     drive_wave, {k3: 1, "P1": 1})
    launches["K3n"], launches["P1"] = counts[k3], counts["P1"]
    launches["K3d"] = _window(
        f"ReactionAdvectionDiffusion {rad.ny}x{rad.nx}",
        lambda: rad.run(RESIDENT_DIFFUSION_STEPS, timed=True), {k3: 1})[k3]
    launches["K3v"] = _window(
        f"PipeFlowVelocityInlet {inlet_k3.ny}x{inlet_k3.nx} "
        "backend='resident'", lambda: inlet_k3.run(INLET_STEPS, timed=True),
        {"K3v": 1})["K3v"]

    plain = {}
    for name, sim, make in (
            ("adv", adv, lambda: AdvectionDiffusion(backend="eager",
                                                    device="cuda",
                                                    **ADVECTION)),
            ("sto", sto, lambda: ReactionAdvectionDiffusionStochastic(
                backend="eager", device="cuda", **STOCHASTIC)),
            ("wave", wave, lambda: NoisyAdvectedFisherWave(
                backend="eager", device="cuda", **NOISY_WAVE)),
            ("rad", rad, lambda: ReactionAdvectionDiffusion(
                backend="eager", device="cuda", **REACTION)),
            ("inlet", inlet_k3, lambda: PipeFlowVelocityInlet(
                backend="eager", device="cuda"))):
        ref = make()
        ref.run(3)
        ref.run(20, timed=True)
        plain[name] = ref.last_mlups
        del ref
    for name, sim, steps, key in (
            ("adv", adv, DIFFUSION_STEPS, "K2d"),
            ("sto", sto, DIFFUSION_STEPS, "K2n"),
            ("wave", wave, RESIDENT_DIFFUSION_STEPS, "K3n"),
            ("rad", rad, RESIDENT_DIFFUSION_STEPS, "K3d"),
            ("inlet", inlet_k3, INLET_STEPS, "K3v")):
        print(f"main path {type(sim).__name__} {sim.ny}x{sim.nx} "
              f"backend={sim.backend}: {sim.last_mlups:.1f} MLUPS over "
              f"{steps} steps, {launches[key]} launch(es) of {key}; plain "
              f"(eager) {plain[name]:.1f} MLUPS; card: {card}", flush=True)
    return launches, eta[0]


def diffusion_physics_phase(adv, sto, wave, rad, eta, mass0):
    """The outputs of the diffusion paths, by the repo's own checks
    (tests/test_diffusion.py, tests/test_noisy_kernel.py,
    benchmarks/tpu_tests.py)."""
    for sim in (adv, sto, wave, rad):
        if not torch.isfinite(sim.state).all():
            raise RuntimeError(f"{type(sim).__name__}: non-finite state")
        fields = sim.get_physical_fields()
        if fields["rho"].shape != (sim.nx, sim.ny):
            raise RuntimeError(f"{type(sim).__name__}: bad field shape")
    for sim in (sto, wave):
        if float(sim.state.min()) < 0.0:
            raise RuntimeError(f"{type(sim).__name__}: negative populations "
                               "after the clip")
    if float(density(rad.state).max()) > 1.01:
        raise RuntimeError("ReactionAdvectionDiffusion: rho above 1.01")
    mass = float(density(adv.state).double().sum())
    drift = abs(mass - mass0) / mass0
    w = density(adv.state).double().sum(dim=0).cpu().numpy()  # per column
    ang = 2 * np.pi * np.arange(adv.nx) / adv.nx
    cx = (np.angle(np.sum(w * np.exp(1j * ang))) / (2 * np.pi) * adv.nx
          ) % adv.nx
    want_cx = (adv.nx // 2 + adv.u_lb * adv.steps_taken) % adv.nx
    print(f"AdvectionDiffusion {adv.ny}x{adv.nx} after {adv.steps_taken} "
          f"steps: centroid x {cx:.3f} (advected {want_cx:.3f}), mass drift "
          f"{drift:.3e}", flush=True)
    if not (abs(cx - want_cx) < 1.0 and drift < 1e-3):
        raise RuntimeError("AdvectionDiffusion: blob not advected or mass "
                           "not conserved")
    for backend in ("resident", "temporal"):
        sim = Diffusion(N=25, z=0.1, D=1.0, Lx=0.4, Ly=0.4, backend=backend,
                        device="cuda")
        steps = int(round(0.05 / sim.delta_t))
        sim.run(steps)
        t = steps * sim.delta_t
        rho = sim.get_fields()["rho"].T
        X, Y = np.meshgrid(np.arange(sim.nx), np.arange(sim.ny))
        r2 = ((X - sim.nx // 2) ** 2 + (Y - sim.ny // 2) ** 2) / sim.N ** 2
        expected = np.exp(-r2 / (1.0 + 4.0 * t)) / (1.0 + 4.0 * t)
        b = sim.N // 2
        err = float(np.abs(rho - expected)[b:-b, b:-b].max())
        print(f"Diffusion N=25 through backend={backend}: max error against "
              f"the spreading Gaussian {err:.5f} (limit 0.02)", flush=True)
        if not err < 0.02:
            raise RuntimeError(f"Gaussian spreading error {err} >= 0.02")
    e = eta.double().cpu().numpy()
    n = e.size
    kurt = ((e - e.mean()) ** 4).mean() / e.var() ** 2 - 3.0
    print(f"P1 normals of the wave's next step ({n} draws): mean "
          f"{e.mean():.5f}, std {e.std():.5f}, excess kurtosis {kurt:.4f}",
          flush=True)
    if not (abs(e.mean()) < 5 / np.sqrt(n) and abs(e.std() - 1) < 5 / np.sqrt(
            2 * n) and abs(kurt) < 5 * np.sqrt(24.0 / n)):
        raise RuntimeError("P1 normals are not N(0, 1) within 5 sigma")
    kw = wave.step_kwargs()
    w9 = torch.tensor(D2Q9.w, device="cuda")[:, None, None]
    uniform = (0.5 * w9).expand(9, wave.ny, wave.nx).contiguous()
    runs = []
    for dg in (kw["lb_Dg"], 0.0):
        f = uniform.clone()
        resident_diffusion_run(f, torch.empty_like(f), 1,
                               **dict(kw, lb_Dg=dg))
        runs.append(density(f))
    std = float((runs[0] - runs[1]).double().std())
    expected = float(np.sqrt(kw["lb_Dg"] * 0.25))
    print(f"noise amplitude through K3 from uniform rho = 0.5: std "
          f"{std:.6e}, sqrt(Dg/4) = {expected:.6e}", flush=True)
    if not abs(std / expected - 1.0) < 0.03:
        raise RuntimeError("noise amplitude off by more than 3%")


# -- the multifield slice --------------------------------------------------

def _mf_random_state(F, ny, nx, physics):
    """f = w rho (1 + 1% noise) (numpy seed 2): Fisher densities summing to
    at most 0.9; Expansion densities in [0, 0.3], many below the 0.01
    cutoff, and a nutrient in [0, 1]."""
    rng = np.random.RandomState(2)
    if physics == "fisher":
        rho = 0.9 * rng.rand(F, ny, nx) / F
    else:
        rho = 0.3 * rng.rand(F, ny, nx) ** 2
        rho[-1] = rng.rand(ny, nx)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    return torch.tensor(w * rho * (1.0 + 0.01 * rng.randn(9, F, ny, nx)),
                        dtype=torch.float32, device="cuda")


def _mf_kwargs(F, physics):
    """Per-field constants for F fields (numpy seed F), with an imposed
    velocity; Expansion noise on populations 0, 2, 3, 5, ... (Dg = 0 on
    every third, so that pairs with one noiseless member are checked)."""
    rng = np.random.RandomState(F)
    P = F if physics == "fisher" else F - 1
    kw = dict(omegas=(1.9 + 0.09 * rng.rand(P)).astype(np.float32),
              lb_G=(1e-4 * (1 + rng.rand(P))).astype(np.float32),
              u_lb=0.0021, v_lb=-0.0013, physics=physics)
    if physics == "expansion":
        kw.update(omega_nutrient=np.float32(1.95), cutoff=0.01,
                  seed=2**40 + 7,
                  lb_Dg=np.where(np.arange(P) % 3 == 1, 0.0,
                                 0.02 * (1 + rng.rand(P))).astype(np.float32))
    return kw


_BAND_ARGS = ("omegas", "omega_nutrient", "lb_G", "lb_Dg", "cutoff", "u_lb",
              "v_lb")


def _band_of(f, B):
    """Rows [-B, B) of a [9, F, ny, nx] state, contiguous."""
    return torch.cat([f[:, :, -B:], f[:, :, :B]], dim=2).contiguous()


def compare_k4(kw, f0, k, step0=STEP0):
    out = temporal_multifield_step(f0, torch.empty_like(f0), k, step0=step0,
                                   **kw)
    return _max_diff(out, multifield_run_reference(f0, k, step0=step0, **kw))


def compare_k5(kw, f0, k, B, step0=STEP0):
    """K5 on rows [-B, B) of f0 against its plain version and against rows
    [-k, k) of K4 on the whole grid; returns the larger max |d|."""
    kw = dict(kw)
    kw.pop("physics")
    ny = f0.shape[2]
    args = [kw[n] for n in _BAND_ARGS]
    band_kw = dict(seed=kw["seed"], step0=step0, row0=ny - B, ny=ny)
    band = _band_of(f0, B)
    got = expansion_band_step(band, k, *args, **band_kw)
    plain = expansion_band_reference(band, k, *args, **band_kw)
    whole = temporal_multifield_step(f0, torch.empty_like(f0), k,
                                     physics="expansion", step0=step0, **kw)
    return max(_max_diff(got, plain), _max_diff(got, _band_of(whole, k)))


def multifield_kernel_phase(fe, ex):
    """K4 and K5 against their plain versions, all to 0 (every operation
    rounds alone; the clips turn an ulp into a jump): at the main path's
    models and shapes (from step STEP0, noise on), K4 at every K, and on
    random states at an unaligned grid for F = 1..8 at every K, and at
    45x33 and 7x300 for F = 1, 2, 3 and 8."""
    worst = dict.fromkeys(("K4f", "K4e", "K5"), 0.0)

    def check(key, label, d):
        print(f"{label}: max|d| = {d:.3e} (limit 0)", flush=True)
        if not d == 0.0:
            raise RuntimeError(f"{label}: kernel disagrees, {d} > 0")
        worst[key] = max(worst[key], d)

    def check_ks(key, label, compare, F):
        ks = range(1, multifield_max_k(F) + 1)
        worst[key] = max(worst[key], _checked_ks(label, compare, 0.0, ks))

    rng = np.random.RandomState(0)
    noise = torch.tensor((1 + 0.01 * rng.randn(*fe.state.shape)).astype(
        np.float32), device="cuda")
    f_fe = (fe.state * noise).contiguous()
    check_ks("K4f", f"K4 fisher vs plain {fe.ny}x{fe.nx} F={fe.num_fields} "
             "model state (1% perturbed)",
             lambda k: compare_k4(fe.step_kwargs(), f_fe, k), fe.num_fields)
    del f_fe, noise
    kw = ex.step_kwargs()
    check_ks("K4e", f"K4 expansion vs plain {ex.ny}x{ex.nx} "
             f"F={ex.num_fields} model state, noise on",
             lambda k: compare_k4(kw, ex.state, k), ex.num_fields)
    for k in sorted({1, ex.temporal_k, band_max_k(ex.num_fields)}):
        for B in (2 * k, 2 * k + 5):
            check("K5", f"K5 vs plain and vs K4 rows [-{k}, {k}), band of "
                  f"{2 * B} rows of the {ex.ny}x{ex.nx} model state, k={k} "
                  f"({band_plan.plan(ex.num_fields, k, ex.nx)})",
                  compare_k5(kw, ex.state, k, B))
    for F in range(1, MAX_MULTIFIELD_FIELDS + 1):
        shapes = ((254, 382), (45, 33), (7, 300)) if F in (1, 2, 3, 8) else (
            (254, 382),)
        for ny, nx in shapes:
            f0 = _mf_random_state(F, ny, nx, "fisher")
            check_ks("K4f", f"K4 fisher vs plain {ny}x{nx} F={F} random rho",
                     lambda k: compare_k4(_mf_kwargs(F, "fisher"), f0, k), F)
            if F == 1:
                continue  # Expansion has a nutrient and at least one population
            f0 = _mf_random_state(F, ny, nx, "expansion")
            kw = _mf_kwargs(F, "expansion")
            check_ks("K4e", f"K4 expansion vs plain {ny}x{nx} F={F} random "
                     "rho, noise on", lambda k: compare_k4(kw, f0, k), F)
            if (ny, nx) == (254, 382):
                k = band_max_k(F)
                check("K5", f"K5 vs plain and vs K4 rows, 254x382 F={F} "
                      f"random rho, k={k}", compare_k5(kw, f0, k, 2 * k))
    return worst


def multifield_k_sweep_phase(fe, ex, card):
    """Device ms per step of K4 at K = 1..K_max for each physics, at the
    main path's 2048^2 (fisher) and 1024^2 (expansion) (CUDA events, 30
    launches each)."""
    best = {}
    for label, sim in (("fisher", fe), ("expansion", ex)):
        kw = sim.step_kwargs()
        bufs = [sim.state.clone(), torch.empty_like(sim.state)]
        per_step = {}
        for k in range(1, multifield_max_k(sim.num_fields) + 1):
            def launch(k=k):
                temporal_multifield_step(bufs[0], bufs[1], k, step0=STEP0,
                                         **kw)
                bufs.reverse()

            launch()
            per_step[k] = _events_ms(launch, 30) / k
        best[label] = min(per_step, key=per_step.get)
        print(f"K sweep, K4 {label} at {sim.ny}x{sim.nx} F={sim.num_fields}, "
              f"ms per step: "
              + ", ".join(f"K={k} {t:.5f}" for k, t in per_step.items())
              + f"; fastest K={best[label]} (model uses "
              f"K={sim.temporal_k}); card: {card}", flush=True)
        del bufs
    return best


def _band_launch_args(ex, k):
    kw = ex.step_kwargs()
    B = 2 * k
    band = _band_of(ex.state, B)
    args = [kw[n] for n in _BAND_ARGS]
    band_kw = dict(seed=kw["seed"], step0=ex.steps_taken, row0=ex.ny - B,
                   ny=ex.ny)
    return band, args, band_kw


def multifield_timing_phase(fe, ex):
    """Device time per launch of K4 (each physics, at the model's K) and K5
    (a band of 4K rows at the Expansion's K) at the main path's shapes, and
    of the plain versions doing the same work (CUDA events)."""
    times, steps = {}, {}
    for key, sim in (("K4f", fe), ("K4e", ex)):
        kw, k = sim.step_kwargs(), sim.temporal_k
        bufs = [sim.state.clone(), torch.empty_like(sim.state)]

        def k4():
            temporal_multifield_step(bufs[0], bufs[1], k, step0=STEP0, **kw)
            bufs.reverse()

        def plain():
            bufs[0] = multifield_run_reference(bufs[0], k, step0=STEP0, **kw)

        k4()
        times[key] = _events_ms(k4, 100)
        plain()
        times["plain " + key] = _events_ms(plain, 3)
        steps[key] = k
        del bufs
    k = ex.temporal_k
    band, args, band_kw = _band_launch_args(ex, k)
    expansion_band_step(band, k, *args, **band_kw)
    times["K5"] = _events_ms(
        lambda: expansion_band_step(band, k, *args, **band_kw), 200)
    times["K5 graph"] = _graph_ms(
        lambda: expansion_band_step(band, k, *args, **band_kw))
    expansion_band_reference(band, k, *args, **band_kw)
    times["plain K5"] = _events_ms(
        lambda: expansion_band_reference(band, k, *args, **band_kw), 10)
    steps["K5"] = k
    for key, sim in (("K4f", fe), ("K4e", ex), ("K5", ex)):
        shape = (f"band of {band.shape[2]} rows x {sim.nx}" if key == "K5"
                 else f"{sim.ny}x{sim.nx}")
        print(f"{key} at {shape} F={sim.num_fields}: {times[key]:.4f} ms per "
              f"launch of {steps[key]} step(s); plain version "
              f"{times['plain ' + key]:.4f} ms for the same work (CUDA "
              f"events)", flush=True)
    print(f"K5: {times['K5 graph']:.4f} ms per launch by CUDA-graph replay "
          f"(plan {band_plan.plan(ex.num_fields, k, ex.nx)})", flush=True)
    return times, steps, band.shape[2]


def multifield_main_path_phase(fe, ex, card):
    """The multifield slice's paths as a user runs them (``run(n,
    timed=True)`` on the models ``backend="auto"`` built), each in its own
    counted window, then K5's own path (its entry point on the Expansion's
    seam band, which ``Expansion.run`` does not need); then the plain
    (eager) models at the same sizes."""
    for sim in (fe, ex):  # warm every kernel the paths launch
        sim.run(sim.temporal_k + 1)
    launches = {}
    for key, sim, steps in (("K4f", fe, FISHER_STEPS),
                            ("K4e", ex, EXPANSION_STEPS)):
        launches[key] = _window(
            f"{type(sim).__name__} {sim.ny}x{sim.nx} F={sim.num_fields}",
            lambda sim=sim, steps=steps: sim.run(steps, timed=True),
            {"K4": -(-steps // sim.temporal_k)})["K4"]
    k = ex.temporal_k
    band, args, band_kw = _band_launch_args(ex, k)
    expansion_band_step(band, k, *args, **band_kw)

    def drive_band():
        for i in range(BAND_LAUNCHES):
            expansion_band_step(band, k, *args,
                                **dict(band_kw, step0=band_kw["step0"] + i))

    launches["K5"] = _window(
        f"expansion_band_step on the {ex.ny}x{ex.nx} Expansion's seam band "
        f"({band.shape[2]} rows), {BAND_LAUNCHES} launches of {k} steps",
        drive_band, {"K5": BAND_LAUNCHES})["K5"]

    plain = {}
    for key, make in (("K4f", lambda: FisherExpansion(
            backend="eager", device="cuda", **FISHER_EXP)),
                      ("K4e", lambda: Expansion(backend="eager",
                                                device="cuda", **EXPANSION))):
        ref = make()
        ref.run(2)
        ref.run(10, timed=True)
        plain[key] = ref.last_mlups
        del ref
    for key, sim, steps in (("K4f", fe, FISHER_STEPS),
                            ("K4e", ex, EXPANSION_STEPS)):
        print(f"main path {type(sim).__name__} {sim.ny}x{sim.nx} "
              f"F={sim.num_fields} backend={sim.backend}: "
              f"{sim.last_mlups:.1f} MLUPS over {steps} steps, "
              f"{launches[key]} launches of K4; plain (eager) "
              f"{plain[key]:.1f} MLUPS; card: {card}", flush=True)
    return launches


def multifield_physics_phase(fe, ex, ex_rho0):
    """The outputs of the multifield paths, by the repo's own checks
    (tests/test_multifield.py): finite fields of the reference layout, the
    logistic cap, mass through the no-flux walls, nutrient consumption."""
    for sim in (fe, ex):
        if not torch.isfinite(sim.state).all():
            raise RuntimeError(f"{type(sim).__name__}: non-finite state")
        rho = sim.get_physical_fields()["rho"]
        if rho.shape != (sim.nx, sim.ny, sim.num_fields):
            raise RuntimeError(f"{type(sim).__name__}: bad field shape")
    rho_tot = float(fe.device_field("rho").max())
    print(f"FisherExpansion {fe.ny}x{fe.nx} after {fe.steps_taken} steps: "
          f"max rho_tot {rho_tot:.6f} (limit 1.05)", flush=True)
    if not rho_tot < 1.05:
        raise RuntimeError("FisherExpansion: rho_tot above the logistic cap")
    sim = FisherExpansion(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[0.0, 0.0],
                          D_standard=1.0, D_list=[1.0, 1.0], N=10,
                          initial_frac_widths=[0.5, 0.5],
                          initial_frac_indices=[0, 1], device="cuda")
    sim.run(200)
    m0 = float(sim.state.double().sum())
    sim.run(400)
    m1 = float(sim.state.double().sum())
    print(f"FisherExpansion {sim.ny}x{sim.nx} mu=0 backend={sim.backend}: "
          f"mass {m0:.6f} -> {m1:.6f} over 400 steps, relative change "
          f"{abs(m1 - m0) / m0:.3e} (limit 2e-4)", flush=True)
    if not abs(m1 - m0) < 2e-4 * m0:
        raise RuntimeError("FisherExpansion: mass leaks through the walls")
    if float(ex.state.min()) < 0.0:
        raise RuntimeError("Expansion: negative populations after the clips")
    P = ex.num_populations
    rho = density(ex.state).double().sum(dim=(1, 2))
    pop0, pop1 = float(ex_rho0[:P].sum()), float(rho[:P].sum())
    nut0, nut1 = float(ex_rho0[P]), float(rho[P])
    drift = abs(pop1 + nut1 - pop0 - nut0) / (pop0 + nut0)
    print(f"Expansion {ex.ny}x{ex.nx} after {ex.steps_taken} steps: "
          f"populations {pop0:.3f} -> {pop1:.3f}, nutrient {nut0:.3f} -> "
          f"{nut1:.3f}, total changed by {drift:.3e} (limit 2e-2)",
          flush=True)
    if not (nut1 < nut0 and pop1 > pop0 and drift < 2e-2):
        raise RuntimeError("Expansion: nutrient not consumed, populations "
                           "not grown, or mass not conserved")


# -- the multicomponent slice ---------------------------------------------

def compare_k6(sim, steps=MC_CHECK_STEPS):
    """``steps`` K6 steps (mc_density + mc_step) of the runner's state
    against as many plain steps, and mc_density against the plain density
    of that state; returns max |df| and max |drho|. The kernel steps run
    first and free their spare buffer before the plain steps start, so at
    8192^2 the check holds one copy of f more than the plain step itself."""
    cfg, ext, lat = sim.config(), sim.ext_planes(), sim.lattice
    rho = mc_density(sim.f, torch.empty_like(sim.rho), cfg, lat)
    d_rho = _max_diff(rho, mc_density_reference(sim.f, cfg, lat))
    params = mc_params(cfg, lat)
    a, spare = sim.f.clone(), torch.empty_like(sim.f)
    for _ in range(steps):
        mc_density(a, rho, cfg, lat)
        a, spare = mc_step(a, spare, rho, ext, cfg, lat, params), a
    del spare
    b = sim.f
    for _ in range(steps):
        b = mc_step_reference(b, cfg, lat, ext)
    return _max_diff(a, b), d_rho


def _checked_k6(label, sim, worst):
    """K6 against its plain version from ``sim``'s state (compare_k6),
    each difference held to KERNEL_TOL and folded into ``worst``."""
    torch.cuda.reset_peak_memory_stats()
    d_step, d_rho = compare_k6(sim)
    where = (f"{label} {sim.ny}x{sim.nx} {sim.lattice.name} "
             f"C={sim.num_populations}")
    worst["K6s"] = max(worst["K6s"], _checked(
        f"K6 (mc_density + mc_step) vs plain, {where}, {MC_CHECK_STEPS} "
        f"steps (peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB)",
        d_step))
    worst["K6d"] = max(worst["K6d"], _checked(
        f"K6 mc_density vs plain, {where}", d_rho))
    torch.cuda.empty_cache()


def _porous_runner(n, screened=False, stale_force=None):
    """The porous two-fluid Shan-Chen runner of BASELINE config 5
    (``benchmarks/run_all.py:113-140``) at ``n``^2; with ``screened``, its
    screened-Poisson hook too (``benchmarks/c5_one.py``), solved once per
    ``stale_force`` steps when that is given."""
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=True, device="cuda",
                           stale_force=stale_force)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(0).rand(n, n).astype(np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    if screened:
        sim.add_screened_poisson_force(0, 1, interaction_length=C5_LAM,
                                       amplitude=C5_AMP)
    return sim


def _spinodal_runner(n, lattice=D2Q9, G_int=1.5, potential="linear",
                     params=None, seed=1, backend="auto"):
    """The two-fluid spinodal decomposition (``examples/zoo_drive.py:156-176``,
    ``examples/spinodal_decomposition.py``) at ``n``^2."""
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=False, lattice=lattice, device="cuda",
                           backend=backend)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=1.0))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(seed).rand(n, n)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=G_int, potential=potential,
                              potential_parameters=params)
    return sim


def _fluid_mass(sim):
    """Float64 mass per fluid."""
    return sim.f.double().sum(dim=(0, 2, 3)).cpu().numpy()


def mc_kernel_phase():
    """K6 against its plain version, 5 steps from one state at 254x382 (an
    unaligned grid), one check per configuration (a)-(g); mc_density alone
    against the plain density. Returns max |d| per kernel; the main-path
    phase adds its runners' checks to it."""
    worst = {"K6d": 0.0, "K6s": 0.0}
    for case in MC_CASES:
        sim = mc_case(case, 254, 382, device="cuda")
        if sim.backend != "kernel":
            raise RuntimeError(f"K6 case {case}: backend {sim.backend}")
        _checked_k6(f"configuration ({case})", sim, worst)
    return worst


def _mc_times(sim, plain_reps):
    """Device ms per launch of mc_density and mc_step on the runner's state,
    and of their plain versions (CUDA events)."""
    cfg, ext, lat = sim.config(), sim.ext_planes(), sim.lattice
    params = mc_params(cfg, lat)
    bufs = [sim.f.clone(), torch.empty_like(sim.f)]
    rho = torch.empty_like(sim.rho)

    def density():
        mc_density(bufs[0], rho, cfg, lat)

    def step():  # on the density of the last density launch
        mc_step(bufs[0], bufs[1], rho, ext, cfg, lat, params)
        bufs.reverse()

    times = {}
    density()
    step()
    times["K6d"] = _events_ms(density, 50)
    times["K6s"] = _events_ms(step, 50)
    del bufs
    g = [sim.f]
    times["plain K6d"] = _events_ms(
        lambda: mc_density_reference(g[0], cfg, lat), plain_reps)

    def plain():
        g[0] = mc_step_reference(g[0], cfg, lat, ext)

    plain()
    times["plain K6s"] = _events_ms(plain, plain_reps)
    del g
    torch.cuda.empty_cache()
    return times


def mc_step_breakdown(sim):
    """Device ms per launch of the mc_step kernel alone on the runner's
    state with its interaction hook removed, with a linear pseudopotential,
    and as registered: what the Shan-Chen part costs."""
    cfg = sim.config()
    hook = cfg.interactions[0]
    linear = hook[:4] + (0, (0.0,)) + hook[6:]
    rho = mc_density(sim.f, torch.empty_like(sim.rho), cfg, sim.lattice)
    out = torch.empty_like(sim.f)
    times = {}
    for label, hooks in (("no interaction", ()), ("linear psi", (linear,)),
                         ("as registered", cfg.hooks)):
        variant = dataclasses.replace(cfg, hooks=hooks)
        params = mc_params(variant, sim.lattice)

        def launch(variant=variant, params=params):
            mc_step(sim.f, out, rho, None, variant, sim.lattice, params)

        launch()
        times[label] = _events_ms(launch, 20)
    print(f"mc_step at {sim.ny}x{sim.nx} by force hooks: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + " (CUDA events)", flush=True)
    del out, rho
    return times


def mc_timing_phase(big, spin):
    """Device time per launch of K6's two kernels at 8192^2 (porous) and
    1024^2 (spinodal), and of the plain versions (CUDA events)."""
    mc_step_breakdown(big)
    out = {}
    for label, sim, reps in (("8192", big, 2), ("1024", spin, 10)):
        torch.cuda.reset_peak_memory_stats()
        times = _mc_times(sim, reps)
        out[label] = times
        for key, name in (("K6d", "mc_density"), ("K6s", "mc_step")):
            print(f"{key} ({name}) at {sim.ny}x{sim.nx} "
                  f"C={sim.num_populations}: "
                  f"{times[key]:.4f} ms per launch; plain version "
                  f"{times['plain ' + key]:.4f} ms (CUDA events); peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
                  flush=True)
    return out


def mc_main_path_phase(card, worst):
    """The slice's main paths as a user runs them, each in its own counted
    window, each big runner freed before the next: the 8192^2 porous
    two-fluid runner ``run(100, timed=True)`` after a warm run, the 1024^2
    spinodal ``run(1000)`` and a 1024^2 D2Q25 runner ``run(200)``; mass per
    fluid conserved (1e-4 relative) on the 1024^2 runs. K6 is held to its
    plain version at each runner's shape (from the 8192^2 runner's first
    state, and from each 1024^2 runner's state after its run), the
    differences folded into ``worst``. Returns the launches of the 8192^2
    run, its MLUPS and the timing phase's numbers."""
    big = _porous_runner(8192)
    _checked_k6("porous runner", big, worst)
    spin = _spinodal_runner(1024)
    times = mc_timing_phase(big, spin)
    big.run(2)
    counts = _window(f"SimulationRunner porous 2-fluid {big.ny}x{big.nx}",
                     lambda: big.run(MC_BIG_STEPS, timed=True),
                     {"K6d": MC_BIG_STEPS, "K6s": MC_BIG_STEPS})
    if not torch.isfinite(big.f).all():
        raise RuntimeError("8192^2 porous runner: non-finite state")
    mlups = big.last_mlups
    step_ms = big.num_cells / (mlups * 1e6) * 1e3
    least = _bound(big.num_cells * MC_LEAST_BYTES, 0)[0]
    two_pass = _bound(big.num_cells * MC_TWO_PASS_BYTES, 0)[0]
    print(f"main path SimulationRunner porous 2-fluid Shan-Chen "
          f"{big.ny}x{big.nx} backend={big.backend}: {mlups:.1f} MLUPS over "
          f"{MC_BIG_STEPS} steps ({step_ms:.4f} ms per step), launches "
          f"{counts['K6d']} mc_density + {counts['K6s']} mc_step; bound "
          f"{least:.4f} ms per step at {MC_LEAST_BYTES} B/cell-step (share "
          f"{least / step_ms:.3f}), {two_pass:.4f} ms at the two-pass "
          f"{MC_TWO_PASS_BYTES} B (share {two_pass / step_ms:.3f}); card: "
          f"{card}", flush=True)
    big_info = dict(launches=counts, mlups=mlups, cells=big.num_cells,
                    ops=_mc_ops(big))
    del big
    torch.cuda.empty_cache()

    for label, sim, steps in (
            ("spinodal", spin, MC_SPINODAL_STEPS),
            ("Shan-Chen 2-fluid", _spinodal_runner(
                1024, D2Q25, potential="shan_chen", params=[1.0]),
             MC_Q25_STEPS)):
        sim.run(2)
        m0 = _fluid_mass(sim)
        counts = _window(f"SimulationRunner {label} {sim.ny}x{sim.nx} "
                         f"{sim.lattice.name}",
                         lambda: sim.run(steps, timed=True),
                         {"K6d": steps, "K6s": steps})
        m1 = _fluid_mass(sim)
        drift = float(np.max(np.abs(m1 - m0) / m0))
        rho = sim.get_fields()["rho"]
        print(f"main path SimulationRunner {label} {sim.ny}x{sim.nx} "
              f"{sim.lattice.name} backend={sim.backend}: "
              f"{sim.last_mlups:.1f} MLUPS over {steps} steps, launches "
              f"{counts['K6d']} + {counts['K6s']}; mass per fluid "
              f"{m0.tolist()} -> {m1.tolist()}, largest relative change "
              f"{drift:.3e} (limit 1e-4); card: {card}", flush=True)
        if not (np.isfinite(rho).all() and rho.shape == (sim.nx, sim.ny, 2)
                and drift < 1e-4):
            raise RuntimeError(f"{label}: bad fields or mass not conserved")
        _checked_k6(f"{label} runner after its run", sim, worst)
        del sim
    del spin
    torch.cuda.empty_cache()
    plain = _spinodal_runner(1024, backend="eager")
    plain.run(2)
    plain.run(20, timed=True)
    print(f"the 1024^2 spinodal through the plain step (eager): "
          f"{plain.last_mlups:.1f} MLUPS; card: {card}", flush=True)
    del plain
    return big_info, times


def mc_physics_phase():
    """The repo's own checks through K6: the Darcy balance u = g K / nu_f
    within 5% (tests/test_multicomponent.py:33-46) and the spinodal
    separation at 128^2 after 400 steps (correlation < -0.5, contrast grown
    20x)."""
    sim = SimulationRunner(nx=32, ny=32, L_lb=32, num_populations=1,
                           porous=True, device="cuda")
    fl = Fluid(sim, 0, nu_e=0.5, epsilon=0.8, nu_fluid=0.4, K=2.0, Fe=0.0)
    sim.add_fluid(fl)
    sim.complete_setup()
    fl.initialize(np.ones((32, 32)))
    sim.add_constant_body_force(0, 1e-5, 0.0)
    sim.run(3000)
    u = sim.get_fields()["u_bary"]
    want = 1e-5 * 2.0 / 0.4
    err = float(np.abs(u / want - 1).max())
    print(f"Darcy balance 32x32 through backend={sim.backend}: u mean "
          f"{u.mean():.6e} against g K / nu_f = {want:.6e}, largest relative "
          f"error {err:.4f} (limit 0.05)", flush=True)
    if not err < 0.05:
        raise RuntimeError("Darcy balance off by more than 5%")
    sim = _spinodal_runner(128, G_int=1.8)
    std0 = float(sim.get_fields()["rho"][:, :, 0].std())
    sim.run(400)
    rho = sim.get_fields()["rho"]
    corr = float(np.corrcoef(rho[..., 0].ravel(), rho[..., 1].ravel())[0, 1])
    grown = float(rho[..., 0].std() / std0)
    print(f"spinodal 128x128 G=1.8 through backend={sim.backend}, 400 steps: "
          f"correlation {corr:.4f} (limit -0.5), contrast grown {grown:.1f}x "
          f"(limit 20x)", flush=True)
    if not (np.isfinite(rho).all() and corr < -0.5 and grown > 20):
        raise RuntimeError("spinodal decomposition did not separate")


# -- the spectral slice: K8 and K7 --------------------------------------------

def _relative(got, want):
    """max |got - want| over max |want| (finite values required)."""
    return _max_diff(got, want) / float(want.abs().max())


def spectral_kernel_phase():
    """K8 against its plain solve at every ``K8_SHAPES`` grid (config 5's
    amplitude), and its 1-D pass against ``torch.fft.fft``. Returns the
    worst relative and absolute differences of the solve."""
    worst = {"K8": 0.0, "K8 abs": 0.0}
    rng = np.random.RandomState(3)
    for ny, nx in K8_SHAPES:
        rho = torch.tensor(rng.rand(ny, nx).astype(np.float32),
                           device="cuda")
        got = screened_gradients(rho, C5_LAM**2, out_scale=C5_AMP)
        want = screened_gradients_reference(rho, C5_LAM**2, out_scale=C5_AMP)
        d = _relative(got, want)
        print(f"K8 vs plain {ny}x{nx}: max|dg| / max|g| = {d:.3e} (limit "
              f"{K8_TOL:g})", flush=True)
        if not d <= K8_TOL:
            raise RuntimeError(f"K8 {ny}x{nx}: solve disagrees, {d}")
        worst["K8"] = max(worst["K8"], d)
        worst["K8 abs"] = max(worst["K8 abs"], _max_diff(got, want))
        del rho, got, want
    for n, W in ((8192, 128), (127, 250), (8191, 8)):
        xr = torch.tensor(rng.rand(n, W).astype(np.float32), device="cuda")
        xi = torch.tensor(rng.rand(n, W).astype(np.float32), device="cuda")
        for label, args, kw in (("real", (xr,), dict(out_rows=n // 2 + 1)),
                                ("complex", (xr, xi), {}),
                                ("inverse", (xr, xi), dict(inverse=True))):
            got = dft_axis0(*args, **kw)
            want = dft_axis0_reference(*args, **kw)
            scale = max(float(w.abs().max()) for w in want)
            d = max(_max_diff(g, w) for g, w in zip(got, want)) / scale
            print(f"K8 1-D pass vs torch.fft.fft, n={n} W={W} {label}: "
                  f"max|d| / scale = {d:.3e} (limit {K8_PASS_TOL:g})",
                  flush=True)
            if not d <= K8_PASS_TOL:
                raise RuntimeError(f"K8 1-D pass {n} {label} disagrees: {d}")
    return worst


def _coupled_models():
    """The coupled models of the spectral slice's main paths, ``auto``: one
    per physics, keyed by it, and ``ScreenedFisherWave`` and
    ``SurfactantNutrientWave`` at 1024^2 with ``stale_velocity=8``."""
    return {
        "screened_fisher": ScreenedFisherWave(device="cuda",
                                              **SCREENED_FISHER),
        "surfactant": SurfactantNutrientWave(device="cuda", **SURFACTANT),
        "clumpy_surfactant": ClumpySurfactantNutrientWave(device="cuda",
                                                          **CLUMPY),
        "rocket_yeast": RocketYeast(device="cuda", **ROCKET),
        "rocket_yeast_forces_only": RocketYeastForcesOnly(device="cuda",
                                                          **ROCKET_FORCES),
        "screened_fisher stale8": ScreenedFisherWave(
            device="cuda", stale_velocity=8, **SCREENED_FISHER),
        "surfactant stale8": SurfactantNutrientWave(
            device="cuda", stale_velocity=8, **dict(SURFACTANT, N=1024)),
    }


def _k7_inputs(sim):
    """The model's state as ``[9, F, ny, nx]``, its post-stream densities
    and, for the screened models, its velocity planes of them."""
    f = sim._fields4(sim.state)
    rho = coupled_density(f, torch.empty((f.shape[1], sim.ny, sim.nx),
                                         device="cuda"))
    ext = (sim._velocity.planes(rho[0]) if sim._velocity is not None
           else None)
    return f, rho, ext


def _launch_k(sim):
    """Steps per K7 launch on a coupled model's main path: the rocket
    yeasts' K, the screened families' stale_velocity up to the cap."""
    cfg = sim.coupled_config()
    cap = min(COUPLED_TEMPORAL_K[cfg.physics], coupled_max_k(cfg))
    return min(sim.steps_per_call, cap)


def compare_k7(cfg, f0, ext, k):
    """K7, ``k`` steps in one launch (``ext`` held), against ``k`` plain
    steps and against ``k`` one-step launches; returns both max |df|, and
    for a screened family at ``k = 1`` the one-step kernel's on the
    densities of ``f0`` against the plain step (else 0)."""
    params = coupled_params(cfg)
    a = coupled_sweep(f0, torch.empty_like(f0), ext, cfg, k, params)
    b = coupled_sweep_reference(f0, cfg, k, ext)
    c = f0
    for _ in range(k):
        c = coupled_sweep(c, torch.empty_like(c), ext, cfg, 1, params)
    d_cell = 0.0
    if cfg.reads_ext and k == 1:
        rho = coupled_density(f0, torch.empty((cfg.fields, *f0.shape[2:]),
                                              device="cuda"))
        d_cell = _max_diff(_coupled_cell_step(f0, torch.empty_like(f0), rho,
                                              ext, cfg, params), b)
    return _max_diff(a, b), _max_diff(a, c), d_cell


def coupled_kernel_phase(runs):
    """K7, each physics, against its plain steps and its one-step launches
    at K = 1, 2 and the main path's K: from the state of each main path's
    model at its shape, and, once per physics, from a random state with a
    random velocity field at 254x382 (K = 1, 2 and the cap)."""
    worst = {}
    rng = np.random.RandomState(4)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    for run_label, sim in runs.items():
        cfg = sim.coupled_config()
        physics = cfg.physics
        f, _, ext = _k7_inputs(sim)
        cases = [(f"{sim.ny}x{sim.nx} model state ({run_label})", f, ext,
                  sorted({1, 2, _launch_k(sim)}))]
        if physics not in worst:
            rand = torch.tensor(w * (0.2 + rng.rand(9, cfg.fields, 254, 382)),
                                dtype=torch.float32, device="cuda")
            rand_ext = torch.tensor(0.02 * (rng.rand(2, 254, 382) - 0.5),
                                    dtype=torch.float32, device="cuda")
            cases.append(("254x382 random state", rand, rand_ext,
                          sorted({1, 2, coupled_max_k(cfg)})))
            worst[physics] = [0.0, 0.0]
        for label, f0, e, ks in cases:
            for k in ks:
                d, d_one, d_cell = compare_k7(cfg, f0, e, k)
                cell = (f", the one-step kernel vs the plain step "
                        f"{d_cell:.3e}" if cfg.reads_ext and k == 1 else "")
                print(f"K7 {physics}, {label}, K = {k}: max|df| vs {k} plain "
                      f"steps {d:.3e}, vs {k} one-step launches {d_one:.3e}"
                      + cell, flush=True)
                if not max(d, d_one, d_cell) <= KERNEL_TOL:
                    raise RuntimeError(f"K7 {physics} disagrees at K = {k}: "
                                       f"{d}, {d_one}, {d_cell}")
                worst[physics] = [max(worst[physics][0], d, d_cell),
                                  max(worst[physics][1], d_one)]
    for physics, (d, d_one) in worst.items():
        print(f"K7 {physics}: worst max|df| vs plain steps {d:.3e}, vs "
              f"one-step launches {d_one:.3e}", flush=True)
    return {physics: max(d) for physics, d in worst.items()}


def spectral_timing_phase(card):
    """Device ms of K8's solve at 8192^2 and 1024^2, of each of its passes
    there beside the pass's byte bound, of the plain solve, and of cuFFT
    (``torch.fft``) computing the same function with its multiplier
    precomputed (CUDA events); and of one solve of an 8191 x 16 grid (a
    prime column: the whole-line kernel)."""
    times = {}
    rng = np.random.RandomState(5)
    for n in (8192, 1024):
        rho = torch.tensor(rng.rand(n, n).astype(np.float32), device="cuda")
        out = torch.empty((2, n, n), device="cuda")

        def solve():
            screened_gradients(rho, C5_LAM**2, out=out, out_scale=C5_AMP)

        def plain():
            screened_gradients_reference(rho, C5_LAM**2, out_scale=C5_AMP)

        solve()
        reps = 20 if n == 8192 else 100
        times[f"K8 {n}"] = _events_ms(solve, reps)
        plain()
        times[f"plain K8 {n}"] = _events_ms(plain, reps // 4)
        fx, fy, gx, gy = spectral_grids(n, n, "cuda")
        screen = 1.0 / (np.float32(C5_LAM**2) * (fx[None] ** 2
                                                 + fy[:, None] ** 2) + 1.0)
        mult = (C5_AMP * screen * (2.0 * np.pi) * (
            1j * gx[None] - gy[:, None])).to(torch.complex64)

        def library():  # the same function, two cuFFT calls and a product
            g = torch.fft.ifft2(torch.fft.fft2(rho.to(torch.complex64)) * mult)
            return g.real, g.imag

        library()
        times[f"library K8 {n}"] = _events_ms(library, reps)
        got = torch.stack(library())
        d = _relative(got, out)
        plan = solve_plan(n, n)
        print(f"K8 at {n}^2 ({plan.path}, {len(plan.passes)} launches): "
              f"{times[f'K8 {n}']:.4f} ms per solve; plain solve "
              f"{times[f'plain K8 {n}']:.4f} ms; torch.fft (cuFFT) "
              f"{times[f'library K8 {n}']:.4f} ms, which K8 matches to "
              f"{d:.3e} of max|g| (CUDA events); card: {card}", flush=True)
        passes = []
        for (name, launch), p in zip(
                screened_gradients_passes(rho, C5_LAM**2, out, C5_AMP),
                plan.passes):
            launch()
            ms = _events_ms(launch, reps)
            bound = _bound(plan.bytes_moved(p), 0)[0]
            times[f"K8 pass {n} {name}"] = ms
            passes.append(f"{name} {ms:.4f} ({bound:.4f})")
        print(f"K8 passes at {n}^2, ms (bound at the data sheet): "
              + ", ".join(passes) + f"; all {_bound(sum(map(
                  plan.bytes_moved, plan.passes)), 0)[0]:.4f}; card: {card}",
              flush=True)
        del rho, out, mult
        torch.cuda.empty_cache()
    rho = torch.tensor(rng.rand(8191, 16).astype(np.float32), device="cuda")
    out = torch.empty((2, 8191, 16), device="cuda")
    screened_gradients(rho, C5_LAM**2, out=out, out_scale=C5_AMP)
    times["K8 8191x16"] = _events_ms(lambda: screened_gradients(
        rho, C5_LAM**2, out=out, out_scale=C5_AMP), 1)
    print(f"K8 at 8191x16 (whole-line kernel, "
          f"{solve_launches(8191, 16)} launches): {times['K8 8191x16']:.4f} "
          f"ms for one solve (CUDA events); card: {card}", flush=True)
    return times


def coupled_timing_phase(models):
    """Device ms per K7 launch of each physics at its model's shape and its
    main path's K, on the velocity of the model's state: by CUDA events
    around host launches and by CUDA-graph replay (the kernel's own time,
    where a launch is shorter than the host's); per step at K = 1 and the
    cap; and of the plain steps, as many as the main path's launch takes
    (CUDA events)."""
    times = {}
    for physics, sim in models.items():
        cfg = sim.coupled_config()
        f, rho, ext = _k7_inputs(sim)
        params = coupled_params(cfg)
        bufs = [f.clone(), torch.empty_like(f)]
        k = _launch_k(sim)
        # the main path's launch (the one-step kernel for a screened
        # family's single step), the sweep at K = 1 and at its cap
        ks = {"": k, " sweep K1": 1, " cap": coupled_max_k(cfg)}
        cell = {"": rho if cfg.reads_ext and k == 1 else None}
        for tag, k in ks.items():
            def launch(k=k, rho=cell.get(tag)):
                if rho is None:
                    coupled_sweep(bufs[0], bufs[1], ext, cfg, k, params)
                else:
                    _coupled_cell_step(bufs[0], bufs[1], rho, ext, cfg,
                                       params)
                bufs.reverse()

            launch()
            times[physics + tag] = _events_ms(launch, 100)
            times[physics + tag + " graph"] = _graph_ms(launch)
        k = times[physics + " k"] = ks[""]
        g = [f]

        def plain():  # the main path's launch: k plain steps
            g[0] = coupled_sweep_reference(g[0], cfg, k, ext)

        plain()
        times["plain " + physics] = _events_ms(plain, 10)
        print(f"K7 {physics} at {sim.ny}x{sim.nx}: "
              + ", ".join(f"{'main path' if not tag else tag.strip()} K = "
                          f"{k}: {times[physics + tag]:.4f} ms per launch "
                          f"(graph {times[physics + tag + ' graph']:.4f}; "
                          f"{times[physics + tag + ' graph'] / k:.4f} per "
                          "step)" for tag, k in ks.items())
              + f"; {k} plain step(s) {times['plain ' + physics]:.4f} ms "
              "(CUDA events)", flush=True)
        del bufs, g
    return times


def compare_config5(sim, steps=C5_CHECK_STEPS):
    """``steps`` kernel steps of the config-5 runner's state (mc_density,
    K8 into the hook's ext pair, mc_step) against as many eager steps (the
    plain solve inside the plain step); returns max |df|."""
    cfg, ext, lat = sim.config(), sim.ext_planes(), sim.lattice
    _, _, pair, src, lam2, amp = cfg.screened[0]
    params = mc_params(cfg, lat)
    rho = torch.empty_like(sim.rho)
    a, spare = sim.f.clone(), torch.empty_like(sim.f)
    for _ in range(steps):
        mc_density(a, rho, cfg, lat)
        screened_gradients(rho[src], lam2, out=ext[2 * pair:2 * pair + 2],
                           out_scale=amp)
        a, spare = mc_step(a, spare, rho, ext, cfg, lat, params), a
    del spare
    b = sim.f
    for _ in range(steps):
        b = mc_step_reference(b, cfg, lat, ext)
    return _max_diff(a, b)


def config5_phase(card, times):
    """BASELINE config 5 whole at 8192^2: held to the eager step over
    ``C5_CHECK_STEPS`` steps, then ``run(C5_STEPS, timed=True)`` in its
    counted window, then the ``stale_force=8`` variant in its own; each
    fluid's mass conserved to 1e-4."""
    out = {}
    for stale in (None, C5_STALE):
        sim = _porous_runner(8192, screened=True, stale_force=stale)
        label = (f"config 5 8192^2 stale_force={stale}" if stale
                 else "config 5 8192^2")
        if stale is None:
            torch.cuda.reset_peak_memory_stats()
            out["max_err"] = _checked(
                f"K6 + K8 vs the eager step, {label}, {C5_CHECK_STEPS} steps "
                f"(peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB)",
                compare_config5(sim))
            torch.cuda.empty_cache()
        sim.run(stale or 2)  # warm
        m0 = _fluid_mass(sim)
        solves = (C5_STEPS // stale + C5_STEPS % stale if stale
                  else C5_STEPS)
        counts = _window(f"SimulationRunner {label}",
                         lambda: sim.run(C5_STEPS, timed=True),
                         {"K6d": C5_STEPS, "K6s": C5_STEPS,
                          "K8": solve_launches(sim.ny, sim.nx) * solves})
        m1 = _fluid_mass(sim)
        drift = float(np.max(np.abs(m1 - m0) / m0))
        step_ms = sim.num_cells / (sim.last_mlups * 1e6) * 1e3
        print(f"main path SimulationRunner {label} backend={sim.backend}: "
              f"{sim.last_mlups:.1f} MLUPS over {C5_STEPS} steps "
              f"({step_ms:.4f} ms per step), launches {counts['K6d']} "
              f"mc_density + {counts['K6s']} mc_step + {counts['K8']} K8 "
              f"({solves} solves; K8 alone {times['K8 8192']:.4f} ms per "
              f"solve); mass per "
              f"fluid {m0.tolist()} -> {m1.tolist()}, largest relative "
              f"change {drift:.3e} (limit 1e-4); card: {card}", flush=True)
        if not (torch.isfinite(sim.f).all() and drift < 1e-4):
            raise RuntimeError(f"{label}: non-finite state or mass lost")
        out[stale] = dict(launches=counts, solves=solves,
                          mlups=sim.last_mlups)
        del sim
        torch.cuda.empty_cache()
    return out


def _coupled_launches(sim, n, k, shards=1, density="K6d", step="K7"):
    """The launches of a coupled model's ``run(n)`` (or a sharded one's, with
    ``shards`` shards): the rocket yeasts' ``ceil(n / K)`` K7 launches and
    no density pass; per sweep of the screened families' ``S =
    steps_per_call``, one density pass (each solve's source) and ``ceil(S /
    k)`` launches, the rest of ``run(n)`` exact single steps."""
    if sim.coupled_config().physics.startswith("rocket_yeast"):
        return {step: shards * -(-n // k)}
    S = sim.steps_per_call
    sweeps, rest = divmod(n, S)
    return {step: shards * (sweeps * -(-S // k) + rest),
            density: shards * (sweeps + rest)}


def coupled_main_path_phase(runs, card):
    """The coupled models as a user runs them, each ``run(COUPLED_STEPS,
    timed=True)`` in its own counted window (K7's K-step launches; for the
    screened ones K6's density pass and K8 once per sweep); then three
    plain (eager) models at the same sizes, the screened ones solving with
    ``torch.fft``."""
    launches, mlups = {}, {}
    mass0 = {label: _field_masses(sim) for label, sim in runs.items()}
    for label, sim in runs.items():
        K = sim.steps_per_call
        expected = _coupled_launches(sim, COUPLED_STEPS, _launch_k(sim))
        if sim._velocity is not None:
            expected["K8"] = (solve_launches(sim.ny, sim.nx)
                              * expected["K6d"])
        sim.run(K)  # warm
        counts = _window(f"{type(sim).__name__} {sim.ny}x{sim.nx} ({label})",
                         lambda sim=sim: sim.run(COUPLED_STEPS, timed=True),
                         expected)
        launches[label] = {k: v for k, v in counts.items() if v}
        mlups[label] = sim.last_mlups
        if not torch.isfinite(sim.state).all():
            raise RuntimeError(f"{label}: non-finite state")
    plain = {}
    for label, make in (
            ("screened_fisher", lambda: ScreenedFisherWave(
                device="cuda", backend="eager", **SCREENED_FISHER)),
            ("surfactant", lambda: SurfactantNutrientWave(
                device="cuda", backend="eager", **SURFACTANT)),
            ("rocket_yeast", lambda: RocketYeast(device="cuda",
                                                 backend="eager", **ROCKET))):
        ref = make()
        ref.run(2)
        ref.run(10, timed=True)
        plain[label] = ref.last_mlups
        del ref
    for label, sim in runs.items():
        extra = (f"; plain (eager) {plain[label]:.1f} MLUPS"
                 if label in plain else "")
        print(f"main path {type(sim).__name__} {sim.ny}x{sim.nx} ({label}) "
              f"backend={sim.backend}: {mlups[label]:.1f} MLUPS over "
              f"{COUPLED_STEPS} steps, launches {launches[label]}{extra}; "
              f"card: {card}", flush=True)
    return launches, mass0


def coupled_physics_phase(runs, mass0):
    """The repo's own checks (tests/test_waves.py:27-44,
    tests/test_surfactant_rocket.py:52-101) on the main paths' models:
    the screened Fisher wave grows and its velocity points outward on both
    sides of the blob; the surfactant wave grows its population and
    consumes its nutrient; rocket yeast produces surfactant and keeps its
    population >= 0."""
    sfw = runs["screened_fisher"]
    fields = sfw.get_fields()
    cx, cy, off = sfw.nx // 2, sfw.ny // 2, sfw.nx // 8
    right, left = fields["u"][cx + off, cy], fields["u"][cx - off, cy]
    (m0,), (m1,) = mass0["screened_fisher"], _field_masses(sfw)
    print(f"ScreenedFisherWave {sfw.ny}x{sfw.nx} after {sfw.steps_taken} "
          f"steps: mass {m0:.3f} -> {m1:.3f}, u at center +- {off}: "
          f"{right:.3e} / {left:.3e}", flush=True)
    if not (m1 > m0 and right > 0 > left):
        raise RuntimeError("ScreenedFisherWave: no growth or no outward "
                           "velocity")
    for label in ("surfactant", "clumpy_surfactant", "surfactant stale8"):
        (pop0, nut0), (pop1, nut1) = mass0[label], _field_masses(runs[label])
        print(f"{label}: population {pop0:.3f} -> {pop1:.3f}, nutrient "
              f"{nut0:.3f} -> {nut1:.3f}", flush=True)
        if not (pop1 > pop0 and nut1 < nut0):
            raise RuntimeError(f"{label}: population not grown or nutrient "
                               "not consumed")
    for label in ("rocket_yeast", "rocket_yeast_forces_only"):
        sim = runs[label]
        surf = float(sim.state[:, 1].double().sum())
        low = float(sim.state[:, 0].min())
        print(f"{label}: surfactant produced {surf:.3f} (limit 0.1), least "
              f"population value {low:.3e}", flush=True)
        if not (surf > 0.1 and low >= 0.0):
            raise RuntimeError(f"{label}: no surfactant or a negative "
                               "population")


# -- the sharded slice: K9 -------------------------------------------------

# benchmarks/run_all.py:190-214 (bench_sharded_8192): 8192^2 pipe flow
SHARDED_8192 = dict(diameter=1.0, rho=1.0, viscosity=0.1,
                    pressure_grad=-0.01, pipe_length=(8192 - 1.5) / 8191,
                    N=8191)
SHARDED_STEPS = 100  # its run(100): 25 sweeps of HALO_TEMPORAL_K["flow"] = 4
# held to K2 after two whole sweeps, then after a remainder sweep of 1 step
SHARDED_CHECKS = (2 * HALO_TEMPORAL_K["flow"], 2 * HALO_TEMPORAL_K["flow"] + 1)
SHARDED_SHORT_STEPS = 20  # the other sharded models' counted runs
K9_OPS = {"flow": FLOW_OPS, "velocity_inlet": FLOW_OPS,
          "diffusion": DIFFUSION_OPS, "noisy_fisher": NOISY_OPS}


def _cuda_mesh(shape):
    """Four shards on cuda:0."""
    return make_mesh(devices=["cuda"] * 4, shape=shape)


def _shards_diff(sh, want):
    """max |df| between a sharded model's shards and the same cells of a
    global ``[P, ny, nx]`` tensor on the card."""
    H, W = sh.state[0].shape[1:]
    return max(_max_diff(h.f, want[:, h.y0:h.y0 + H, h.x0:h.x0 + W])
               for h in sh.halos.values())


def halo_kernel_phase():
    """K9 against its plain twin on the shards of a random 254x382 state per
    case (HALO_CASES: every physics, flow with and without the obstacle and
    incompressible), cut 2x2, 4x1 and 1x4, at every K from 1 to 8 for the
    physics of K2's row sweep (flow, diffusion, noisy Fisher) and at K = 1,
    2, 3 and the physics' K for the others, from step STEP0. Returns max
    |df| per physics."""
    worst = {}
    for case, (physics, _, _, _) in HALO_CASES.items():
        f, mask = halo_case_state(case, 254, 382, "cuda")
        tol = halo_tolerance(physics)
        for my, mx in HALO_MESHES:
            cuts = shard_cuts(254, 382, my, mx)
            ds = {k: compare_halo_case(case, f, mask, cuts, k, step0=STEP0)
                  for k in halo_case_ks(case)}
            print(f"K9 {case} vs plain twin, 254x382 cut {my}x{mx}: max|df| "
                  + ", ".join(f"k={k} {d:.3e}" for k, d in ds.items())
                  + f" (limit {tol:g})", flush=True)
            if not max(ds.values()) <= tol:
                raise RuntimeError(f"K9 {case}: kernel disagrees, {ds}")
            worst[physics] = max(worst.get(physics, 0.0), *ds.values())
    return worst


def _k9_info(halo, k, physics, kw, ops_per_cell, launches, err):
    """K9 on ``halo`` (``k`` steps, a main-path shard) against its plain
    twin, then the device ms of one launch and of the twin (CUDA events),
    with the launch's bytes (the shard read and written once, its halo read
    once) and operations, for the kernels line. ``err`` takes the
    difference in."""
    out = torch.empty_like(halo.f)

    def launch():
        temporal_halo_step(halo, out, k, physics, step0=STEP0, **kw)

    def plain():
        return temporal_halo_step_reference(halo, k, physics, step0=STEP0,
                                            **kw)

    launch()
    d = _max_diff(out, plain())
    P, H, W = halo.f.shape
    tol = halo_tolerance(physics)
    print(f"K9 {physics} vs plain twin at a main-path {H}x{W} shard, {k} "
          f"steps: max|df| = {d:.3e} (limit {tol:g})", flush=True)
    if not d <= tol:
        raise RuntimeError(f"K9 {physics} disagrees with its plain twin at "
                           f"the main-path shard: {d}")
    ms = _events_ms(launch, 20)
    plain_ms = _events_ms(plain, 3)
    hk = halo.width
    halo_cells = 2 * hk * W + (0 if halo.left is None
                               else 2 * (H + 2 * hk) * hk)
    n_bytes, n_ops = 4 * P * (2 * H * W + halo_cells), H * W * k * ops_per_cell
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    print(f"K9 {physics} at a {H}x{W} shard (P={P}, halo {hk}): {ms:.4f} ms "
          f"per launch of K={k} steps, {ms / k:.4f} per step; bound at K={k} "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / k:.4f} per step; "
          f"plain twin {plain_ms:.4f} ms (CUDA events)", flush=True)
    err = max(err, d)
    return dict(ms=ms, plain_ms=plain_ms, launches=launches, err=err, k=k,
                shape=[P, H, W], bytes=n_bytes, ops=n_ops)


def halo_velocity_phase(inlet, err):
    """K9 velocity_inlet (both outlets) as a sharded run drives it, on the
    401x401 inlet's perturbed state cut 4x1 and 2x2 (shards of unequal
    edges; each sweep's halos cut from the assembled state), 3 sweeps of
    K9's default K against 3 K2 launches; the 4x1 zero-gradient run in its
    own counted window. No sharded model runs this physics (JAX's
    neither)."""
    f0, _ = _inputs(inlet, None)
    k = HALO_TEMPORAL_K["velocity_inlet"]
    counts = None
    for outlet in ("zero_gradient", "velocity"):
        kw = dict(omega=inlet.omega, u_w=inlet.u_w, u_e=inlet.u_e,
                  outlet=outlet, incompressible=False)
        want = f0
        for _ in range(3):
            want = temporal_velocity_step(want, torch.empty_like(want), k,
                                          **kw)
        for mesh in ((4, 1), (2, 2)):
            cuts = shard_cuts(inlet.ny, inlet.nx, *mesh)
            got = [f0.clone()]

            def drive():
                for _ in range(3):
                    g = torch.empty_like(got[0])
                    for y0, x0, H, W in cuts:
                        halo = Halo.cut(got[0], y0, x0, H, W, k)
                        g[:, y0:y0 + H, x0:x0 + W] = temporal_halo_step(
                            halo, torch.empty_like(halo.f), k,
                            "velocity_inlet", **kw)
                    got[0] = g

            if outlet == "zero_gradient" and mesh == (4, 1):
                counts = _window(f"K9 velocity_inlet, {inlet.ny}x{inlet.nx} "
                                 "cut 4x1, 3 sweeps", drive,
                                 {"K9": 3 * len(cuts)})
            else:
                drive()
            d = _max_diff(got[0], want)
            print(f"K9 velocity_inlet outlet={outlet} cut {mesh[0]}x"
                  f"{mesh[1]}, 3 sweeps of {k} vs K2: max|df| = {d:.3e}",
                  flush=True)
            if not d <= KERNEL_TOL:
                raise RuntimeError(f"K9 velocity_inlet disagrees with K2: {d}")
            err = max(err, d)
    y0, x0, H, W = shard_cuts(inlet.ny, inlet.nx, 4, 1)[0]
    kw["outlet"] = inlet.outlet
    return _k9_info(Halo.cut(f0, y0, x0, H, W, k), k, "velocity_inlet", kw,
                    FLOW_OPS, counts["K9"], err)


def sharded_flow_phase():
    """The 8192^2 ShardedPipeFlow on 4x1 and 2x2 meshes of shards on one
    card against PipeFlow through K2, from the same bits (each built from
    the seed), after 9 steps (3 sweeps) and 10 (a remainder sweep). Returns
    the unsharded model, the 4x1 model and max |df|."""
    single = PipeFlow(device="cuda", backend="temporal", **SHARDED_8192)
    f0 = single.state.clone()
    worst, kept = 0.0, None
    for mesh in ((4, 1), (2, 2)):
        sh = ShardedPipeFlow(mesh=_cuda_mesh(mesh), **SHARDED_8192)
        if (sh.backend, sh.steps_per_call) != ("temporal",
                                               HALO_TEMPORAL_K["flow"]):
            raise RuntimeError(f"ShardedPipeFlow {mesh}: {sh.backend} K="
                               f"{sh.steps_per_call}")
        single.state = f0.clone()
        if _shards_diff(sh, single.state) != 0.0:
            raise RuntimeError("ShardedPipeFlow: initial state differs")
        done = 0
        for n in SHARDED_CHECKS:
            single.run(n - done)
            sh.run(n - done)
            done = n
            d = _shards_diff(sh, single.state)
            print(f"ShardedPipeFlow {sh.ny}x{sh.nx} on {mesh[0]}x{mesh[1]} "
                  f"shards (K9) vs PipeFlow (K2), {n} steps: max|df| = "
                  f"{d:.3e} (limit {KERNEL_TOL:g})", flush=True)
            if not d <= KERNEL_TOL:
                raise RuntimeError(f"ShardedPipeFlow {mesh}: {d}")
            worst = max(worst, d)
        if mesh == (4, 1):
            kept = sh
        del sh
        torch.cuda.empty_cache()
    del f0
    return single, kept, worst


def sharded_main_path_phase(single, sh, err, card):
    """The slice's main path: the 8192^2 ShardedPipeFlow on 4x1 shards,
    ``run(100, timed=True)`` in its own counted window, beside the
    unsharded PipeFlow's K2 run; the halo exchange's time per sweep."""
    sh.run(sh.steps_per_call + 1)  # warm both sweep depths
    sweeps = -(-SHARDED_STEPS // sh.steps_per_call)
    counts = _window(f"ShardedPipeFlow {sh.ny}x{sh.nx} on 4x1 shards",
                     lambda: sh.run(SHARDED_STEPS, timed=True),
                     {"K9": 4 * sweeps})
    if not all(torch.isfinite(t).all() for t in sh.state):
        raise RuntimeError("ShardedPipeFlow: non-finite state")
    single.run(TEMPORAL_K + 1)
    _window(f"PipeFlow {single.ny}x{single.nx} (K2)",
            lambda: single.run(SHARDED_STEPS, timed=True),
            {"K2": -(-SHARDED_STEPS // TEMPORAL_K)})
    exchange_ms = _events_ms(lambda: exchange_halos(sh.mesh, sh.halos), 20)
    sweep_ms = sh.num_cells * SHARDED_STEPS / (sh.last_mlups * 1e6) * 1e3 / (
        sweeps)
    print(f"main path ShardedPipeFlow {sh.ny}x{sh.nx} on 4x1 shards of one "
          f"card, K={sh.steps_per_call}: {sh.last_mlups:.1f} MLUPS over "
          f"{SHARDED_STEPS} steps ({counts['K9']} K9 launches, "
          f"{sweep_ms:.4f} ms per sweep); halo exchange {exchange_ms:.4f} ms "
          f"per sweep (CUDA events), share {exchange_ms / sweep_ms:.3f}; "
          f"unsharded PipeFlow (K2) {single.last_mlups:.1f} MLUPS; card: "
          f"{card}", flush=True)
    return _k9_info(next(iter(sh.halos.values())), sh.steps_per_call,
                    "flow", sh.step_kwargs, FLOW_OPS, counts["K9"], err)


def sharded_models_phase(card, worst):
    """ShardedDiffusion over AdvectionDiffusion and the stochastic Fisher
    wave at 2048^2, ShardedMultifield over FisherExpansion 2048^2 F=2 and
    Expansion 1024^2 F=3, each on 2x2 shards of one card, against the
    unsharded model (K2 / K4) after two sweeps and a shorter one, bit for
    bit, noise included; then each ``run(SHARDED_SHORT_STEPS, timed=True)``
    in its own counted window. Returns the K9 row information per
    physics."""
    runs = {"diffusion": (AdvectionDiffusion, ADVECTION, ShardedDiffusion),
            "noisy_fisher": (ReactionAdvectionDiffusionStochastic,
                             STOCHASTIC, ShardedDiffusion),
            "multifield_fisher": (FisherExpansion, FISHER_EXP,
                                  ShardedMultifield),
            "multifield_expansion": (Expansion, EXPANSION,
                                     ShardedMultifield)}
    info = {}
    for physics, (cls, kw, sharded) in runs.items():
        single = cls(device="cuda", **kw)
        sh = sharded(cls(device="cuda", **kw), mesh=_cuda_mesh((2, 2)))
        K = sh.steps_per_call
        n = 2 * K + 1
        single.run(n)
        sh.run(n)
        d = _shards_diff(sh, single.state.reshape(sh.state[0].shape[0],
                                                  sh.ny, sh.nx))
        print(f"{type(sh).__name__}({type(single).__name__}) {sh.ny}x{sh.nx} "
              f"on 2x2 shards (K9 {physics}, K={K}) vs the unsharded "
              f"backend={single.backend}, {n} steps: max|df| = {d:.3e} "
              "(limit 0)", flush=True)
        if d != 0.0:
            raise RuntimeError(f"sharded {physics} differs: {d}")
        counts = _window(f"{type(sh).__name__} {sh.ny}x{sh.nx} ({physics})",
                         lambda: sh.run(SHARDED_SHORT_STEPS, timed=True),
                         {"K9": 4 * -(-SHARDED_SHORT_STEPS // K)})
        print(f"main path {type(sh).__name__}({type(single).__name__}) "
              f"{sh.ny}x{sh.nx} on 2x2 shards: {sh.last_mlups:.1f} MLUPS "
              f"over {SHARDED_SHORT_STEPS} steps; card: {card}", flush=True)
        ops = K9_OPS.get(physics) or _multifield_ops(sh.base)
        info[physics] = _k9_info(next(iter(sh.halos.values())), K, physics,
                                 sh.step_kwargs, ops, counts["K9"],
                                 max(worst[physics], d))
        del single, sh
        torch.cuda.empty_cache()
    return info


def multi_card_phase():
    """With more than one card: the 2x2 ShardedPipeFlow over distinct cards
    (peer copies between them) against the unsharded K2 run, and config 5
    at 1024^2 ``shard_over`` those cards (the density belt exchanged and
    the screened source plane gathered across them, K8 on each) against
    the unsharded runner."""
    n = torch.cuda.device_count()
    if n < 2:
        print("more than one card: not run (this machine has one card)",
              flush=True)
        return
    kw = dict(SHARDED_8192, N=1023, pipe_length=(1024 - 1.5) / 1023)
    devices = [f"cuda:{i % n}" for i in range(4)]
    single = PipeFlow(device="cuda", backend="temporal", **kw)
    sh = ShardedPipeFlow(mesh=make_mesh(devices=devices, shape=(2, 2)), **kw)
    single.run(10)
    sh.run(10)
    d = float(np.abs(sh.state_numpy() - single.state_numpy()).max())
    print(f"ShardedPipeFlow {sh.ny}x{sh.nx} on 2x2 shards over {devices} vs "
          f"PipeFlow (K2), 10 steps: max|df| = {d:.3e}", flush=True)
    if not d <= KERNEL_TOL:
        raise RuntimeError(f"multi-card ShardedPipeFlow disagrees: {d}")
    single = _porous_runner(1024, screened=True)
    sh = _porous_runner(1024, screened=True).shard_over(
        make_mesh(devices=devices, shape=(2, 2)))
    single.run(5)
    sh.run(5)
    d = float(np.abs(sh.state_numpy() - single.state_numpy()).max())
    print(f"config 5 {sh.ny}x{sh.nx} shard_over 2x2 over {devices} vs the "
          f"unsharded runner, 5 steps: max|df| = {d:.3e}", flush=True)
    if not d <= KERNEL_TOL:
        raise RuntimeError(f"multi-card sharded config 5 disagrees: {d}")


# -- the sharded runner and coupled families: K6h, K7h; and P2 -------------

SHARDED_C5_STEPS = 10        # config 5 shard_over 4x1: run(10) after warming
SHARDED_C5_STALE_STEPS = 16  # its stale_force=8 variant: two sweeps
SHARDED_C5_CHECKS = {None: 3, C5_STALE: C5_STALE + 1}  # steps held to K6
SHARDED_COUPLED_STEPS = 64   # each sharded coupled model's counted run
HALO_CHECK_STEPS = 5         # K6h / K7h against K6 / K7 and the twins
P2_SHAPE = (4224, 8192)      # benchmarks/probe_transpose.py's default A
P2_LAUNCHES = 10             # its counted window


def _runner_diff(sh, single):
    """max |df| between a sharded runner's shards and the unsharded
    runner's state, shard by shard."""
    return _shards_diff(sh._sharded, single.f.view(-1, single.ny, single.nx))


def _halo_row(kernel_ms, plain_ms, launches, err, shape, n_bytes, n_ops):
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return dict(ms=kernel_ms, plain_ms=plain_ms, launches=launches, err=err,
                shape=shape, bound_ms=bound_ms, bound_by=bound_by)


def sharded_config5_phase(card, k8_ms):
    """BASELINE config 5 at 8192^2 ``shard_over`` a 4x1 mesh of one card
    (``benchmarks/run_all.py:113-150``), exact and ``stale_force=8``: each
    held to the unsharded K6 + K8 runner over a few steps, then
    ``run(SHARDED_C5_STEPS)`` (or 16) in its own counted window beside the
    unsharded run of the same steps, held to it again; the halo exchange's
    and the density sharing's (belt and source-plane gather) ms per step and
    K8's share of a step. Then K6h at the
    first main-path shard against its twins and timed. Returns MLUPS,
    launches and the K6h row information."""
    out = {}
    per_solve = solve_launches(8192, 8192)
    for stale, steps in ((None, SHARDED_C5_STEPS),
                         (C5_STALE, SHARDED_C5_STALE_STEPS)):
        label = f"config 5 8192^2 stale_force={stale}" if stale else (
            "config 5 8192^2")
        single = _porous_runner(8192, screened=True, stale_force=stale)
        sh = _porous_runner(8192, screened=True,
                            stale_force=stale).shard_over(_cuda_mesh((4, 1)))
        n = SHARDED_C5_CHECKS[stale]
        single.run(n)
        sh.run(n)
        d = _checked(f"{label} shard_over 4x1 (K6h) vs unsharded (K6), {n} "
                     "steps", _runner_diff(sh, single))
        solves = steps // stale + steps % stale if stale else steps
        counts = _window(f"SimulationRunner {label} shard_over 4x1",
                         lambda: sh.run(steps, timed=True),
                         {"K6hd": 4 * steps, "K6hs": 4 * steps,
                          "K8": per_solve * solves})
        _window(f"SimulationRunner {label} unsharded",
                lambda: single.run(steps, timed=True),
                {"K6d": steps, "K6s": steps, "K8": per_solve * solves})
        d = max(d, _checked(f"{label} shard_over 4x1 vs unsharded after "
                            f"{n + steps} steps", _runner_diff(sh, single)))
        if d != 0.0:  # K6h runs K6's tile code on the same values
            raise RuntimeError(f"{label} shard_over 4x1 is not bit-equal to "
                               f"the unsharded run: max|df| {d}")
        runner = sh._sharded
        H, W = runner._H, runner._W
        exchange_ms = _events_ms(lambda: exchange_halos(runner.mesh,
                                                        runner.halos), 20)

        def share():  # the density belt of every step, the solve's plane
            exchange_bands(runner.mesh, runner._rho, H, W, runner._belt)
            gather_bands(runner.mesh, runner._rho, H, W,
                         runner._solve_planes)

        gather_ms = _events_ms(share, 20)
        step_ms = sh.num_cells / (sh.last_mlups * 1e6) * 1e3
        print(f"main path SimulationRunner {label} shard_over 4x1 shards of "
              f"one card: {sh.last_mlups:.1f} MLUPS over {steps} steps "
              f"({step_ms:.4f} ms per step), launches {counts['K6hd']} "
              f"mc_density halo + {counts['K6hs']} mc_step halo + "
              f"{counts['K8']} K8; unsharded {single.last_mlups:.1f} MLUPS; "
              f"halo exchange {exchange_ms:.4f} ms per step, density belt "
              f"+ source-plane gather {gather_ms:.4f} ms per step (one "
              "card: nothing moves), K8 "
              f"{k8_ms:.4f} ms per solve, "
              f"{solves / steps * k8_ms / step_ms:.3f} of a step (CUDA "
              f"events); card: {card}", flush=True)
        if not all(torch.isfinite(t).all() for t in runner.state):
            raise RuntimeError(f"{label} sharded: non-finite state")
        out[stale] = dict(mlups=sh.last_mlups, single=single.last_mlups,
                          launches=counts, err=d, exchange_ms=exchange_ms,
                          gather_ms=gather_ms)
        if stale is None:
            out["rows"] = _k6h_rows(sh, counts, d)
        del single, sh, runner
        torch.cuda.empty_cache()
    return out


def _k6h_rows(sh, counts, err):
    """K6h's two kernels at the main path's first shard (2048 x 8192, C =
    2), against their twins and timed beside them (CUDA events)."""
    runner = sh._sharded
    cfg, ext, params = sh._plan
    lat = sh.lattice
    exchange_halos(runner.mesh, runner.halos)
    halo = runner.halos[(0, 0)]
    rho = runner._rho[runner.mesh.device((0, 0))]
    ext = runner._ext[runner.mesh.device((0, 0))]
    for h in runner.halos.values():
        mc_density_halo(h, rho, cfg, lat)
    out = torch.empty_like(halo.f)
    rows, cols = shard_cells(halo)
    d_rho = _max_diff(rho[:, rows, cols],
                      mc_density_halo_reference(halo, cfg, lat))
    mc_step_halo(halo, out, rho, ext, cfg, lat, params)
    d_step = _max_diff(out, mc_step_halo_reference(halo, rho, ext, cfg, lat))
    print(f"K6h at the main-path 2048x8192 shard vs its twins: mc_density "
          f"max|drho| = {d_rho:.3e}, mc_step max|df| = {d_step:.3e}",
          flush=True)
    if not max(d_rho, d_step) <= KERNEL_TOL:
        raise RuntimeError(f"K6h disagrees with its twins: {d_rho}, {d_step}")
    P, H, W = halo.f.shape
    C = sh.num_populations
    cells, halo_cells = H * W, 2 * halo.width * W
    times = {
        "K6hd": _events_ms(lambda: mc_density_halo(halo, rho, cfg, lat), 20),
        "K6hs": _events_ms(lambda: mc_step_halo(halo, out, rho, ext, cfg, lat,
                                                params), 20),
        "plain K6hd": _events_ms(
            lambda: mc_density_halo_reference(halo, cfg, lat), 2),
        "plain K6hs": _events_ms(
            lambda: mc_step_halo_reference(halo, rho, ext, cfg, lat), 2)}
    print(f"K6h at a {H}x{W} shard (C={C}): mc_density halo "
          f"{times['K6hd']:.4f} ms, mc_step halo {times['K6hs']:.4f} ms per "
          f"launch; plain twins {times['plain K6hd']:.4f} / "
          f"{times['plain K6hs']:.4f} ms (CUDA events)", flush=True)
    f_bytes = 4 * P * (cells + halo_cells)  # the shard and its halo, read
    return {
        "K6hd": _halo_row(times["K6hd"], times["plain K6hd"], counts["K6hd"],
                          max(err, d_rho), [P, H, W],
                          f_bytes + 4 * C * cells, cells * 2 * 9),
        "K6hs": _halo_row(times["K6hs"], times["plain K6hs"], counts["K6hs"],
                          max(err, d_step), [P, H, W],
                          f_bytes + 4 * P * cells + 4 * C * cells
                          + 4 * ext.shape[0] * cells, cells * _mc_ops(sh))}


def mc_halo_phase():
    """K6h against K6 on the whole grid and against its plain twins on 2x2
    shards of one card: the 1024^2 spinodal, a 1024^2 D2Q25 runner and a
    1024^2 zero-gradient runner (configuration (e): clamped interaction,
    radial g force), 5 steps each. Returns max |d|."""
    cuts = shard_cuts(1024, 1024, 2, 2)
    worst = 0.0
    for label, sim in (
            ("spinodal", _spinodal_runner(1024)),
            ("Shan-Chen D2Q25", _spinodal_runner(1024, D2Q25,
                                                 potential="shan_chen",
                                                 params=[1.0])),
            ("zero-gradient (e)", mc_case("e", 1024, 1024, device="cuda"))):
        d_k6, d_twin, d_rho = compare_mc_halo(
            sim.f, sim.config(), sim.lattice, sim.ext_planes(), cuts,
            HALO_CHECK_STEPS)
        # K6h runs K6's tile code on the same values: equal bit for bit,
        # but D2Q25, whose two instantiations nvcc contracts differently
        exact = 0.0 if sim.lattice.q == 9 else KERNEL_TOL
        print(f"K6h {label} 1024^2 {sim.lattice.name} on 2x2 shards, "
              f"{HALO_CHECK_STEPS} steps: max|df| vs K6 {d_k6:.3e} (limit "
              f"{exact:g}), vs the twins {d_twin:.3e}, max|drho| vs K6 "
              f"{d_rho:.3e} (limit {KERNEL_TOL:g})", flush=True)
        if not (max(d_k6, d_rho) <= exact and d_twin <= KERNEL_TOL):
            raise RuntimeError(f"K6h {label} disagrees: {d_k6}, {d_twin}, "
                               f"{d_rho}")
        worst = max(worst, d_k6, d_twin, d_rho)
        del sim
        torch.cuda.empty_cache()
    return worst


def _sharded_coupled_models():
    """The sharded coupled runs: (label, model class, arguments, mesh)."""
    return (
        ("rocket_yeast 4x1", RocketYeast, ROCKET, (4, 1)),
        ("rocket_yeast 2x2", RocketYeast, ROCKET, (2, 2)),
        ("rocket_yeast_forces_only 2x2", RocketYeastForcesOnly,
         ROCKET_FORCES, (2, 2)),
        ("screened_fisher 2x2", ScreenedFisherWave, SCREENED_FISHER, (2, 2)),
        ("screened_fisher stale8 2x2", ScreenedFisherWave,
         dict(SCREENED_FISHER, stale_velocity=C5_STALE), (2, 2)),
        ("surfactant 2x2", SurfactantNutrientWave, SURFACTANT, (2, 2)),
        ("clumpy_surfactant 2x2", ClumpySurfactantNutrientWave, CLUMPY,
         (2, 2)))


def sharded_coupled_phase(card):
    """ShardedCoupled at the coupled models' sizes (``zoo_drive.py``): K7h
    against K7 on the whole grid, its twin and its one-step launches from
    each model's state (its velocity held) at K = 1, 2 and the run's K, on
    the run's mesh; then ``run(64, timed=True)`` in its own counted
    window. Returns per physics the K7h row information (timed at a shard
    of its first run)."""
    rows = {}
    for label, cls, kw, mesh in _sharded_coupled_models():
        sim = cls(device="cuda", **kw)
        cfg = sim.coupled_config()
        f, rho, ext = _k7_inputs(sim)
        cuts = shard_cuts(sim.ny, sim.nx, *mesh)
        sh = ShardedCoupled(sim, mesh=_cuda_mesh(mesh))  # takes sim's state
        worst = [0.0] * 4
        for k in sorted({1, 2, sh._k}):
            d = compare_coupled_halo(f, cfg, ext, cuts, k)
            print(f"K7h {label} {sim.ny}x{sim.nx}, K = {k}: max|df| vs K7 "
                  f"{d[0]:.3e}, vs the twin {d[1]:.3e}, vs {k} one-step "
                  f"launches {d[2]:.3e}, the one-step kernel vs K7 "
                  f"{d[3]:.3e} (limit {KERNEL_TOL:g})", flush=True)
            if not max(d) <= KERNEL_TOL:
                raise RuntimeError(f"K7h {label} disagrees at K = {k}: {d}")
            worst = [max(a, b) for a, b in zip(worst, d)]
        del f, rho
        K = sh.steps_per_call
        sh.run(K)  # warm
        expected = _coupled_launches(sim, SHARDED_COUPLED_STEPS, sh._k, 4,
                                     "K6hd", "K7h")
        if sim._velocity is not None:
            expected["K8"] = (solve_launches(sim.ny, sim.nx)
                              * expected["K6hd"] // 4)
        counts = _window(f"ShardedCoupled({cls.__name__}) {sim.ny}x{sim.nx} "
                         f"({label})",
                         lambda: sh.run(SHARDED_COUPLED_STEPS, timed=True),
                         expected)
        if not all(torch.isfinite(t).all() for t in sh.state):
            raise RuntimeError(f"{label}: non-finite state")
        print(f"main path ShardedCoupled({cls.__name__}) {sim.ny}x{sim.nx} "
              f"({label}) on shards of one card, K = {sh._k}: "
              f"{sh.last_mlups:.1f} MLUPS over {SHARDED_COUPLED_STEPS} "
              f"steps, launches {_nonzero(counts)}; card: {card}",
              flush=True)
        physics = cfg.physics
        if physics not in rows:
            rows[physics] = _k7h_row(sh, cfg, counts["K7h"], max(worst))
        else:
            rows[physics]["err"] = max(rows[physics]["err"], *worst)
        del sim, sh
        torch.cuda.empty_cache()
    return rows


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _k7h_row(sh, cfg, launches, err):
    """K7h at a sharded model's first shard and K against its twin, timed
    beside it (CUDA events, and CUDA-graph replay)."""
    exchange_halos(sh.mesh, sh.halos)
    dev = sh.mesh.device((0, 0))
    rho, ext = sh._rho.get(dev), sh._ext.get(dev)
    if ext is not None:
        for h in sh.halos.values():
            coupled_density_halo(h, rho)
        sh.base._velocity.planes(rho[0], out=ext)
    halo, k = sh.halos[(0, 0)], sh._k
    out = torch.empty_like(halo.f)
    prm = coupled_params(cfg)
    cell = rho if cfg.reads_ext and sh.steps_per_call == 1 else None

    def launch():  # the main path's: the one-step kernel at K = 1
        if cell is None:
            coupled_sweep_halo(halo, out, ext, cfg, k, prm)
        else:
            _coupled_cell_step_halo(halo, out, cell, ext, cfg, prm)

    launch()
    d = _max_diff(out, coupled_sweep_halo_reference(halo, ext, cfg, k))
    if not d <= KERNEL_TOL:
        raise RuntimeError(f"K7h {cfg.physics} at a shard: {d}")
    ms = _events_ms(launch, 100)
    graph_ms = _graph_ms(launch)
    plain_ms = _events_ms(
        lambda: coupled_sweep_halo_reference(halo, ext, cfg, k), 5)
    P, H, W = halo.f.shape
    F, cells = cfg.fields, H * W
    print(f"K7h {cfg.physics} at a {H}x{W} shard, K = {k}: {ms:.4f} ms per "
          f"launch (graph {graph_ms:.4f}; {graph_ms / k:.4f} per step); "
          f"plain twin {plain_ms:.4f} ms (CUDA events)", flush=True)
    hk = halo.width
    halo_cells = 2 * hk * W + (0 if halo.left is None
                               else 2 * (H + 2 * hk) * hk)
    n_bytes = (4 * P * (2 * cells + halo_cells)
               + (8 * cells if cfg.reads_ext else 0))
    row = _halo_row(ms, plain_ms, launches, max(err, d), [P, H, W], n_bytes,
                    cells * k * COUPLED_OPS[cfg.physics])
    row.update(k=k, graph_ms=graph_ms)
    return row


def transpose_phase(card):
    """P2 at the probe's default ``[4224, 8192]``: equal to
    ``x.t().contiguous()`` bit for bit, timed beside it (the plain version
    and the library call are the same call), launched ``P2_LAUNCHES`` times
    in its own counted window."""
    x = torch.randn(P2_SHAPE, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    out = torch.empty(P2_SHAPE[::-1], device="cuda")
    counts = _window(f"P2 transpose {P2_SHAPE}",
                     lambda: [transpose(x, out) for _ in range(P2_LAUNCHES)],
                     {"P2": P2_LAUNCHES})
    d = _max_diff(out, transpose_reference(x))
    if d != 0.0:
        raise RuntimeError(f"P2 differs from x.t().contiguous(): {d}")
    ms = _events_ms(lambda: transpose(x, out), 50)
    library_ms = _events_ms(lambda: transpose_reference(x), 50)
    n_bytes = 8 * x.numel()
    bound_ms, bound_by = _bound(n_bytes, 0)
    print(f"P2 transpose {list(P2_SHAPE)} -> {list(P2_SHAPE[::-1])}: "
          f"{ms:.4f} ms per launch ({n_bytes / ms / 1e6:.1f} GB/s), "
          f"x.t().contiguous() {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); equal bit for bit (CUDA events); card: {card}",
          flush=True)
    return dict(ms=ms, plain_ms=library_ms, launches=counts["P2"], err=d,
                shape=list(P2_SHAPE), bound_ms=bound_ms, bound_by=bound_by)


# -- the flow moments: the readout's kernel --------------------------------

# the flow cells' grids: 4096^2 (bench.py), the cylinder at N = 125, 32x256
MOMENT_SHAPES = ((4096, 4096), (1251, 3751), (32, 256))
# The kernel adds the populations in direction order, the plain moments in
# torch.sum's: each order rounds to a few ulp of the partial sums (|f| sums
# to rho ~ 1), ~1e-7 apart; of max |field| that is below 1e-6 for rho and
# for velocities of order 0.1, as in these states (speeds up to 0.14)
MOMENTS_TOL = 1e-6
MOMENT_READ_BYTES, MOMENT_PLANE_BYTES = 36, 4   # per cell: f once, a plane


def _moving_state(ny, nx):
    """feq of rho in [0.9, 1.1] and u, v in [-0.1, 0.1] times 1 + 1% noise,
    drawn on the card (torch.Generator seed 5)."""
    g = torch.Generator(device="cuda").manual_seed(5)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((ny, nx), generator=g,
                                           device="cuda")
    f = feq_quadratic(uniform(0.9, 1.1), uniform(-0.1, 0.1),
                      uniform(-0.1, 0.1))
    return (f * (1.0 + 0.01 * torch.randn(f.shape, generator=g,
                                         device="cuda"))).contiguous()


def moments_phase(card):
    """``flow_moments`` against the plain moments (``_hydro_plain``) at each
    of ``MOMENT_SHAPES``, both forms: each plane alone and all three, to
    ``MOMENTS_TOL`` of max |field|. Then, per shape, the device ms of one
    plane (``u``, one launch, as ``device_field`` asks) and of all three,
    beside their bounds (bytes) and the plain moments (all three, as the
    readout computed them before the kernel), by CUDA events. Last, a flow
    model's readout in a counted window: ``device_field("u")`` and
    ``("v")`` (the Mach readout) and ``get_fields()``, one launch each."""
    t0 = time.perf_counter()
    rows = []
    for ny, nx in MOMENT_SHAPES:
        f = _moving_state(ny, nx)
        cells = ny * nx
        worst = 0.0
        for incompressible in (False, True):
            want = dict(zip(moments.FIELDS, moments._hydro_plain(
                f, D2Q9, incompressible)))
            for fields in [(n,) for n in moments.FIELDS] + [moments.FIELDS]:
                got = flow_moments(f, fields, incompressible)
                for name, plane in zip(fields, got):
                    scale = float(want[name].abs().max())
                    d = float((plane - want[name]).abs().max()) / scale
                    worst = max(worst, d)
                    if not d <= MOMENTS_TOL:
                        raise RuntimeError(
                            f"moments {ny}x{nx} {fields} incompressible="
                            f"{incompressible}: {name} differs by {d:.3e} of "
                            f"max |{name}| (bound {MOMENTS_TOL})")
        del want, got
        reps = 200 if cells < 1 << 20 else 50
        ms = _events_ms(lambda: flow_moments(f, ("u",)), reps)
        ms3 = _events_ms(lambda: flow_moments(f, moments.FIELDS), reps)
        plain_ms = _events_ms(lambda: moments._hydro_plain(f, D2Q9, False),
                              10)
        bound_ms, bound_by = _bound(
            cells * (MOMENT_READ_BYTES + MOMENT_PLANE_BYTES), 0)
        bound3_ms, _ = _bound(
            cells * (MOMENT_READ_BYTES + 3 * MOMENT_PLANE_BYTES), 0)
        print(f"flow moments {ny}x{nx}: max diff {worst:.3e} of max |field| "
              f"(bound {MOMENTS_TOL}); one plane {ms:.4f} ms (bound "
              f"{bound_ms:.4f}, {100 * bound_ms / ms:.1f}%), three planes "
              f"{ms3:.4f} ms (bound {bound3_ms:.4f}, "
              f"{100 * bound3_ms / ms3:.1f}%), plain moments {plain_ms:.4f} "
              f"ms (CUDA events); card: {card}", flush=True)
        rows.append(dict(shape=[9, ny, nx], err=worst, ms=ms, ms3=ms3,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound3_ms=bound3_ms, bound_by=bound_by))
        del f
    sim = PipeFlow(N=31, device="cuda", **SMALL)
    sim.run(10)
    counts = _window(f"flow readout {sim.ny}x{sim.nx}: device_field u, v "
                     "and get_fields", lambda: (
                         sim.device_field("u"), sim.device_field("v"),
                         sim.get_fields()), {"M": 3})
    print(f"moments_phase: {time.perf_counter() - t0:.2f} s", flush=True)
    return rows, counts["M"]


# -- the Poisson slice: PoissonSolver, RepellingFisherWave, utils -----------

POISSON_N = 1024           # PoissonSolver alone, examples/zoo_drive.py's
POISSON_ITERS = 2000       # solver at 1024^2, a fixed count (tolerance 0)
POISSON_SMALL = 48         # the card against the CPU, 300 fixed iterations
POISSON_SMALL_ITERS = 300
POISSON_SMALL_TOL = 1e-5   # of max|rho|: the card divides by a scalar as a
# reciprocal product and sums in other orders
GRAPH_TOL = 1e-7           # a replayed block against the eager one (equal)
REPELLING = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=128, max_inner_iter=60)
# examples/zoo_drive.py's RepellingFisherWave at N = 128 (its gated mode's
# reuse_tolerance 2e-3); tracking at the budget of tests/test_waves.py
REPELLING_MODES = {"exact": {}, "gated": dict(reuse_tolerance=2e-3),
                   "tracking": dict(inner_per_step=4)}
REPELLING_WARM = 2         # outer steps before the timed run (captures)
REPELLING_STEPS = 20       # timed outer steps per mode
REPELLING_DRIFT = 5e-3     # rho against exact, tests/test_waves.py's bound


def _poisson_solver(n, **kw):
    return PoissonSolver(nx=n, ny=n, sources=np.ones((n, n), np.float32),
                         delta_t=4e-4 * (64 / n) ** 2, delta_x=2.0 / n, **kw)


def _no_kernel_launches(label, drive):
    """Drive a path of this slice with every kernel's launch count at 0;
    it must launch none (plain torch ops and CUDA graphs of them)."""
    torch.cuda.synchronize()
    for wrapper in COUNTERS.values():
        wrapper.launches = 0
    drive()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in COUNTERS.items() if w.launches}
    if counts:
        raise RuntimeError(f"{label} launched hand kernels: {counts}")


def poisson_solver_phase(card):
    """``PoissonSolver`` at 1024^2 for a fixed 2,000 iterations through
    replayed blocks (a replayed block held to the eager one on the card),
    and at 48^2 against the CPU; the uniform source's steady state at 32^2
    (tests/test_poisson.py's residual bound) through the card's blocks."""
    solver = _poisson_solver(POISSON_N, tolerance=0.0, device="cuda")
    loop = solver._loop
    solver.run(loop.check_every)  # captures the block's graph
    replays0, reads0 = loop.replays, loop.reads
    _no_kernel_launches("PoissonSolver", lambda: solver.run(POISSON_ITERS,
                                                            timed=True))
    blocks = POISSON_ITERS // loop.check_every
    if (loop.replays - replays0, loop.reads - reads0) != (blocks, blocks):
        raise RuntimeError(f"PoissonSolver: {loop.replays - replays0} "
                           f"replays, {loop.reads - reads0} reads for "
                           f"{blocks} blocks")
    if (solver.num_iterations != POISSON_ITERS + loop.check_every
            or solver.converged or not torch.isfinite(solver.f).all()):
        raise RuntimeError("PoissonSolver: wrong count or non-finite state")
    print(f"PoissonSolver {POISSON_N}^2, {POISSON_ITERS} iterations "
          f"(tolerance 0, check_every {loop.check_every}): "
          f"{solver.last_mlups:.1f} MLUPS, "
          f"{POISSON_ITERS / solver.last_solve_seconds:.1f} iterations/s, "
          f"{blocks} graph replays and host reads; card: {card}", flush=True)
    # one block replayed against the same block run eagerly on the card
    f0, rho0, react0 = loop.f.clone(), loop.rho.clone(), loop.react.clone()
    loop.run_block(loop.check_every)
    f_e, rho_e, flag_e = loop.block(f0, rho0, react0, loop.check_every)
    d = max(_max_diff(loop.f, f_e), _max_diff(loop.rho, rho_e))
    print(f"PoissonSolver {POISSON_N}^2: a replayed block of "
          f"{loop.check_every} iterations vs the eager block: max|d| = "
          f"{d:.3e}", flush=True)
    if not d <= GRAPH_TOL or bool(loop.flag) != bool(flag_e):
        raise RuntimeError(f"replayed Poisson block differs: {d}")
    cuda = _poisson_solver(POISSON_SMALL, tolerance=0.0, device="cuda")
    cpu = _poisson_solver(POISSON_SMALL, tolerance=0.0, device="cpu")
    cuda.run(POISSON_SMALL_ITERS)
    cpu.run(POISSON_SMALL_ITERS)
    scale = float(cpu.rho.abs().max())
    d = _max_diff(cuda.rho.cpu(), cpu.rho) / scale
    print(f"PoissonSolver {POISSON_SMALL}^2, {POISSON_SMALL_ITERS} "
          f"iterations, card vs CPU: max|d rho| / max|rho| = {d:.3e}",
          flush=True)
    if not d <= POISSON_SMALL_TOL:
        raise RuntimeError(f"PoissonSolver on the card vs the CPU: {d}")
    # tests/test_poisson.py:17-38 on the card
    n, dx = 32, 1.0 / 30
    steady = PoissonSolver(nx=n, ny=n, sources=np.ones((n, n), np.float32),
                           delta_t=dx**2, delta_x=dx, tolerance=1e-7,
                           device="cuda")
    steady.run(20000)
    rho = steady.rho.cpu().numpy()
    lap = (rho[:-2, 1:-1] + rho[2:, 1:-1] + rho[1:-1, :-2] + rho[1:-1, 2:]
           - 4 * rho[1:-1, 1:-1])[3:-3, 3:-3]
    expected = -(5.0 / 9.0) * steady.lb_D * dx**4
    err = float(np.abs(lap - expected).max() / abs(expected))
    print(f"PoissonSolver {n}^2 uniform source on the card: converged "
          f"{steady.converged} after {steady.num_iterations} iterations, "
          f"deep-interior residual {err:.3e} of the source (bound 0.15)",
          flush=True)
    if not (steady.converged and err < 0.15):
        raise RuntimeError("PoissonSolver steady state is wrong")


def repelling_phase(card):
    """``RepellingFisherWave`` at N = 128 in its three modes: warm steps
    (the graphs' captures), then 20 timed outer steps each, with the outer
    steps' MLUPS, the mean inner iterations, host reads and graph replays
    per outer step; the tracking mode's replayed step held to its eager
    step; gated and tracking rho against exact."""
    sims = {}
    for mode, kw in REPELLING_MODES.items():
        sim = RepellingFisherWave(device="cuda", **REPELLING, **kw)
        sim.run(REPELLING_WARM)
        before = (sim.host_reads, sim.inner_iterations, sim.graph_replays)
        _no_kernel_launches(f"RepellingFisherWave {mode}",
                            lambda: sim.run(REPELLING_STEPS, timed=True))
        reads, iters, replays = (
            (b - a) / REPELLING_STEPS for a, b in zip(
                before, (sim.host_reads, sim.inner_iterations,
                         sim.graph_replays)))
        if mode == "tracking":
            iters = sim.inner_per_step
        print(f"RepellingFisherWave N={sim.N} ({sim.ny}x{sim.nx}) {mode}: "
              f"{sim.last_mlups:.3f} MLUPS (outer steps), {iters:.2f} inner "
              f"iterations, {reads:.2f} host reads and {replays:.2f} graph "
              f"replays per outer step; card: {card}", flush=True)
        if replays < 1 or not all(torch.isfinite(t).all() for t in sim.state):
            raise RuntimeError(f"RepellingFisherWave {mode}: no graph replay "
                               "or a non-finite state")
        if mode != "tracking" and reads != replays + (mode == "gated"):
            raise RuntimeError(f"RepellingFisherWave {mode}: a solve ran "
                               "blocks eagerly")
        sims[mode] = sim
    exact_rho = density(sims["exact"].state[0])
    scale = float(exact_rho.abs().max())
    for mode in ("gated", "tracking"):
        d = _max_diff(density(sims[mode].state[0]), exact_rho) / scale
        print(f"RepellingFisherWave {mode} vs exact after "
              f"{REPELLING_WARM + REPELLING_STEPS} steps: max|d rho| / "
              f"max|rho| = {d:.3e} (bound {REPELLING_DRIFT})", flush=True)
        if not d < REPELLING_DRIFT:
            raise RuntimeError(f"RepellingFisherWave {mode} drifts: {d}")
    track = sims["tracking"]
    state = tuple(t.clone() for t in track.state)
    eager = track._step(state)
    track.run(1)
    d = max(_max_diff(a, b) for a, b in zip(track.state, eager))
    print(f"RepellingFisherWave tracking: a replayed outer step vs the eager "
          f"step: max|d| = {d:.3e}", flush=True)
    if not d <= GRAPH_TOL:
        raise RuntimeError(f"replayed tracking step differs: {d}")
    return sims["exact"]


def utils_phase(sim):
    """``save_model`` / ``restore_model`` of a CUDA model's tuple state, the
    float64-grade ``accumulated_sum`` of its populations, and one frame
    rendered on the card with an explicit LUT (which needs no
    matplotlib)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "repelling.npz")
        save_model(path, sim)
        saved = tuple(t.clone() for t in sim.state)
        sim.run(2)
        restore_model(path, sim)
    if not all(t.is_cuda and torch.equal(t, s)
               for t, s in zip(sim.state, saved)):
        raise RuntimeError("restore_model did not restore the CUDA state")
    f = sim.state[0]
    truth = float(f.double().sum())
    f64, f32 = accumulated_sum(f, "f64"), accumulated_sum(f, "f32")
    print(f"accumulated_sum of f {list(f.shape)} on the card: f64 "
          f"{f64!r}, f32 {f32!r}, float64 sum {truth!r}", flush=True)
    if not abs(f64 - truth) <= 1e-6 * abs(truth):
        raise RuntimeError("accumulated_sum(f64) is off")
    lut = np.stack([np.arange(256, dtype=np.uint8)] * 3, axis=1)
    img = render_field(density(f), lut=lut)
    if not (img.is_cuda and img.dtype == torch.uint8
            and tuple(img.shape) == (sim.ny, sim.nx, 3)
            and int(img.min()) == 0 and int(img.max()) == 255):
        raise RuntimeError(f"render_field: {img.shape} {img.dtype}")
    print(f"render_field on the card: {tuple(img.shape)} {img.dtype} "
          f"{img.device}; save_model/restore_model of the tuple state: "
          f"equal on {sim.state[0].device}", flush=True)


NATIVE_PIPE = dict(POISEUILLE, N=15, pipe_length=1.5 * 30.5 / 15)  # 16 x 32
NATIVE_STEPS = 20     # the engine against the eager step on the host
NATIVE_TOL = 1e-5     # tests/test_native.py's bar
NATIVE_CARD = dict(POISEUILLE, N=127, pipe_length=1.5 * 254.5 / 127)
NATIVE_CARD_STEPS = 100  # a device="cuda" native model against K2
NATIVE_CYLINDER_N = 50   # examples/backend_comparison.py's reduced copy
NATIVE_TIMED_STEPS = 100
# the zoo's kernels that backend="auto" runs at examples/zoo_drive.py's
# default sizes (RepellingFisherWave, PoissonSolver and ScreenedPoisson
# have none)
ZOO_KERNELS = ("K2", "K2v", "K3", "K3 diffusion family", "K4", "K6d", "K6s",
               "K7", "K8")


def _host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (model name, vendor,
    family and model numbers) and the threads the C++ engine's OpenMP runs
    on (the cores this process may use, or OMP_NUM_THREADS)."""
    info = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    threads = os.environ.get("OMP_NUM_THREADS") or len(
        os.sched_getaffinity(0))
    return (f"model name {info.get('model name', '?')!r}, "
            f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')}"
            f" model {info.get('model', '?')}, {threads} OpenMP threads")


def native_phase(card):
    """The C++ CPU engine (``backend="native"``): on the card's host
    against the eager step with an obstacle in both equilibria, a
    ``device="cuda"`` native model against K2, and its MLUPS on the
    reference's cylinder at N = 50, labelled with the host CPU (it is not a
    card number). The native runs launch no hand kernel."""
    t0 = time.perf_counter()
    mask = np.zeros((16, 32), np.int32)
    mask[6:10, 12:18] = 1
    for eq in ("compressible", "incompressible"):
        kw = dict(NATIVE_PIPE, obstacle_mask=mask, equilibrium=eq,
                  device="cpu")
        nat = PipeFlowObstacles(backend="native", **kw)
        eager = PipeFlowObstacles(backend="eager", **kw)
        nat.run(NATIVE_STEPS)
        eager.run(NATIVE_STEPS)
        d = _max_diff(nat.state, eager.state)
        print(f"native engine vs eager step, {nat.ny}x{nat.nx} with an "
              f"obstacle, {eq}, {NATIVE_STEPS} steps on the host: max|df| "
              f"= {d:.3e} (bound {NATIVE_TOL})", flush=True)
        if not d < NATIVE_TOL:
            raise RuntimeError(f"native engine ({eq}) differs from the "
                               f"eager step: {d}")
    nat = PipeFlow(backend="native", device="cuda", **NATIVE_CARD)
    k2 = PipeFlow(backend="temporal", device="cuda", **NATIVE_CARD)
    _no_kernel_launches("native on a CUDA state",
                        lambda: nat.run(NATIVE_CARD_STEPS))
    _window("K2 beside the native model", lambda: k2.run(NATIVE_CARD_STEPS),
            {"K2": NATIVE_CARD_STEPS // TEMPORAL_K})
    d = _max_diff(nat.state, k2.state)
    print(f"native model on device='cuda' ({nat.ny}x{nat.nx}, state "
          f"{nat.state.device}) vs K2, {NATIVE_CARD_STEPS} steps: max|df| = "
          f"{d:.3e} (bound {NATIVE_TOL})", flush=True)
    if not (nat.state.is_cuda and d < NATIVE_TOL):
        raise RuntimeError(f"native model on the card differs from K2: {d}")
    host = _host_cpu()
    for device in ("cpu", "cuda"):
        cyl = PipeFlowCylinder(N=NATIVE_CYLINDER_N, backend="native",
                               device=device, **CYLINDER)
        cyl.run(5)  # warm: threads, pages
        _no_kernel_launches("native cylinder", lambda: cyl.run(
            NATIVE_TIMED_STEPS, timed=True))
        if not torch.isfinite(cyl.state).all():
            raise RuntimeError("native cylinder: non-finite state")
        print(f"native engine, cylinder N={NATIVE_CYLINDER_N} "
              f"({cyl.ny}x{cyl.nx}), run({NATIVE_TIMED_STEPS}) on "
              f"device={device}{' (one copy each way included)' if device == 'cuda' else ''}: "
              f"{cyl.last_mlups:.1f} MLUPS on the host CPU ({host}); "
              f"card beside it: {card}", flush=True)
    print(f"native_phase: {time.perf_counter() - t0:.2f} s", flush=True)


def examples_phase(card):
    """``examples_torch`` on the card: ``zoo_drive.main()`` at its default
    sizes (every row ok; every model with a kernel on a kernel backend),
    ``backend_comparison.main(steps=1000)`` on the full 3751x1251 grid
    (K2) with the native row, and ``poiseuille_verification`` at N = 10
    and 50 (K3; the RMS error falls with N). Each in a counted window."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for wrapper in COUNTERS.values():
        wrapper.launches = 0
    rows = zoo_drive.main()  # raises when a row is not ok
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in COUNTERS.items() if w.launches}
    print(f"zoo_drive: launches {counts}; card: {card}", flush=True)
    eager = [row[0] for row in rows if row[0] not in zoo_drive.NO_KERNEL
             and ("eager" in row[1] or row[1] == "-")]
    missing = [k for k in ZOO_KERNELS if not counts.get(k)]
    if eager or missing:
        raise RuntimeError(f"zoo_drive: models on no kernel {eager}, "
                           f"kernels never launched {missing}")
    result = {}
    _window("backend_comparison", lambda: result.update(
        backend_comparison.main(steps=1000)),
        {"K2": 1000 // TEMPORAL_K})
    native_rows = [k for k in result["rows"] if "native" in k]
    if (result["grid"] != [1251, 3751] or result["backend"] != "temporal"
            or len(native_rows) != 1 or not all(
                np.isfinite(v) and v > 0 for v in result["rows"].values())):
        raise RuntimeError(f"backend_comparison: {result}")
    print(f"backend_comparison: {result['rows']} (the native row on the "
          f"host CPU, {_host_cpu()}); card: {card}", flush=True)
    poiseuille = []
    with tempfile.TemporaryDirectory() as d:
        _window("poiseuille_verification N=10, 50", lambda: poiseuille.extend(
            poiseuille_verification.main(os.path.join(d, "p.png"),
                                         Ns=(10, 50))), {"K3": 2, "M": 2})
    rms = [row["rms"] for row in poiseuille]
    if (not all(np.isfinite(rms)) or not rms[1] < rms[0]
            or {row["backend"] for row in poiseuille} != {"resident"}):
        raise RuntimeError(f"poiseuille_verification: {poiseuille}")
    print(f"poiseuille_verification: RMS {rms[0]:.4e} (N=10) -> "
          f"{rms[1]:.4e} (N=50) m/s; card: {card}", flush=True)
    print(f"examples_phase: {time.perf_counter() - t0:.2f} s", flush=True)


def _field_masses(sim):
    """Float64 mass of each field of a coupled model."""
    return sim._fields4(sim.state).double().sum(dim=(0, 2, 3)).tolist()


def _mc_ops(sim):
    """Operations per cell-step of K6's step (counted from its arithmetic):
    per fluid and direction the moments (3) and feq + Guo + BGK (25), per
    fluid the drag and velocity (30), per interaction term two
    pseudopotentials and four multiply-adds (14)."""
    q, C = sim.lattice.q, sim.num_populations
    terms = sum(8 if h[6] == 1 else 24 for h in sim.config().interactions)
    return C * q * 28 + 30 * C + 14 * terms


def _bound(n_bytes, n_ops):
    """The least time the card could take (ms): ``n_bytes`` (each input read
    and each output written once) over the data sheet's HBM rate, or
    ``n_ops`` over its float32 rate, whichever is larger."""
    t_bytes = n_bytes / H100_SXM_HBM
    t_ops = n_ops / H100_SXM_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _multifield_ops(sim):
    """Operations per cell-step of a multifield model's update."""
    noisy = (int(np.count_nonzero(sim.lb_Dg)) if sim.physics == "expansion"
             else 0)
    return FIELD_OPS * sim.num_fields + POPULATION_NOISE_OPS * noisy


def main():
    card = device_phase()
    build_phase()
    main_sim = PipeFlow(N=4095, device="cuda", **BENCH_PHYS)
    small = PipeFlow(N=31, device="cuda", **SMALL)
    cyl = PipeFlowCylinder(N=125, device="cuda", **CYLINDER)
    inlet = PipeFlowVelocityInlet(device="cuda")  # the reference's defaults
    inlet_k3 = PipeFlowVelocityInlet(device="cuda", backend="resident")
    adv = AdvectionDiffusion(device="cuda", **ADVECTION)
    sto = ReactionAdvectionDiffusionStochastic(device="cuda", **STOCHASTIC)
    wave = NoisyAdvectedFisherWave(device="cuda", **NOISY_WAVE)
    rad = ReactionAdvectionDiffusion(device="cuda", **REACTION)
    fe = FisherExpansion(device="cuda", **FISHER_EXP)
    ex = Expansion(device="cuda", **EXPANSION)
    sims = {"main": main_sim, "small": small, "cylinder": cyl,
            "inlet": inlet, "inlet_k3": inlet_k3, "adv": adv, "sto": sto,
            "wave": wave, "rad": rad, "fisher": fe, "expansion": ex}
    shapes = {k: (sim.backend, sim.ny, sim.nx) for k, sim in sims.items()}
    print(f"backend='auto' picked {shapes}", flush=True)
    if shapes != {"main": ("temporal", 4096, 4096),
                  "small": ("resident", 32, 256),
                  "cylinder": ("temporal", 1251, 3751),
                  "inlet": ("temporal", 401, 401),
                  "inlet_k3": ("resident", 401, 401),
                  "adv": ("temporal", 2048, 2048),
                  "sto": ("temporal", 2048, 2048),
                  "wave": ("resident", 256, 256),
                  "rad": ("resident", 512, 512),
                  "fisher": ("temporal", 2048, 2048),
                  "expansion": ("temporal", 1024, 1024)}:
        raise RuntimeError(f"unexpected backends or grids {shapes}")
    max_err = kernel_phase(main_sim, small, cyl, inlet)
    max_err.update(diffusion_kernel_phase(adv, sto, wave, rad, inlet))
    max_err.update(multifield_kernel_phase(fe, ex))
    max_err.update(mc_kernel_phase())
    times, steps, copy_bw = timing_phase(main_sim, small, inlet)
    more_times, more_steps = diffusion_timing_phase(adv, sto, wave, rad,
                                                    inlet)
    times.update(more_times)
    steps.update(more_steps)
    more_times, more_steps, band_rows = multifield_timing_phase(fe, ex)
    times.update(more_times)
    steps.update(more_steps)
    k_sweep_phase(main_sim, adv, sto, card)
    multifield_k_sweep_phase(fe, ex, card)
    launches = main_path_phase(main_sim, small, inlet, card, times, copy_bw)
    mass0 = float(density(adv.state).double().sum())
    more_launches, eta = diffusion_main_path_phase(adv, sto, wave, rad,
                                                   inlet_k3, card)
    launches.update(more_launches)
    ex_rho0 = density(ex.state).double().sum(dim=(1, 2))
    launches.update(multifield_main_path_phase(fe, ex, card))
    physics_phase(cyl)
    diffusion_physics_phase(adv, sto, wave, rad, eta, mass0)
    multifield_physics_phase(fe, ex, ex_rho0)
    big, mc_times = mc_main_path_phase(card, max_err)
    launches.update({k: big["launches"][k] for k in ("K6d", "K6s")})
    mc_physics_phase()
    max_err.update(spectral_kernel_phase())
    runs = _coupled_models()
    models = {k: sim for k, sim in runs.items() if "stale" not in k}
    shapes = {k: (sim.backend, sim.ny, sim.nx) for k, sim in runs.items()}
    print(f"the coupled models: {shapes}", flush=True)
    if shapes != {"screened_fisher": ("kernel", 1024, 1024),
                  "surfactant": ("kernel", 512, 512),
                  "clumpy_surfactant": ("kernel", 512, 512),
                  "rocket_yeast": ("kernel", 1024, 1024),
                  "rocket_yeast_forces_only": ("kernel", 1024, 1024),
                  "screened_fisher stale8": ("kernel", 1024, 1024),
                  "surfactant stale8": ("kernel", 1024, 1024)}:
        raise RuntimeError(f"unexpected backends or grids {shapes}")
    k7_err = coupled_kernel_phase(runs)
    k8_times = spectral_timing_phase(card)
    k7_times = coupled_timing_phase(models)
    c5 = config5_phase(card, k8_times)
    coupled_launches, mass0 = coupled_main_path_phase(runs, card)
    coupled_physics_phase(runs, mass0)
    k9_err = halo_kernel_phase()
    k9 = {"velocity_inlet": halo_velocity_phase(inlet,
                                                k9_err["velocity_inlet"])}
    single, sharded, flow_err = sharded_flow_phase()
    k9["flow"] = sharded_main_path_phase(single, sharded,
                                         max(flow_err, k9_err["flow"]), card)
    del single, sharded
    torch.cuda.empty_cache()
    k9.update(sharded_models_phase(card, k9_err))
    c5_sharded = sharded_config5_phase(card, k8_times["K8 8192"])
    k6h_err = mc_halo_phase()
    k7h = sharded_coupled_phase(card)
    p2 = transpose_phase(card)
    flow_moment_rows, readout_launches = moments_phase(card)
    multi_card_phase()
    poisson_solver_phase(card)
    utils_phase(repelling_phase(card))
    native_phase(card)
    examples_phase(card)
    k2, k3 = "lb2d_tpu/ops/fused.py:888", "lb2d_tpu/ops/fused.py:1193"
    kernels = {  # key: (wrapper, source, TPU kernel, model, ops per cell)
        "K1": ("pipe_step", "pipe_step.cu", "lb2d_tpu/ops/fused.py:682",
               main_sim, FLOW_OPS),
        "K2": ("temporal_pipe_step", "temporal_step.cu", k2, main_sim,
               FLOW_OPS),
        "K3": ("resident_pipe_run", "resident_run.cu", k3, small, FLOW_OPS),
        "K2v": ("temporal_velocity_step", "temporal_step.cu", k2, inlet,
                FLOW_OPS),
        "K2d": ("temporal_diffusion_step (diffusion)", "temporal_step.cu",
                k2, adv, DIFFUSION_OPS),
        "K2n": ("temporal_diffusion_step (noisy_fisher)", "temporal_step.cu",
                k2, sto, NOISY_OPS),
        "K3d": ("resident_diffusion_run (diffusion)", "resident_run.cu", k3,
                rad, DIFFUSION_OPS),
        "K3n": ("resident_diffusion_run (noisy_fisher)", "resident_run.cu",
                k3, wave, NOISY_OPS),
        "K3v": ("resident_velocity_run", "resident_run.cu", k3, inlet,
                FLOW_OPS),
        "P1": ("normals", "normals.cu", "benchmarks/tpu_tests.py:25", sto,
               NORMAL_OPS),
    }
    k4 = "lb2d_tpu/ops/fused.py:1539"
    kernels.update({
        "K4f": ("temporal_multifield_step (fisher)", "multifield_step.cu",
                k4, fe, _multifield_ops(fe)),
        "K4e": ("temporal_multifield_step (expansion)", "multifield_step.cu",
                k4, ex, _multifield_ops(ex)),
        "K5": ("expansion_band_step", "multifield_step.cu",
               "lb2d_tpu/ops/fused.py:1784", ex, _multifield_ops(ex)),
    })
    rows = []
    k6 = "lb2d_tpu/ops/fused_mc.py:230"
    for key, name, per_cell, ops in (
            ("K6d", "mc_density", 80, 2 * 9), ("K6s", "mc_step", 152,
                                                big["ops"])):
        bound_ms, bound_by = _bound(big["cells"] * per_cell,
                                    big["cells"] * ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "lb2d_tpu_torch/csrc/mc_step.cu", "replaces": k6,
            "launches": launches[key], "max_abs_err": max_err[key],
            "ms": mc_times["8192"][key], "plain_ms": mc_times["8192"][
                "plain " + key],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the same
            "steps_per_launch": 1, "shape": [2, 8192, 8192]})
    for key, (name, src, tpu, sim, ops) in kernels.items():
        cells = sim.num_cells
        per_cell = 4 if key == "P1" else BYTES_PER_CELL
        shape = [sim.ny, sim.nx]
        if key in ("K4f", "K4e"):
            per_cell = BYTES_PER_CELL * sim.num_fields
            shape = [sim.num_fields, sim.ny, sim.nx]
        elif key == "K5":  # reads the band, writes its central 2K rows
            cells = (band_rows + 2 * steps[key]) * sim.nx
            per_cell = BYTES_PER_CELL // 2 * sim.num_fields
            shape = [sim.num_fields, band_rows, sim.nx]
        # K5 computes at least the 2K emitted rows at each of its K steps
        work = (2 * steps[key] * sim.nx if key == "K5" else sim.num_cells)
        bound_ms, bound_by = _bound(cells * per_cell,
                                    work * steps[key] * ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"lb2d_tpu_torch/csrc/{src}", "replaces": tpu,
            "launches": launches[key], "max_abs_err": max_err[key],
            "ms": times[key], "plain_ms": times["plain " + key],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the same
            "steps_per_launch": steps[key],
            "ms_per_step": times[key] / steps[key], "shape": shape})
        if key in ("K5", "P1"):  # their launches are shorter than the host's
            rows[-1]["graph_ms"] = times[key + " graph"]
    k7 = "lb2d_tpu/ops/fused_coupled.py"
    k7_tpu = (("rocket_yeast", f"{k7}:105"),
              ("rocket_yeast_forces_only", f"{k7}:105"),
              ("screened_fisher", f"{k7}:202"), ("surfactant", f"{k7}:251"),
              ("clumpy_surfactant", f"{k7}:251"))
    for physics, tpu in k7_tpu:
        sim = models[physics]
        cfg, cells = sim.coupled_config(), sim.num_cells
        F, k = cfg.fields, k7_times[physics + " k"]
        # f read and written once a launch, plus the velocity planes
        per_cell = 72 * F + (8 if cfg.reads_ext else 0)
        bound_ms, bound_by = _bound(cells * per_cell,
                                    cells * k * COUPLED_OPS[physics])
        rows.append({
            "name": f"coupled_sweep ({physics})", "route": "cuda",
            "source": "lb2d_tpu_torch/csrc/coupled_step.cu", "replaces": tpu,
            "launches": coupled_launches[physics]["K7"],
            "max_abs_err": k7_err[physics], "ms": k7_times[physics],
            "graph_ms": k7_times[physics + " graph"],
            "plain_ms": k7_times["plain " + physics],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the same
            "steps_per_launch": k,
            "ms_per_step": k7_times[physics + " graph"] / k,
            # the sweep of one step and at its cap (8), by graph replay
            "sweep_k1_graph_ms": k7_times[physics + " sweep K1 graph"],
            "cap_graph_ms_per_step": k7_times[physics + " cap graph"] / 8,
            "shape": [F, sim.ny, sim.nx]})
    cells = 8192 * 8192
    # rho read once, s (xg, yg) written once; a radix-2 real forward and a
    # complex inverse 2-D FFT (2.5 and 5 log2(cells) flops per cell) and
    # the screen's 20
    bound_ms, bound_by = _bound(cells * 12,
                                cells * (7.5 * np.log2(cells) + 20))
    rows.append({
        "name": "screened_gradients", "route": "cuda",
        "source": "lb2d_tpu_torch/csrc/spectral_dft.cu",
        "replaces": "lb2d_tpu/ops/dft_pallas.py:146",
        "launches": c5[None]["launches"]["K8"],
        "launches_per_solve": solve_launches(8192, 8192),
        "solves": c5[None]["solves"],
        "max_abs_err": max_err["K8 abs"], "max_rel_err": max_err["K8"],
        "ms": k8_times["K8 8192"], "plain_ms": k8_times["plain K8 8192"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        # per solve (its launches_per_solve); torch.fft (cuFFT): fft2, the
        # precomputed multiplier, ifft2
        "library_ms": k8_times["library K8 8192"],
        "steps_per_launch": 1, "shape": [8192, 8192]})
    for physics, info in k9.items():
        bound_ms, bound_by = _bound(info["bytes"], info["ops"])
        src = ("multifield_step.cu" if physics.startswith("multifield")
               else "halo_step.cu")
        rows.append({
            "name": f"K9 {physics}", "route": "cuda",
            "source": f"lb2d_tpu_torch/csrc/{src}",
            "replaces": "lb2d_tpu/ops/fused_halo.py:93",
            "launches": info["launches"], "max_abs_err": info["err"],
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the same
            "steps_per_launch": info["k"],
            "ms_per_step": info["ms"] / info["k"], "shape": info["shape"]})
    halo_rows = [("mc_density halo", "mc_step.cu", f"{k6}", dict(
        c5_sharded["rows"]["K6hd"], err=max(
            c5_sharded["rows"]["K6hd"]["err"], k6h_err))),
                 ("mc_step halo", "mc_step.cu", f"{k6}", dict(
                     c5_sharded["rows"]["K6hs"], err=max(
                         c5_sharded["rows"]["K6hs"]["err"], k6h_err)))]
    for physics, tpu in k7_tpu:
        halo_rows.append((f"coupled_sweep halo ({physics})",
                          "coupled_step.cu", tpu, k7h[physics]))
    halo_rows.append(("transpose", "transpose.cu",
                      "benchmarks/probe_transpose.py:28", p2))
    for name, src, tpu, info in halo_rows:
        rows.append({
            "name": name, "route": "cuda",
            "source": f"lb2d_tpu_torch/csrc/{src}", "replaces": tpu,
            "launches": info["launches"], "max_abs_err": info["err"],
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": info["bound_ms"], "bound_by": info["bound_by"],
            # P2: x.t().contiguous(), which is its plain version too; no
            # single PyTorch call computes a shard's LB step
            "library_ms": info["plain_ms"] if name == "transpose" else None,
            "steps_per_launch": info.get("k", 1), "shape": info["shape"]})
        if "graph_ms" in info:
            rows[-1].update(graph_ms=info["graph_ms"],
                            ms_per_step=info["graph_ms"] / info["k"])
    for info in flow_moment_rows:  # one row per shape: a plane per launch
        rows.append({
            "name": "flow_moments", "route": "cuda",
            "source": "lb2d_tpu_torch/csrc/moments.cu",
            "replaces": None,  # the JAX moments are plain jnp
            # in the counted readout window: two device_field, a get_fields
            "launches": readout_launches,
            "max_abs_err": None, "max_rel_err": info["err"],
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": info["bound_ms"], "bound_by": info["bound_by"],
            "three_planes_ms": info["ms3"],
            "three_planes_bound_ms": info["bound3_ms"],
            "library_ms": None,  # no single PyTorch call computes the same
            "steps_per_launch": None, "shape": info["shape"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
