"""K7's K-step row sweep on the CPU: its schedule emulated in plain torch,
its plain twins against JAX's K-step kernel, and the run loops of the
coupled models and ``ShardedCoupled`` at K > 1.

The kernel (``lb2d_tpu_torch/csrc/coupled_step.cu``) runs only on the
card. :func:`lb2d_tpu_torch.ops.coupled_sweep.emulate` does what its blocks
do with the numbers of :mod:`lb2d_tpu_torch.ops.sweep` (the plan's strips
and segments, the rings and their slots at each level's lag, the density
rings, the prefetch, which level computes which row at which phase); every
ring read checks the phase of the row it finds. The emulated sweep must
equal K plain steps bit for bit for all five physics at K = 1, 2 and 3, on
a 37x131 grid cut into strips and segments, and on the shards of 2x2, 1x3
and 3x1 cuts of it (x halos on the first two, x wrapping within the shard
on the last) read through ``Halo.extended()``, where it must also equal
K7h's plain twin.

The port's twin of the rocket-yeast sweep is held to JAX's K-step kernel
(``make_rocket_yeast_step``, interpret mode) at ``k_steps=3``, N = 128,
within 5e-7, as ``tests/test_surfactant_rocket.py`` holds JAX's kernel to
its XLA step. The kernel backend's run loop, which the card runs, is
driven here with the wrappers' CPU path (their plain twins): ``run(11)``
of a rocket yeast is two launches of 4 steps and one of 3, and equals
JAX's XLA steps; a ``stale_velocity=10`` sweep of the screened Fisher wave is one
solve and launches of 8 and 2. ``ShardedCoupled`` at K = 3 and 8 equals
the unsharded run on 4x1 and 2x2 meshes.
"""

import numpy as np
import pytest
import torch

import jax
import lb2d_tpu.models as jax_models
from lb2d_tpu_torch import models as torch_models
from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.halo_cases import shard_cuts
from lb2d_tpu_torch.models import waves
from lb2d_tpu_torch.ops import sweep
from lb2d_tpu_torch.ops.coupled_sweep import emulate
from lb2d_tpu_torch.ops.fused_coupled import (
    COUPLED_PHYSICS,
    COUPLED_TEMPORAL_K,
    CoupledConfig,
    coupled_max_k,
    coupled_reach,
    coupled_sweep,
    coupled_sweep_halo_reference,
    coupled_sweep_reference,
    density_in_order,
    _coupled_cell_step,
)
from lb2d_tpu_torch.ops.fused_halo import Halo
from lb2d_tpu_torch.ops.stream import stream
from lb2d_tpu_torch.parallel import ShardedCoupled, make_mesh, sharded

torch.set_num_threads(1)

NY, NX = 37, 131
SLOTS = 8  # resident blocks the plan fills: segments of 2-6 strips
ATOL, RTOL = 5e-7, 1e-5
ROCKET = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=128,
              G_chen=-0.1)


def _config(physics):
    return CoupledConfig(physics, omega=1.6, lb_G=1e-3, omega2=1.2,
                         lb_G2=2e-3, epsilon=0.05, rho_o=1.0, G_chen=-0.5,
                         c_o=0.25, alpha=2.0)


def _state(cfg, seed=7):
    """A random state near rest and a random velocity field (global)."""
    rs = np.random.RandomState(seed)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    f = torch.tensor(w * (0.2 + rs.rand(9, cfg.fields, NY, NX)),
                     dtype=torch.float32)
    ext = torch.tensor(0.02 * (rs.rand(2, NY, NX) - 0.5),
                       dtype=torch.float32)
    return f, ext


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_emulated_sweep_equals_k_plain_steps(physics, k):
    cfg = _config(physics)
    f, ext = _state(cfg)
    plan = sweep.plan(NY, NX, coupled_reach(cfg) * k, cfg.fields, SLOTS)
    assert plan.strips >= 2 and plan.segments >= 2
    got = emulate(f, cfg, k, SLOTS, ext)
    assert torch.equal(got, coupled_sweep_reference(f, cfg, k, ext))


CUTS = [(2, 2), (1, 3), (3, 1)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("mesh", CUTS, ids=[f"{a}x{b}" for a, b in CUTS])
@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_emulated_shard_sweep_equals_the_grid(physics, mesh, k):
    """K7h's schedule on each shard's halo-extended region (halos of K
    reaches) equals K plain steps of the whole grid there, and the twin."""
    cfg = _config(physics)
    f, ext = _state(cfg, seed=k)
    want = coupled_sweep_reference(f, cfg, k, ext)
    flat = f.reshape(9 * cfg.fields, NY, NX)
    hk = coupled_reach(cfg) * k
    for y0, x0, H, W in shard_cuts(NY, NX, *mesh):
        halo = Halo.cut(flat, y0, x0, H, W, hk)
        assert (halo.left is None) == (W == NX)
        region = halo.extended().view(9, cfg.fields, H + 2 * hk, W + 2 * hk)
        got = emulate(region, cfg, k, 2, ext, shard=(y0, x0, NY, NX, hk))
        assert torch.equal(got, want[..., y0:y0 + H, x0:x0 + W])
        twin = coupled_sweep_halo_reference(halo, ext, cfg, k)
        assert torch.equal(twin.view(got.shape), got)


def test_the_sweeps_geometry():
    """Shared memory of one block against the 227 KB it may have, blocks
    per SM, the most steps per launch, and the plan at the main paths'
    grids: the rocket yeasts' density stage lags four phases and reaches
    two cells a step."""
    assert [sweep.coupled_smem_bytes(k, 2, 1) for k in (1, 4, 8)] == [
        30720, 109056, 213504]
    assert [sweep.coupled_smem_bytes(k, F, 0) for k in (1, 8)
            for F in (1, 2)] == [18432, 18432, 115200, 115200]
    assert sweep.coupled_smem_bytes(8, 2, 0) == sweep.smem_bytes(8, 2)
    assert [sweep.coupled_blocks_per_sm(k, 2, 1) for k in (2, 4, 8)] == [
        4, 2, 1]
    for physics in COUPLED_PHYSICS:
        cfg = _config(physics)
        assert coupled_max_k(cfg) == 8
        assert COUPLED_TEMPORAL_K[physics] == (4 if cfg.reads_neighbours
                                               else 8)
        assert (coupled_reach(cfg), sweep.coupled_lag(cfg.belt)) == (
            (2, 4) if cfg.reads_neighbours else (1, 2))
    # 1024^2 rocket yeast at K = 8 (one block per SM of 132): 32 strips of
    # 32 stored columns, 4 segments; at K = 4 (two per SM): 22 of 47, 12
    assert sweep.plan(1024, 1024, 16, 2, 132) == (32, 32, 4, 256)
    assert sweep.plan(1024, 1024, 8, 2, 264) == (22, 47, 12, 86)


def test_rocket_yeast_sweep_twin_matches_jax_kernel():
    """Two 3-step sweeps of the port's twin (K7's CPU path) against JAX's
    temporally blocked rocket-yeast kernel at k_steps=3 (interpret mode)."""
    jax_sim = jax_models.RocketYeast(**ROCKET)
    sim = torch_models.RocketYeast(device="cpu", **ROCKET)
    raw = jax_sim._make_kernel_step(k_steps=3, interpret=True)
    assert jax_sim.steps_per_call == 3
    kstep = jax.jit(raw)
    want = kstep(kstep(jax_sim.state))
    cfg = sim.coupled_config()
    f = sim._fields4(sim.state)
    for _ in range(2):
        f = coupled_sweep(f, torch.empty_like(f), None, cfg, 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(want).reshape(f.shape),
                               atol=ATOL, rtol=RTOL)


def _kernel_loop(sim, monkeypatch):
    """The model's kernel-backend run loop, its K7 launches recorded (steps,
    and whether the one-step kernel's densities came along) and run through
    the wrapper's CPU path."""
    ks = []

    def recorded(f_in, f_out, ext, cfg, k, params=None):
        ks.append((k, False))
        return coupled_sweep(f_in, f_out, ext, cfg, k, params)

    def recorded_cell(f_in, f_out, rho, ext, cfg, params=None):
        ks.append((1, True))
        # the solve's densities are the step's
        assert torch.equal(rho, density_in_order(stream(f_in)))
        return _coupled_cell_step(f_in, f_out, rho, ext, cfg, params)

    monkeypatch.setattr(waves, "coupled_sweep", recorded)
    monkeypatch.setattr(waves, "_coupled_cell_step", recorded_cell)
    sim.backend = "kernel"  # as on a card; the state stays on the CPU
    sim._step = sim.make_step()
    return ks


@pytest.mark.parametrize("name", ["RocketYeast", "RocketYeastForcesOnly"])
def test_rocket_yeast_run_with_a_remainder_matches_jax(name, monkeypatch):
    """``run(11)`` on the kernel path is two 4-step launches and one of 3,
    no density pass; it equals JAX's XLA steps and the eager run."""
    kw = dict(ROCKET, N=48)
    if name.endswith("Only"):
        kw.update(c_o=0.25, alpha=2.0)
    sim = getattr(torch_models, name)(device="cpu", **kw)
    eager = getattr(torch_models, name)(device="cpu", **kw)
    ks = _kernel_loop(sim, monkeypatch)
    assert sim.steps_per_call == 4 and sim._run_n is not None
    sim.run(11)
    eager.run(11)
    assert ks == [(4, False), (4, False), (3, False)]
    assert sim.steps_taken == 11
    assert torch.equal(sim.state, eager.state)
    jax_sim = getattr(jax_models, name)(**kw)
    step = jax.jit(jax_sim._make_xla_step())
    f = jax_sim.state
    for _ in range(11):
        f = step(f)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(f), atol=ATOL,
                               rtol=RTOL)


def test_stale_sweep_deeper_than_a_launch_holds_its_velocity(monkeypatch):
    """``stale_velocity=10`` on the kernel path: one solve, then launches of
    8 and 2 steps with the planes held; ``run(12)`` adds two exact steps,
    each the one-step kernel on its solve's densities. It equals the eager
    backend's held-solve sweep."""
    kw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=40,
              stale_velocity=10)
    sim = torch_models.ScreenedFisherWave(device="cpu", **kw)
    eager = torch_models.ScreenedFisherWave(device="cpu", **kw)
    ks = _kernel_loop(sim, monkeypatch)
    assert sim.steps_per_call == 10
    sim.run(12)
    eager.run(12)
    assert ks == [(8, False), (2, False), (1, True), (1, True)]
    assert torch.equal(sim.state, eager.state)


MESHES = [(4, 1), (2, 2)]


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("name", ["RocketYeast", "RocketYeastForcesOnly"])
def test_sharded_rocket_yeast_sweeps_equal_unsharded(name, mesh, k):
    """``ShardedCoupled`` at K steps a sweep (halos of 2K cells; ``run(2)``
    then ``run(9)``: shorter sweeps for the rest) equals the unsharded
    run."""
    kw = dict(ROCKET, N=64)
    if name.endswith("Only"):
        kw.update(c_o=0.25, alpha=2.0)
    single = getattr(torch_models, name)(device="cpu", **kw)
    sh = ShardedCoupled(getattr(torch_models, name)(device="cpu", **kw),
                        mesh=make_mesh(devices=["cpu"] * 4, shape=mesh),
                        k_steps=k)
    assert sh.steps_per_call == k and sh.halos[(0, 0)].width == 2 * k
    assert (sh.halos[(0, 0)].left is None) == (mesh[1] == 1)
    single.run(11)
    sh.run(2)
    sh.run(9)
    got = sh.state_numpy().reshape(single.state.shape)
    assert np.array_equal(got, single.state_numpy())


def test_sharded_sweep_is_capped_by_the_shard():
    """A halo of 2K cells comes from one neighbour: 6-row shards of a 24^2
    rocket yeast take K = 3 of the 8 asked for."""
    sim = torch_models.RocketYeast(device="cpu", **dict(ROCKET, N=24))
    sh = ShardedCoupled(sim, mesh=make_mesh(devices=["cpu"] * 4,
                                            shape=(4, 1)), k_steps=8)
    assert sh.steps_per_call == 3 and sh.halos[(0, 0)].width == 6


@pytest.mark.parametrize("name", ["RocketYeast", "ScreenedFisherWave",
                                  "ClumpySurfactantNutrientWave"])
def test_eager_sharded_coupled_runs_the_plain_twins(name, monkeypatch):
    """On the ``eager`` backend ``ShardedCoupled`` calls none of the
    kernels' wrappers (which would launch K7h and K6h on CUDA shards): its
    sweeps, one-step sweeps and density passes are the plain twins, and
    ``run(5)`` equals the unsharded eager run."""
    def refused(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on the eager backend")

    for wrapper in ("coupled_sweep_halo", "_coupled_cell_step_halo",
                    "coupled_density_halo"):
        monkeypatch.setattr(sharded, wrapper, refused)
    kw = (dict(ROCKET, N=32) if name == "RocketYeast"
          else dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32))
    if name.startswith("Clumpy"):
        kw.update(rho_o=1.0, G_chen=-5.0)
    single = getattr(torch_models, name)(device="cpu", **kw)
    sh = ShardedCoupled(getattr(torch_models, name)(device="cpu", **kw),
                        mesh=make_mesh(devices=["cpu"] * 4, shape=(2, 2)))
    assert sh.base.backend == "eager"
    single.run(5)
    sh.run(5)
    got = sh.state_numpy().reshape(single.state.shape)
    assert np.array_equal(got, single.state_numpy())
