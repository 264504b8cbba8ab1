"""The port's multicomponent / porous engine against JAX, on the CPU.

Parity: the port's ``SimulationRunner(device="cpu")`` (its eager step) and
JAX's are built from the same arguments with the same hooks; their initial
states are equal (the same numpy perturbation), and after 5 steps they agree
to ``atol=5e-7, rtol=1e-5``, the JAX package's own kernel-vs-XLA bar
(tests/test_multicomponent.py:191-193): against JAX's XLA step for each
configuration (a)-(g) of the kernel checks, at 32x32 and at the unaligned
30x34, and against JAX's K6 Pallas kernel in interpret mode at 24x128, as
tests/test_multicomponent.py runs it. In float64 (JAX under
``jax.enable_x64(True)``) the bar is 1e-12. The JAX package's physics
tests (tests 2-8 of tests/test_multicomponent.py) are rerun on the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lb2d_tpu.models.multicomponent as jax_mc
from lb2d_tpu.core.lattice import D2Q25 as JAX_D2Q25
from lb2d_tpu_torch.core import D2Q25
from lb2d_tpu_torch.mc_cases import MC_CASES, mc_case
from lb2d_tpu_torch.models import multicomponent as torch_mc
from lb2d_tpu_torch.ops.spectral import screened_gradients_reference
from lb2d_tpu_torch.ops.fused_mc import (
    MAX_MC_COLLISIONS,
    MAX_MC_FLUIDS,
    MAX_MC_HOOKS,
    check_kernel_config,
    mc_density,
    mc_density_reference,
    mc_params,
    mc_step,
    mc_step_reference,
)

torch.set_num_threads(1)

ATOL, RTOL = 5e-7, 1e-5
CASES = list(MC_CASES)
GRIDS = {"32x32": (32, 32), "30x34": (30, 34)}


def build(mod, case, ny, nx, dtype=None, backend=None, seed=3):
    """The runner of configuration ``case`` (``lb2d_tpu_torch.mc_cases``)
    from module ``mod``, the JAX or the port's ``multicomponent``: the port's
    on the CPU, JAX's on its XLA step unless ``backend`` says otherwise."""
    if mod is torch_mc:
        return mc_case(case, ny, nx, seed, device="cpu", dtype=dtype)
    return mc_case(case, ny, nx, seed, runner=jax_mc.SimulationRunner,
                   fluid=jax_mc.Fluid, d2q25=JAX_D2Q25,
                   backend=backend or "xla")


def _pair(case, ny, nx, **kw):
    return build(jax_mc, case, ny, nx, **kw), build(torch_mc, case, ny, nx)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("case", CASES)
def test_runner_matches_jax_xla(case, grid):
    jax_sim, sim = _pair(case, *GRIDS[grid])
    assert sim.backend == "eager"
    assert np.array_equal(sim.state_numpy(), np.asarray(jax_sim.f))
    jax_sim.run(5)
    sim.run(5)
    assert sim.steps_taken == 5 and sim.backend_used == "eager"
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.f),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["a", "d"])
def test_runner_matches_jax_kernel_interpret(case):
    """Against JAX's K6 (``backend="kernel"``, a Pallas kernel in interpret
    mode on the CPU) at 24x128."""
    jax_sim, sim = _pair(case, 24, 128, backend="kernel")
    jax_sim.run(5)
    sim.run(5)
    assert jax_sim.backend_used == "kernel"
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.f),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["a", "e"])
def test_float64_matches_jax_x64(case):
    with jax.enable_x64(True):
        jax_sim = build(jax_mc, case, 30, 34)
        assert jax_sim.dtype == jnp.float64
        jax_sim.run(5)
        want = np.asarray(jax_sim.f)
    sim = build(torch_mc, case, 30, 34, dtype=torch.float64)
    sim.run(5)
    got = sim.state_numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("case", ["a", "d", "g"])
def test_mc_step_reference_matches_jax_step(case):
    """One plain step of a random state against JAX ``_step``."""
    jax_sim, sim = _pair(case, 30, 34)
    q, C = sim.f.shape[:2]
    rng = np.random.RandomState(5)
    w = np.asarray(sim.lattice.w)[:, None, None, None]
    f = (w * (0.2 + rng.rand(q, C, 30, 34))).astype(np.float32)
    want = np.asarray(jax_sim._step(jnp.asarray(f)))
    got = mc_step_reference(torch.from_numpy(f), sim.config(), sim.lattice,
                            sim.ext_planes()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_mc_density_reference_matches_jax_rolls():
    """Post-stream density with zero-gradient edges (configuration e)."""
    jax_sim, sim = _pair("e", 30, 34)
    lat = sim.lattice
    f = jnp.stack([jnp.roll(jnp.roll(jax_sim.f[j], lat.cy[j], axis=1),
                            lat.cx[j], axis=2) for j in range(lat.q)])
    for i in range(2):
        f = jax_mc._zero_gradient_bcs(f, i)
    want = np.asarray(jnp.sum(f, axis=0))
    got = mc_density_reference(sim.f, sim.config(), sim.lattice).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)


def test_wrappers_on_cpu_run_the_plain_step():
    sim = build(torch_mc, "b", 30, 34)
    cfg, ext = sim.config(), sim.ext_planes()
    before = (mc_step.launches, mc_density.launches)
    out = mc_step(sim.f, torch.empty_like(sim.f), None, ext, cfg, sim.lattice)
    assert torch.equal(out, mc_step_reference(sim.f, cfg, sim.lattice, ext))
    rho = mc_density(sim.f, torch.empty_like(sim.rho), cfg, sim.lattice)
    assert torch.equal(rho, mc_density_reference(sim.f, cfg, sim.lattice))
    assert (mc_step.launches, mc_density.launches) == before


@pytest.mark.parametrize("seed", [None, 11], ids=["default-seed", "seed-11"])
def test_fluid_initialize_matches_jax(seed):
    sims = []
    for mod in (jax_mc, torch_mc):
        kw = dict(device="cpu") if mod is torch_mc else {}
        sim = mod.SimulationRunner(nx=34, ny=30, num_populations=2,
                                   porous=True, **kw)
        fl = [mod.Fluid(sim, i, nu_e=0.3 + 0.1 * i, epsilon=0.7)
              for i in (0, 1)]
        for f_ in fl:
            sim.add_fluid(f_)
        sim.complete_setup()
        u = np.full((30, 34), 0.01)
        sim.set_bary_velocity(u, -u)
        rng = np.random.RandomState(0)
        fl[0].initialize(0.5 + 0.1 * rng.rand(30, 34), f_amp=0.02, seed=seed)
        fl[1].initialize(0.4 + 0.1 * rng.rand(30, 34), f_amp=0.02, seed=seed)
        sims.append(sim)
    jax_sim, sim = sims
    assert sim.fluid_list[1].tau == jax_sim.fluid_list[1].tau
    np.testing.assert_array_equal(sim.state_numpy(), np.asarray(jax_sim.f))
    np.testing.assert_array_equal(sim.rho.numpy(), np.asarray(jax_sim.rho))


def test_get_fields_and_check_fields_match_jax():
    jax_sim, sim = _pair("a", 30, 34)
    jax_sim.run(5)
    sim.run(5)
    want, got = jax_sim.get_fields(), sim.get_fields()
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    want, got = jax_sim.check_fields(), sim.check_fields()
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert sim.check_fields("f32")["sum_rho_0"] == pytest.approx(
        want["sum_rho_0"], rel=1e-5)


def test_load_numpy_state_carries_a_jax_state():
    """A JAX runner's state after 3 steps, loaded into the port, runs on as
    the JAX runner does."""
    jax_sim, sim = _pair("g", 32, 32)
    jax_sim.run(3)
    sim.load_numpy_state(np.asarray(jax_sim.f))
    np.testing.assert_allclose(sim.get_fields()["rho"],
                               jax_sim.get_fields()["rho"], atol=ATOL,
                               rtol=RTOL)
    jax_sim.run(4)
    sim.run(4)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.f),
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="state must be"):
        sim.load_numpy_state(np.zeros((9, 2, 32, 32), np.float32))


def test_second_belt_stencil_props():
    stencil = torch_mc.SECOND_BELT_STENCIL
    assert stencil == jax_mc.SECOND_BELT_STENCIL and len(stencil) == 24
    assert abs(sum(w * c[0] for w, c in stencil)) < 1e-14
    assert abs(sum(w * c[1] for w, c in stencil)) < 1e-14


# ---- the JAX package's physics tests, on the port --------------------------

def _runner(C=1, porous=True, lattice=None, nx=32, ny=32):
    kw = dict(nx=nx, ny=ny, L_lb=nx, T_lb=1.0, num_populations=C,
              porous=porous, device="cpu")
    if lattice is not None:
        kw["lattice"] = lattice
    return torch_mc.SimulationRunner(**kw)


def test_porous_darcy_balance():
    """Constant body force balanced by Darcy drag: steady u = g K / nu_f."""
    sim = _runner(C=1, porous=True)
    fl = torch_mc.Fluid(sim, 0, nu_e=0.5, epsilon=0.8, nu_fluid=0.4, K=2.0,
                        Fe=0.0)
    sim.add_fluid(fl)
    sim.complete_setup()
    fl.initialize(np.ones((sim.ny, sim.nx)))
    g = 1e-5
    sim.add_constant_body_force(0, g, 0.0)
    sim.run(3000)
    u = sim.get_fields()["u_bary"]
    expected = g * 2.0 / 0.4
    assert np.allclose(u, expected, rtol=0.05), (u.mean(), expected)


def test_mass_conservation_periodic():
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(torch_mc.Fluid(sim, i, nu_e=0.4, epsilon=1.0))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    sim.fluid_list[0].initialize(1.0 + 0.1 * rng.rand(sim.ny, sim.nx))
    sim.fluid_list[1].initialize(1.0 + 0.1 * rng.rand(sim.ny, sim.nx))
    m0 = [float(np.sum(sim.get_fields()["rho"][:, :, i])) for i in range(2)]
    sim.run(300)
    rho = sim.get_fields()["rho"]
    for i in range(2):
        assert np.sum(rho[:, :, i]) == pytest.approx(m0[i], rel=1e-4)


def test_shan_chen_separation():
    """Two mutually repelling fluids phase-separate."""
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(torch_mc.Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=1.0))
    sim.complete_setup()
    rng = np.random.RandomState(1)
    base = 0.5 + 0.05 * rng.rand(sim.ny, sim.nx)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.8, potential="linear")
    std0 = float(sim.get_fields()["rho"][:, :, 0].std())
    sim.run(400)
    rho = sim.get_fields()["rho"]
    r0, r1 = rho[:, :, 0], rho[:, :, 1]
    assert np.isfinite(rho).all()
    assert np.corrcoef(r0.ravel(), r1.ravel())[0, 1] < -0.5
    assert r0.std() > 20 * std0, (std0, r0.std())


def test_eating_conserves_total():
    sim = _runner(C=2, porous=False)
    for i in range(2):
        sim.add_fluid(torch_mc.Fluid(sim, i, nu_e=0.4))
    sim.complete_setup()
    sim.fluid_list[0].initialize(0.5 * np.ones((sim.ny, sim.nx)))
    sim.fluid_list[1].initialize(1.0 * np.ones((sim.ny, sim.nx)))
    sim.add_eating_rate(0, 1, rate=1e-3)
    m_eater0 = float(np.sum(sim.get_fields()["rho"][:, :, 0]))
    tot0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(200)
    rho = sim.get_fields()["rho"]
    assert np.sum(rho[:, :, 0]) > m_eater0
    assert np.sum(rho) == pytest.approx(tot0, rel=1e-4)


def test_growth_hook():
    sim = _runner(C=1, porous=False)
    sim.add_fluid(torch_mc.Fluid(sim, 0, nu_e=0.4))
    sim.complete_setup()
    sim.fluid_list[0].initialize(0.5 * np.ones((sim.ny, sim.nx)))
    sim.add_growth(0, min_rho_cutoff=0.1, max_rho_cutoff=10.0, eat_rate=1e-3)
    m0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(100)
    assert float(np.sum(sim.get_fields()["rho"])) > m0


def test_zero_gradient_bc_runs():
    sim = _runner(C=1, porous=True)
    fl = torch_mc.Fluid(sim, 0, nu_e=0.5, bc="zero_gradient")
    sim.add_fluid(fl)
    sim.complete_setup()
    rho0 = np.ones((sim.ny, sim.nx))
    rho0[10:20, 10:20] = 2.0
    fl.initialize(rho0)
    sim.run(100)
    rho = sim.get_fields()["rho"][:, :, 0]
    assert np.isfinite(rho).all()
    np.testing.assert_allclose(rho[0, 1:-1], rho[1, 1:-1], rtol=1e-3)


def test_d2q25_runner():
    sim = _runner(C=1, porous=False, lattice=D2Q25)
    sim.add_fluid(torch_mc.Fluid(sim, 0, nu_e=0.5))
    sim.complete_setup()
    rng = np.random.RandomState(2)
    sim.fluid_list[0].initialize(1.0 + 0.05 * rng.rand(sim.ny, sim.nx))
    m0 = float(np.sum(sim.get_fields()["rho"]))
    sim.run(100)
    rho = sim.get_fields()["rho"]
    assert rho.shape[-1] == 1 and sim.f.shape[0] == 25
    assert np.isfinite(rho).all()
    assert np.sum(rho) == pytest.approx(m0, rel=1e-5)


# ---- what raises ---------------------------------------------------------

def test_screened_poisson_and_shard_over_name_their_roadmap_item():
    """``add_screened_poisson_force`` is ported (it registers a hook and
    checks its precision); so is ``shard_over``, once a stub naming ROADMAP
    queue 1 item 2: it returns the runner, which gives its state up to the
    shards and runs on them (``tests/test_torch_sharded_runner.py`` holds
    it to JAX)."""
    from lb2d_tpu_torch.parallel import make_mesh

    sim = build(torch_mc, "c", 32, 32)
    sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                   amplitude=0.02, precision="bf16x3")
    assert sim.config().screened == (("screened", 1, 0, 0, 16.0, 0.02),)
    with pytest.raises(ValueError, match="precision"):
        sim.add_screened_poisson_force(0, 1, 4.0, 0.02, precision="bf16")
    single = build(torch_mc, "c", 32, 32)
    single.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                      amplitude=0.02, precision="bf16x3")
    assert sim.shard_over(make_mesh(devices=["cpu"] * 4)) is sim
    assert sim.f is None
    single.run(2)
    sim.run(2)
    assert np.array_equal(sim.state_numpy(), single.state_numpy())


def test_kernel_backend_on_the_cpu_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        torch_mc.SimulationRunner(nx=16, ny=16, device="cpu", backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        torch_mc.SimulationRunner(nx=16, ny=16, device="cpu",
                                  backend="pallas")
    # JAX's name of the plain path
    assert torch_mc.SimulationRunner(nx=16, ny=16, device="cpu",
                                     backend="xla").backend == "eager"
    assert torch_mc.SimulationRunner(nx=16, ny=16,
                                     device="cpu").backend == "eager"


@pytest.mark.parametrize("backend", ["auto", "kernel"])
def test_backend_picker_on_cuda_rejects_what_the_kernel_cannot_run(backend):
    cuda = torch.device("cuda")
    assert torch_mc.pick_backend(backend, cuda, torch.float32, 2) == "kernel"
    assert torch_mc.pick_backend("eager", cuda, torch.float64, 9) == "eager"
    with pytest.raises(ValueError, match="backend='eager'"):
        torch_mc.pick_backend(backend, cuda, torch.float64, 2)
    with pytest.raises(ValueError, match="backend='eager'"):
        torch_mc.pick_backend(backend, cuda, torch.float32, MAX_MC_FLUIDS + 1)


def test_kernel_config_limits_name_the_eager_backend():
    sim = build(torch_mc, "a", 16, 16)
    check_kernel_config(sim.config(), sim.lattice)
    for _ in range(MAX_MC_HOOKS):
        sim.add_constant_body_force(0, 0.0, 0.0)
    with pytest.raises(ValueError, match="force hooks.*backend='eager'"):
        check_kernel_config(sim.config(), sim.lattice)
    sim = build(torch_mc, "c", 16, 16)
    for _ in range(MAX_MC_COLLISIONS + 1):
        sim.add_growth(0, 0.1, 2.0, 0.0)
    with pytest.raises(ValueError, match="collision hooks.*backend='eager'"):
        check_kernel_config(sim.config(), sim.lattice)


def test_mc_params_packs_the_hooks_in_registration_order():
    """K6's by-value struct: the force hooks and collisions in the order
    they were registered, packed after the limits are checked."""
    sim = build(torch_mc, "b", 16, 16)
    prm = mc_params(sim.config(), sim.lattice)
    assert (prm.num_hooks, prm.num_collisions, prm.porous) == (3, 1, 0)
    assert [prm.hooks[h].kind for h in range(3)] == [4, 1, 2]
    assert (prm.hooks[0].belt, prm.hooks[0].spec) == (2, 0)
    assert prm.hooks[0].p[0] == pytest.approx(-1.5)
    assert prm.coll[0].kind == 1 and prm.coll[0].rate == pytest.approx(1e-4)
    for _ in range(MAX_MC_HOOKS):
        sim.add_constant_body_force(0, 0.0, 0.0)
    with pytest.raises(ValueError, match="force hooks.*backend='eager'"):
        mc_params(sim.config(), sim.lattice)


# ---- BASELINE config 5: the porous runner with the screened-Poisson force --

def config5(mod, ny=48, nx=40, order=None, **kw):
    """``benchmarks/c5_one.py``'s runner at ``ny x nx`` (porous, 2 fluids,
    Shan-Chen, screened-Poisson repulsion of fluid 0 on fluid 1), with an
    interaction length and amplitude that make the force matter at this
    size; ``order`` adds a constant force ``"before"`` or ``"after"`` the
    screened one."""
    sim = mod.SimulationRunner(nx=nx, ny=ny, L_lb=nx, T_lb=1.0,
                               num_populations=2, porous=True, **kw)
    for i in range(2):
        sim.add_fluid(mod.Fluid(sim, i, nu_e=1 / 6, epsilon=0.8,
                                nu_fluid=1 / 6, K=10.0, Fe=0.1))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(0).rand(ny, nx).astype(
        np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    if order == "before":
        sim.add_constant_body_force(1, 1e-4, -2e-4)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                   amplitude=0.05)
    if order == "after":
        sim.add_constant_body_force(1, 1e-4, -2e-4)
    return sim


@pytest.mark.parametrize("order", [None, "before", "after"],
                         ids=["config5", "force-before", "force-after"])
def test_config5_matches_jax_xla(order):
    """The screened force at its registration-order place: 4 steps against
    JAX's XLA step, which solves it with ``jnp.fft`` on the post-stream
    density."""
    jax_sim = config5(jax_mc, order=order, backend="xla")
    sim = config5(torch_mc, order=order, device="cpu")
    assert np.array_equal(sim.state_numpy(), np.asarray(jax_sim.f))
    jax_sim.run(4)
    sim.run(4)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.f),
                               atol=ATOL, rtol=RTOL)


def test_stale_force_holds_the_sweeps_first_solve():
    """``stale_force=2``: ``run(5)`` is two sweeps that each solve once, from
    their first step's post-stream density, then one exact step (the
    frozen-force oracle)."""
    sim = config5(torch_mc, device="cpu", stale_force=2)
    cfg, ext, lat = sim.config(), sim.ext_planes(), sim.lattice
    f = sim.f
    for _ in range(2):
        rho = mc_density_reference(f, cfg, lat)
        ext[0:2] = screened_gradients_reference(rho[0], 16.0,
                                                out_scale=0.05)
        for _ in range(2):
            f = mc_step_reference(f, cfg, lat, ext, hold_screened=True)
    f = mc_step_reference(f, cfg, lat, ext)
    sim.run(5)
    assert sim.steps_per_call == 2 and sim.steps_taken == 5
    assert torch.equal(sim.f, f)
    exact = config5(torch_mc, device="cpu")
    exact.run(5)
    d = float((exact.f - f).abs().max())
    assert 0 < d < 1e-5, d
    capped = config5(torch_mc, device="cpu", stale_force=4)
    capped.run(4, k_steps=2)
    assert capped.steps_per_call == 2
    np.testing.assert_array_equal(capped.state_numpy(),
                                  config5(torch_mc, device="cpu",
                                          stale_force=2).run(4).state_numpy())


def test_screened_hook_packs_as_its_ext_pair():
    """K6 reads a screened hook as an ext hook on its pair; ``mc_step`` on
    CPU tensors reads the held planes the caller wrote, as the kernel."""
    sim = config5(torch_mc, order="after", device="cpu")
    cfg, lat = sim.config(), sim.lattice
    prm = mc_params(cfg, lat)
    assert [prm.hooks[h].kind for h in range(3)] == [4, 2, 0]
    assert (prm.hooks[1].a, prm.hooks[1].ext_pair) == (1, 0)
    ext = sim.ext_planes()
    assert ext.shape == (2, 48, 40) and float(ext.abs().max()) == 0.0
    rho = mc_density(sim.f, torch.empty_like(sim.rho), cfg, lat)
    ext[0:2] = screened_gradients_reference(rho[0], 16.0, out_scale=0.05)
    out = mc_step(sim.f, torch.empty_like(sim.f), rho, ext, cfg, lat)
    assert torch.equal(out, mc_step_reference(sim.f, cfg, lat))
