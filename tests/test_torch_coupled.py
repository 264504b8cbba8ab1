"""The port's coupled families against JAX, on the CPU.

``ScreenedFisherWave``, ``SurfactantNutrientWave``,
``ClumpySurfactantNutrientWave``, ``RocketYeast`` and
``RocketYeastForcesOnly`` are built in both packages from the same
arguments (the same numpy initial draws): their initial states agree to
1e-7 (the screened ones solve their initial velocity with two FFT
libraries), and after 4 steps the port's eager step stays within 5e-7 of
JAX's XLA step at the JAX tests' sizes. The port's plain steps are held to
JAX's K7 kernels run in interpret mode at 128^2
(tests/test_surfactant_rocket.py:106-168, tests/test_waves.py:149-166), the
sweep-stale mode to JAX's kernel path with ``steps_per_call == 4``, and the
physics checks of the JAX tests are rerun on the port. K7 itself is CUDA
and is held to these plain steps on the card; on CPU tensors its wrapper
(:func:`coupled_sweep`, K steps a call) runs them.
"""

import numpy as np
import pytest
import torch

import jax
import lb2d_tpu.models as jax_models
from lb2d_tpu.models.rocket_yeast import stencil_gradient as jax_gradient
from lb2d_tpu.models.surfactant import pseudo_force as jax_pseudo_force
from lb2d_tpu_torch import models as torch_models
from lb2d_tpu_torch.models.base import held_solve_sweep
from lb2d_tpu_torch.models.rocket_yeast import stencil_gradient
from lb2d_tpu_torch.models.surfactant import (
    pseudo_force,
    psi_shan_chen,
    psi_sticky_repulsive,
)
from lb2d_tpu_torch.ops.fused_coupled import (
    COUPLED_PHYSICS,
    CoupledConfig,
    coupled_density,
    coupled_params,
    coupled_step_reference,
    coupled_sweep,
    coupled_sweep_reference,
    _coupled_cell_step,
)
from lb2d_tpu_torch.ops.stream import stream

torch.set_num_threads(1)

ATOL, RTOL = 5e-7, 1e-5
# the JAX tests' recipes (tests/test_waves.py, tests/test_surfactant_rocket.py)
CASES = {
    "ScreenedFisherWave": dict(Lx=1.0, Ly=1.0, vc=5.0, lam=0.1, R0=0.2,
                               N=48),
    "SurfactantNutrientWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
                                   N=32),
    "ClumpySurfactantNutrientWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5,
                                         R0=0.2, N=24, seed=4, rho_o=1.0,
                                         G_chen=-5.0),
    "RocketYeast": dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=32,
                        G_chen=-0.1),
    "RocketYeastForcesOnly": dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.02,
                                  Gc=2.0, N=24, G_chen=-0.05, c_o=0.25,
                                  alpha=2.0),
}
# the JAX kernel tests' recipes at 128^2, their steps and sweep depths
KERNEL_CASES = {
    "RocketYeast": (dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0,
                         N=128, G_chen=-0.1), 6, 3),
    "RocketYeastForcesOnly": (dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05,
                                   Gc=2.0, N=128, G_chen=-0.1, c_o=0.25,
                                   alpha=2.0), 6, 2),
    "ScreenedFisherWave": (dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
                                N=128), 5, None),
    "SurfactantNutrientWave": (dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
                                    N=128), 5, None),
    "ClumpySurfactantNutrientWave": (dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5,
                                          R0=0.2, N=128, rho_o=1.0,
                                          G_chen=-5.0), 5, None),
}


def _pair(name, **kw):
    kw = dict(CASES[name], **kw)
    return (getattr(jax_models, name)(**kw),
            getattr(torch_models, name)(device="cpu", **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax_xla(name):
    jax_sim, sim = _pair(name)
    assert sim.backend == "eager" and sim.steps_per_call == 1
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.state),
                               atol=1e-7, rtol=0)
    step = jax.jit(jax_sim._make_xla_step())
    f = jax_sim.state
    for _ in range(4):
        f = step(f)
    sim.run(4)
    assert sim.steps_taken == 4
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(f), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_plain_step_matches_jax_kernel_interpret(name):
    """The port's plain step against JAX's K7 (a Pallas kernel in interpret
    mode), exact coupling, at 128^2."""
    kw, steps, k = KERNEL_CASES[name]
    jax_sim = getattr(jax_models, name)(**kw)
    sim = getattr(torch_models, name)(device="cpu", **kw)
    if name.startswith("Rocket"):
        raw = jax_sim._make_kernel_step(k_steps=k, interpret=True)
        spc = jax_sim.steps_per_call
    else:
        raw = jax_sim._make_kernel_step(interpret=True)
        spc = 1
    kstep = jax.jit(raw)
    if getattr(raw, "carried", False):
        carry = raw.init_carry(jax_sim.state)
        for _ in range(steps // spc):
            carry = kstep(carry)
        want = carry[0]
    else:
        want = jax_sim.state
        for _ in range(steps // spc):
            want = kstep(want)
    sim.run(steps)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["ScreenedFisherWave",
                                  "SurfactantNutrientWave"])
def test_stale_velocity_matches_jax_kernel_path(name):
    """``stale_velocity=4``: one solve per 4-step sweep. ``run(6)`` is one
    sweep and two exact steps, as JAX's kernel path runs it (interpret
    mode, ``steps_per_call == 4``)."""
    kw = dict(KERNEL_CASES[name][0], stale_velocity=4)
    jax_sim = getattr(jax_models, name)(**kw)
    sim = getattr(torch_models, name)(device="cpu", **kw)
    assert jax_sim.backend == "kernel" and jax_sim.steps_per_call == 4
    assert sim.steps_per_call == 4
    jax_sim.run(6)
    sim.run(6)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.state),
                               atol=ATOL, rtol=RTOL)


def test_stale_sweep_holds_the_first_velocity():
    """A sweep equals four plain steps on the velocity of its first
    post-stream density (the frozen-velocity oracle of
    tests/test_waves.py:264-294), and stays near exact coupling."""
    kw = KERNEL_CASES["ScreenedFisherWave"][0]
    stale = torch_models.ScreenedFisherWave(stale_velocity=4, device="cpu",
                                            **kw)
    cfg = stale.coupled_config()
    f = stale.state
    planes = stale._velocity.planes(stream(f).sum(dim=0))
    for _ in range(4):
        f = coupled_step_reference(f, cfg, planes)
    stale.run(4)
    assert torch.equal(stale.state, f)
    exact = torch_models.ScreenedFisherWave(device="cpu", **kw)
    exact.run(24)
    stale.run(20)
    a = exact.get_fields()["rho"]
    b = stale.get_fields()["rho"]
    err = np.abs(a - b).max() / np.abs(a).max()
    assert 0 < err < 5e-3, err


@pytest.mark.parametrize("name", list(CASES))
def test_get_fields_match_jax(name):
    jax_sim, sim = _pair(name)
    jax_sim.run(2)
    sim.run(2)
    want, got = jax_sim.get_fields(), sim.get_fields()
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, atol=ATOL,
                                   rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("name", ["SurfactantNutrientWave", "RocketYeast"])
def test_load_numpy_state_carries_a_jax_state(name):
    jax_sim, sim = _pair(name)
    jax_sim.run(3)
    sim.load_numpy_state(np.asarray(jax_sim.state))
    jax_sim.run(3)
    sim.run(3)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(jax_sim.state),
                               atol=ATOL, rtol=RTOL)


# ---- the JAX package's physics tests, on the port --------------------------

def test_psi_forms_and_stencils_match_jax():
    rho = torch.tensor([[0.0, 0.5, -1.0]])
    np.testing.assert_allclose(psi_shan_chen(rho, 1.0).numpy(),
                               [[0.0, 1 - np.exp(-0.5), 0.0]], atol=1e-6)
    np.testing.assert_allclose(psi_sticky_repulsive(rho, 0.5).numpy(),
                               [[0.0, 0.5 - 0.5 * 0.25, 0.0]], atol=1e-6)
    ny, nx = 16, 24
    y = np.arange(ny)[:, None] * np.ones((1, nx))
    gx, gy = stencil_gradient(torch.tensor(2.5 * y, dtype=torch.float32))
    np.testing.assert_allclose(gy.numpy()[2:-2], 2.5, atol=1e-4)
    np.testing.assert_allclose(gx.numpy()[2:-2], 0.0, atol=1e-4)
    fx, fy = pseudo_force(torch.ones((8, 8)), G_chen=-1.0)
    assert float(fx.abs().max()) < 1e-6 and float(fy.abs().max()) < 1e-6
    field = np.random.RandomState(2).rand(ny, nx).astype(np.float32)
    for ours, theirs in ((stencil_gradient(torch.from_numpy(field)),
                          jax_gradient(field)),
                         (pseudo_force(torch.from_numpy(field), -0.7),
                          jax_pseudo_force(field, -0.7))):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def test_screened_fisher_wave_repels():
    sim = torch_models.ScreenedFisherWave(Lx=1.0, Ly=1.0, vc=5.0, lam=0.1,
                                          R0=0.2, N=48, device="cpu")
    assert (sim.nx, sim.ny) == (48, 48)
    r0_mass = sim.get_fields()["rho"].sum()
    sim.run(300)
    fields = sim.get_fields()
    rho = fields["rho"]
    assert np.isfinite(rho).all()
    assert rho.sum() > r0_mass
    cx = sim.nx // 2
    assert fields["u"][cx + 5, sim.ny // 2] > 0
    assert fields["u"][cx - 5, sim.ny // 2] < 0


def test_screened_fisher_mach_number_and_redo_initial_condition():
    kw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=32)
    sim = torch_models.ScreenedFisherWave(check_max_ulb=True, device="cpu",
                                          **kw)
    ma = sim.mach_number()
    assert ma == pytest.approx(jax_models.ScreenedFisherWave(
        check_max_ulb=True, **kw).mach_number(), rel=1e-5)
    assert 0.0 <= ma < 0.5
    new_rho = np.zeros((sim.ny, sim.nx), np.float32)
    new_rho[10:20, 10:20] = 1.0
    sim.redo_initial_condition(new_rho)
    assert sim.get_fields()["rho"].T[12, 12] == pytest.approx(1.0, abs=1e-5)
    sim.run(10)
    assert np.isfinite(sim.get_fields()["rho"]).all()


def test_surfactant_wave_grows_and_consumes():
    sim = torch_models.SurfactantNutrientWave(Lx=1.0, Ly=1.0, vc=1.0,
                                              lam=0.5, R0=0.2, N=32,
                                              device="cpu")
    rho0 = sim.get_fields()["rho"]
    sim.run(200)
    rho = sim.get_fields()["rho"]
    assert np.isfinite(rho).all()
    assert rho[:, :, 0].sum() > rho0[:, :, 0].sum()
    assert rho[:, :, 1].sum() < rho0[:, :, 1].sum()
    assert rho.sum() == pytest.approx(rho0.sum(), rel=2e-3)


def test_clumpy_variant_differs():
    kw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=24, seed=4,
              device="cpu")
    a = torch_models.SurfactantNutrientWave(**kw)
    b = torch_models.ClumpySurfactantNutrientWave(rho_o=1.0, G_chen=-5.0,
                                                  **kw)
    a.run(100)
    b.run(100)
    ra, rb = a.get_fields()["rho"], b.get_fields()["rho"]
    assert np.isfinite(rb).all()
    assert not np.allclose(ra[:, :, 0], rb[:, :, 0])


def test_rocket_yeast_propulsion():
    sim = torch_models.RocketYeast(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05,
                                   Gc=2.0, N=32, G_chen=-0.1, device="cpu")
    assert sim.Dc == pytest.approx(1.0 / 16.0)   # the reference's Dc / 4
    rho0 = sim.get_fields()["rho"]
    assert rho0[:, :, 1].sum() == pytest.approx(0.0, abs=1e-5)
    sim.run(300)
    fields = sim.get_fields()
    rho = fields["rho"]
    assert np.isfinite(rho).all()
    assert rho[:, :, 1].sum() > 0.1
    assert np.abs(fields["u"]).max() > 0
    assert float(sim.state[:, 0].min()) >= 0.0   # the population clip


def test_rocket_yeast_forces_only_runs():
    sim = torch_models.RocketYeastForcesOnly(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.02, Gc=2.0, N=24, G_chen=-0.05,
        c_o=0.25, alpha=2.0, device="cpu")
    sim.run(150)
    rho = sim.get_fields()["rho"]
    assert np.isfinite(rho).all()
    assert rho[:, :, 1].sum() > 0


# ---- the wrappers and the backends -----------------------------------------

def _random_state(F, ny=30, nx=34, seed=5):
    rs = np.random.RandomState(seed)
    w = np.asarray([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None, None]
    return torch.tensor(w * (0.2 + rs.rand(9, F, ny, nx)),
                        dtype=torch.float32)


@pytest.mark.parametrize("physics", list(COUPLED_PHYSICS))
def test_coupled_step_on_cpu_runs_the_plain_step(physics):
    """K7's wrapper on CPU tensors runs the plain steps (one, and three in
    one call), and launches nothing."""
    cfg = CoupledConfig(physics, omega=1.6, lb_G=1e-3, omega2=1.2,
                        lb_G2=2e-3, epsilon=0.05, rho_o=1.0, G_chen=-0.5)
    f = _random_state(cfg.fields)
    rho = coupled_density(f, torch.empty((cfg.fields, 30, 34)))
    np.testing.assert_allclose(rho.numpy(), stream(f).sum(dim=0).numpy(),
                               rtol=1e-6)
    ext = 1e-3 * torch.ones((2, 30, 34)) if cfg.reads_ext else None
    before = coupled_sweep.launches
    out = coupled_sweep(f, torch.empty_like(f), ext, cfg, 1)
    assert torch.equal(out, coupled_step_reference(f, cfg, ext))
    out = coupled_sweep(f, torch.empty_like(f), ext, cfg, 3)
    assert coupled_sweep.launches == before
    want = coupled_step_reference(coupled_step_reference(
        coupled_step_reference(f, cfg, ext), cfg, ext), cfg, ext)
    assert torch.equal(out, want)
    assert torch.equal(out, coupled_sweep_reference(f, cfg, 3, ext))
    prm = coupled_params(cfg)
    assert prm.physics == COUPLED_PHYSICS[physics]
    assert prm.one_minus_omega == np.float32(1) - np.float32(1.6)
    assert prm.sc_pref == pytest.approx(0.5 / 3) and prm.neg_G_chen == 0.5


def test_coupled_step_checks_its_arguments():
    cfg = CoupledConfig("surfactant", omega=1.6, lb_G=1e-3)
    f = _random_state(2)
    ext = torch.zeros((2, 30, 34))
    with pytest.raises(ValueError, match="ext must be"):
        coupled_sweep(f, torch.empty_like(f), None, cfg, 1)
    with pytest.raises(ValueError, match="distinct"):
        coupled_sweep(f, f, ext, cfg, 1)
    with pytest.raises(ValueError, match=r"\[9, 1, ny, nx\]"):
        coupled_sweep(f, torch.empty_like(f), ext,
                      CoupledConfig("screened_fisher", omega=1.6, lb_G=0.0),
                      1)
    for k in (0, 9):
        with pytest.raises(ValueError, match=r"k_steps must be in 1\.\.8"):
            coupled_sweep(f, torch.empty_like(f), ext, cfg, k)
    rho = torch.zeros((2, 30, 34))  # the one-step kernel's densities
    assert torch.equal(_coupled_cell_step(f, torch.empty_like(f), rho, ext,
                                          cfg),
                       coupled_step_reference(f, cfg, ext))
    with pytest.raises(ValueError, match="rho must be"):
        _coupled_cell_step(f, torch.empty_like(f), rho[:1], ext, cfg)
    with pytest.raises(ValueError, match="one-step kernel takes a screened"):
        _coupled_cell_step(f, torch.empty_like(f), rho, ext,
                           CoupledConfig("rocket_yeast", omega=1.6, lb_G=0.0))
    with pytest.raises(ValueError, match="unknown physics"):
        CoupledConfig("fisher", omega=1.0, lb_G=0.0)


def test_backends_on_the_cpu():
    kw = dict(CASES["RocketYeast"], N=8)
    assert torch_models.RocketYeast(device="cpu", **kw).backend == "eager"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        torch_models.RocketYeast(device="cpu", backend="kernel", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        torch_models.RocketYeast(device="cpu", backend="pallas", **kw)
    # JAX's name of the plain path
    assert torch_models.RocketYeast(device="cpu", backend="xla",
                                    **kw).backend == "eager"
    with pytest.raises(ValueError, match="unknown method"):
        torch_models.ScreenedFisherWave(N=8, device="cpu", method="dft")
    with pytest.raises(ValueError, match="stale_velocity"):
        torch_models.ScreenedFisherWave(N=8, device="cpu", stale_velocity=0)
    # the eager backend solves with the plain solve, whatever the method
    for method in ("auto", "pallas", "fft"):
        sfw = torch_models.ScreenedFisherWave(N=8, device="cpu", method=method)
        assert sfw.backend == "eager" and sfw._velocity.plain


@pytest.mark.parametrize("every_step", [False, True], ids=["held", "every"])
@pytest.mark.parametrize("n", [1, 4])
def test_held_solve_sweep_solves_once_per_sweep(n, every_step):
    """The stale-solve policy both engines share: one density pass and one
    solve at the sweep's first step, the density again at every step only
    when a stencil reads it, and each step given the latest density."""
    calls = []

    def density(f):
        calls.append(("density", f))
        return 10 * f

    def step(f, rho):
        calls.append(("step", f, rho))
        return f + 1

    out = held_solve_sweep(0, n, step, density,
                           lambda rho: calls.append(("solve", rho)),
                           density_every_step=every_step)
    assert out == n
    want = [("density", 0), ("solve", 0), ("step", 0, 0)]
    for k in range(1, n):
        if every_step:
            want.append(("density", k))
        want.append(("step", k, 10 * k if every_step else 0))
    assert calls == want
    calls.clear()
    assert held_solve_sweep(0, n, step, density,
                            density_every_step=every_step) == n  # no solve
    assert [c[0] for c in calls].count("density") == (n if every_step else 0)
