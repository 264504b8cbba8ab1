"""The port's LBM Poisson solver against the JAX one, and its physics alone.

Parity: the Poisson ops, the boundary conditions, the gradient and one
iteration on a random f at an unaligned 13x21, then ``PoissonSolver`` from
the same seed and source (``check_every`` 1 and 10; ``run(n)`` with ``n`` not
a multiple of it, a run to convergence and a warm restart), the port on the
CPU through its eager blocks. Tolerance 5e-7, the reference's
kernel-vs-XLA bar (tests/test_fused.py); the ops and one iteration are
bitwise. The physics cases are those of tests/test_poisson.py:17-95.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lb2d_tpu.models import poisson as jax_poisson
from lb2d_tpu.ops.equilibrium import feq_poisson as jax_feq_poisson
from lb2d_tpu.ops.moments import rho_poisson as jax_rho_poisson
from lb2d_tpu_torch.models import PoissonSolver
from lb2d_tpu_torch.models import poisson as torch_poisson
from lb2d_tpu_torch.ops.equilibrium import feq_poisson
from lb2d_tpu_torch.ops.moments import rho_poisson

torch.set_num_threads(1)

TOL = 5e-7
NY, NX = 13, 21
W = tuple(float(x) for x in (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4)
SOLVER = dict(nx=NX, ny=NY, delta_t=1e-3, delta_x=0.05, rho_on_boundary=0.1,
              tolerance=1e-5)


def _random(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _one_iteration(module, array):
    """One ``_make_poisson_iter`` step of each package's solver from the
    same f and source."""
    c = module.PoissonSolver(sources=_random(NY, NX, seed=2), **SOLVER,
                             **({} if module is jax_poisson
                                else {"device": "cpu"}))._consts()
    react = 1e-3 * _random(NY, NX, seed=3)
    return module._make_poisson_iter(c)(array(_random(9, NY, NX)),
                                        array(react))


OPS = {
    "feq_poisson": (lambda: jax_feq_poisson(jnp.asarray(_random(NY, NX))),
                    lambda: feq_poisson(torch.tensor(_random(NY, NX)))),
    "rho_poisson": (lambda: jax_rho_poisson(jnp.asarray(_random(9, NY, NX))),
                    lambda: rho_poisson(torch.tensor(_random(9, NY, NX)))),
    "poisson_bcs": (
        lambda: jax_poisson._poisson_bcs(jnp.asarray(_random(9, NY, NX)),
                                         jnp.float32(0.3), W),
        lambda: torch_poisson._poisson_bcs(torch.tensor(_random(9, NY, NX)),
                                           0.3, W)),
    "negative_gradient": (
        lambda: jax_poisson.negative_gradient(jnp.asarray(_random(NY, NX)),
                                              0.05),
        lambda: torch_poisson.negative_gradient(torch.tensor(_random(NY, NX)),
                                                0.05)),
    "iteration": (lambda: _one_iteration(jax_poisson, jnp.asarray),
                  lambda: _one_iteration(torch_poisson, torch.tensor)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax_bitwise(name):
    want, got = (fn() for fn in OPS[name])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bcs_read_the_snapshot_and_leave_the_input():
    """Each region reads the populations as they were before any BC (JAX's
    snapshot ``s = f``): a corner's value from the input's, exactly three
    populations changed in each boundary cell, and the input unchanged."""
    f = torch.tensor(_random(9, NY, NX))
    before = f.clone()
    out = torch_poisson._poisson_bcs(f, 0.3, W)
    assert torch.equal(f, before)
    # a corner's value from the snapshot: (0, 0) replaces 1, 2, 5
    k = sum(before[j, 0, 0] for j in (3, 4, 6, 7, 8))
    r = -(k + np.float32(W[0] - 1.0) * np.float32(0.3)) / np.float32(
        W[1] + W[2] + W[5])
    assert abs(float(out[5, 0, 0]) - W[5] * float(r)) < 1e-7
    changed = (out != before).nonzero()
    assert changed.shape[0] == 3 * (2 * (NY + NX) - 4)


def _solvers(check_every, seed=4):
    src = _random(NY, NX, seed=5)
    kw = dict(SOLVER, sources=src, check_every=check_every, seed=seed)
    return (jax_poisson.PoissonSolver(**kw),
            PoissonSolver(device="cpu", **kw))


def _assert_solvers_agree(j, t):
    assert (t.num_iterations, t.converged) == (j.num_iterations,
                                                bool(j.converged))
    for name in ("f", "rho", "u", "v"):
        d = float(np.abs(np.asarray(getattr(j, name))
                         - getattr(t, name).numpy()).max())
        assert d < TOL, (name, d)


def test_initial_state_is_bitwise_the_jax_one():
    j, t = _solvers(10, seed=7)
    np.testing.assert_array_equal(t.f.numpy(), np.asarray(j.f))
    np.testing.assert_array_equal(t.scaled_sources.numpy(),
                                  np.asarray(j.scaled_sources))


@pytest.mark.parametrize("check_every", [1, 10])
def test_solver_matches_jax_fixed_iterations(check_every):
    """37 iterations, not a multiple of 10: the last block is short."""
    j, t = _solvers(check_every)
    j.run(37)
    t.run(37)
    assert t.num_iterations == 37 and not t.converged
    _assert_solvers_agree(j, t)
    # the host read the flag once per block
    assert t._loop.reads == -(-37 // check_every)
    assert t._loop.iterations == 37


@pytest.mark.parametrize("check_every", [1, 10])
def test_solver_matches_jax_to_convergence(check_every):
    j, t = _solvers(check_every)
    j.run(5000)
    t.run(5000)
    assert t.converged and t.num_iterations < 5000
    _assert_solvers_agree(j, t)
    # a warm restart with a new source resets the counter
    new = 1.5 * _random(NY, NX, seed=6)
    j.update_source(new)
    t.update_source(torch.tensor(new))
    assert t.num_iterations == 0
    j.run(23)
    t.run(23)
    _assert_solvers_agree(j, t)


def test_first_iteration_is_never_converged():
    """``it != 1`` (solver.py:346-347): after a restart from a converged
    state the check passes at once, but iteration 1 is never converged."""
    j, t = _solvers(1)
    src = _random(NY, NX, seed=5)
    for sim in (j, t):
        sim.run(5000)
        sim.update_source(src)
        sim.run(1)
        assert not sim.converged and sim.num_iterations == 1
        sim.run(1)
        assert sim.converged and sim.num_iterations == 2
    _assert_solvers_agree(j, t)


def test_state_moves_between_the_packages():
    j, t = _solvers(10)
    j.run(15)
    t.load_numpy_state((np.asarray(j.f), np.asarray(j.rho), np.asarray(j.u),
                        np.asarray(j.v)))
    j.num_iterations = t.num_iterations = 15
    j.run(12)
    t.run(12)
    _assert_solvers_agree(j, t)
    state = t.state_numpy()
    assert [a.shape for a in state] == [(9, NY, NX)] + [(NY, NX)] * 3
    with pytest.raises(ValueError):
        t.load_numpy_state(state[:3])


def test_get_fields_is_x_major():
    j, t = _solvers(10)
    j.run(30)
    t.run(30)
    jf, tf = j.get_fields(), t.get_fields()
    for name in ("f", "feq", "rho", "u", "v"):
        assert tf[name].shape == jf[name].shape
        assert np.abs(tf[name] - jf[name]).max() < TOL, name


def _laplacian5(a):
    return (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2] + a[1:-1, 2:]
            - 4 * a[1:-1, 1:-1])


def test_poisson_uniform_source():
    """tests/test_poisson.py:17-38: the steady state satisfies
    ``lap rho = -(1 - w0) S D_lb dt^2`` in the deep interior."""
    nx = ny = 32
    delta_x, delta_t = 1.0 / 30, (1.0 / 30) ** 2
    solver = PoissonSolver(nx=nx, ny=ny, sources=np.ones((ny, nx), np.float32),
                           delta_t=delta_t, delta_x=delta_x, tolerance=1e-7,
                           device="cpu")
    solver.run(20000)
    assert solver.converged
    lap = _laplacian5(solver.rho.numpy())
    expected = -(5.0 / 9.0) * solver.lb_D * delta_t**2
    deep = lap[3:-3, 3:-3]
    assert np.abs(deep - expected).max() < 0.15 * abs(expected)
    assert abs(deep.mean() - expected) < 0.05 * abs(expected)


def test_poisson_dirichlet_walls():
    """tests/test_poisson.py:41-49."""
    nx = ny = 24
    solver = PoissonSolver(nx=nx, ny=ny, sources=np.ones((ny, nx)),
                           delta_t=1e-3, delta_x=0.05, rho_on_boundary=0.25,
                           tolerance=1e-7, device="cpu")
    solver.run(20000)
    rho = solver.rho.numpy()
    for edge in (rho[0, 1:-1], rho[-1, 1:-1], rho[1:-1, 0], rho[1:-1, -1]):
        np.testing.assert_allclose(edge, 0.25, atol=2e-3)


def test_poisson_gradient_axis_quirk():
    """tests/test_poisson.py:52-66: u holds the y-derivative and v the
    x-derivative (D2Q9_poisson.cl:294-304), edges zero-padded."""
    ny, nx = 16, 24
    rho = torch.arange(ny, dtype=torch.float32)[:, None].expand(ny, nx)
    u, v = torch_poisson.negative_gradient(rho, delta_x=0.5)
    u, v = u.numpy(), v.numpy()
    np.testing.assert_allclose(u[1:-1, :], -2.0, atol=1e-6)
    np.testing.assert_allclose(v[1:-1, 1:-1], 0.0, atol=1e-6)
    assert not np.allclose(u[0, :], u[1, :])


def test_poisson_warm_restart():
    """tests/test_poisson.py:69-79: update_source keeps rho and resets the
    counter; the warm start converges faster."""
    nx = ny = 24
    solver = PoissonSolver(nx=nx, ny=ny, sources=np.ones((ny, nx)),
                           delta_t=1e-3, delta_x=0.05, tolerance=1e-6,
                           device="cpu")
    solver.run(20000)
    n1 = solver.num_iterations
    solver.update_source(np.ones((ny, nx)) * 1.001)
    assert solver.num_iterations == 0
    solver.run(20000)
    assert solver.num_iterations < n1


def test_sources_xy_and_timed_run():
    src = _random(NX, NY, seed=8)  # reference layout [nx, ny]
    t = PoissonSolver(device="cpu", **dict(SOLVER, sources=src),
                      sources_xy=True)
    j = jax_poisson.PoissonSolver(**dict(SOLVER, sources=src),
                                  sources_xy=True)
    np.testing.assert_array_equal(t.scaled_sources.numpy(),
                                  np.asarray(j.scaled_sources))
    t.run(20, timed=True)
    assert t.last_mlups > 0 and t.last_solve_seconds > 0
    with pytest.raises(ValueError):
        t.update_source(src)  # [nx, ny] without sources_xy
