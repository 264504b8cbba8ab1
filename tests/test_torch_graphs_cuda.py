"""The Poisson slice's CUDA graphs on the card.

Marked ``cuda``: they skip without a CUDA device. Imports no JAX; run on the
card with ``python -m pytest --noconftest tests/test_torch_graphs_cuda.py``.
``PoissonSolver``'s blocks of ``check_every`` iterations and the tracking
``RepellingFisherWave``'s outer step replay CUDA graphs of plain torch ops:
a replay equals the same ops run eagerly on the card (tolerance 0), and the
card agrees with the CPU's eager path within 1e-5 of the field's scale (the
card divides by a scalar as a reciprocal product and sums in other orders).
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.models import PoissonSolver, RepellingFisherWave

pytestmark = pytest.mark.cuda

CARD_VS_CPU = 1e-5
SOLVER = dict(nx=56, ny=40, delta_t=1e-3, delta_x=0.05, rho_on_boundary=0.1,
              tolerance=0.0)
WAVE = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24, max_inner_iter=60,
            inner_tolerance=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _solver(device, **kw):
    src = np.random.RandomState(5).rand(40, 56).astype(np.float32)
    return PoissonSolver(sources=src, device=device, **dict(SOLVER, **kw))


def test_solver_blocks_replay_and_agree_with_the_cpu(cuda):
    """37 iterations: three replayed blocks and a short eager one."""
    card, cpu = _solver(cuda), _solver("cpu")
    card.run(37)
    cpu.run(37)
    loop = card._loop
    assert (loop.replays, loop.reads, loop.iterations) == (3, 4, 37)
    assert card.num_iterations == 37 and not card.converged
    scale = float(cpu.f.abs().max())
    d = float((card.f.cpu() - cpu.f).abs().max()) / scale
    assert d <= CARD_VS_CPU, d


def test_replayed_block_equals_the_eager_block(cuda):
    card = _solver(cuda)
    card.run(20)
    loop = card._loop
    f0, rho0, react0 = loop.f.clone(), loop.rho.clone(), loop.react.clone()
    loop.run_block(loop.check_every)
    f_e, rho_e, _ = loop.block(f0, rho0, react0, loop.check_every)
    torch.cuda.synchronize()
    assert torch.equal(loop.f, f_e) and torch.equal(loop.rho, rho_e)


def test_converged_solve_refreshes_the_gradient(cuda):
    card, cpu = (_solver(d, tolerance=1e-5) for d in (cuda, "cpu"))
    card.run(5000)
    cpu.run(5000)
    assert card.converged and cpu.converged
    # the same block, or the next one, converges on either device
    assert abs(card.num_iterations - cpu.num_iterations) <= card.check_every
    scale = float(cpu.u.abs().max())
    assert float(card.u.abs().max()) > 0
    assert float((card.u.cpu() - cpu.u).abs().max()) <= 1e-3 * scale


def test_tracking_step_replays_its_eager_step(cuda):
    sim = RepellingFisherWave(device=cuda, inner_per_step=2, **WAVE)
    before = sim.graph_replays  # the initial converge's blocks
    sim.run(2)
    state = tuple(t.clone() for t in sim.state)
    eager = sim._step(state)
    sim.run(1)
    torch.cuda.synchronize()
    assert sim.graph_replays == before + 3
    for a, b in zip(sim.state, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [{}, {"reuse_tolerance": 1e-4}],
                         ids=["exact", "gated"])
def test_wave_solves_through_graphs(cuda, mode):
    sim = RepellingFisherWave(device=cuda, **WAVE, **mode)
    cpu = RepellingFisherWave(device="cpu", **WAVE, **mode)
    sim.run(3)
    cpu.run(3)
    drift_reads = 3 if mode else 0
    # max_inner_iter 60: every block is full, so every block is a replay
    assert sim.host_reads == sim.graph_replays + drift_reads
    assert sim.graph_replays >= 1
    rho, rho_cpu = sim.state[0].sum(0).cpu(), cpu.state[0].sum(0)
    d = float((rho - rho_cpu).abs().max()) / float(rho_cpu.abs().max())
    assert d <= CARD_VS_CPU, d
