"""The CUDA pipe-flow kernels against their plain PyTorch version, on the card.

Marked ``cuda``: they skip without a CUDA device. Imports no JAX, so it
runs on a machine that has none; ``tests/conftest.py`` imports JAX, so run
it there with ``python -m pytest --noconftest tests/test_torch_kernel_cuda.py``.
Tolerance 1e-6 after up to 9 steps (~30 ulp at |f| <= 0.45): nvcc
contracts multiply-adds into FMAs where PyTorch runs separate elementwise
kernels.
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.models import PipeFlow, PipeFlowVelocityInlet
from lb2d_tpu_torch.ops.fused import (
    pipe_run_reference,
    pipe_step,
    pipe_step_reference,
    resident_pipe_run,
    temporal_pipe_step,
    temporal_velocity_step,
    velocity_step_reference,
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


# 5x7 is smaller than one 32x32 K2 tile, which then wraps onto itself
@pytest.mark.parametrize("shape", [(254, 382), (31, 61), (5, 7)],
                         ids=["254x382", "31x61", "5x7"])
@pytest.mark.parametrize("k", [1, 3, 8])
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


@pytest.mark.parametrize("shape", [(254, 382), (31, 61), (5, 7)],
                         ids=["254x382", "31x61", "5x7"])
@pytest.mark.parametrize("k", [1, 3, 8])
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


@pytest.mark.parametrize("shape", [(32, 256), (31, 61), (5, 7)],
                         ids=["32x256", "31x61", "5x7"])
@pytest.mark.parametrize("n", [1, 8, 9])
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
