"""The port's fused pipe-flow steps against the JAX package.

``pipe_step_reference`` (the plain PyTorch step, the CPU path of the CUDA
kernels' wrappers) is held against JAX's single-step Pallas kernel run in
interpret mode at 32x128, and against the JAX XLA step at the unaligned
31x61 where no JAX kernel runs. The CPU paths of the K-step wrapper (K2)
and of the one-launch run (K3) are held against JAX's temporal and
resident Pallas kernels in interpret mode. Tolerance 5e-7 after 4 float32
steps (7 for the resident run), the reference's kernel-vs-XLA bar
(tests/test_fused.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lb2d_tpu.models.pipe_flow import PipeFlow as JaxPipeFlow
from lb2d_tpu.ops.fused import (
    make_pipelined_pipe_step,
    make_resident_pipe_step,
    make_temporal_pipe_step,
)
from lb2d_tpu_torch.models import PipeFlow
from lb2d_tpu_torch.ops.fused import (
    MAX_TEMPORAL_K,
    pipe_step,
    pipe_step_reference,
    resident_pipe_run,
    temporal_pipe_step,
    temporal_velocity_step,
)

torch.set_num_threads(1)

PHYS = dict(diameter=1.0, rho=10.0, viscosity=5.0, pressure_grad=-100.0)
TOL = 5e-7
VARIANTS = [("compressible", False), ("incompressible", False),
            ("compressible", True), ("incompressible", True)]
IDS = ["compressible", "incompressible", "compressible-obstacle",
       "incompressible-obstacle"]


def _mask(ny, nx):
    mask = np.zeros((ny, nx), np.int32)
    mask[ny // 3:ny // 2 + 2, nx // 3:nx // 2] = 1
    return mask


def _jax_sim(ny, nx, equilibrium, obstacle):
    N = ny - 1
    return JaxPipeFlow(N=N, pipe_length=(nx - 1.5) / N, backend="xla",
                       equilibrium=equilibrium,
                       obstacle_mask=_mask(ny, nx) if obstacle else None,
                       **PHYS)


def _reference_run(sim, f0, mask, n=4):
    f = torch.from_numpy(np.array(f0))
    mask_t = None if mask is None else torch.from_numpy(mask)
    for _ in range(n):
        f = pipe_step_reference(
            f, sim.omega, sim.inlet_rho, sim.outlet_rho,
            incompressible=sim.equilibrium == "incompressible", mask=mask_t)
    return f.numpy()


@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_reference_matches_pallas_kernel(equilibrium, obstacle):
    ny, nx = 32, 128
    sim = _jax_sim(ny, nx, equilibrium, obstacle)
    mask = _mask(ny, nx) if obstacle else None
    kernel = make_pipelined_pipe_step(
        ny=ny, nx=nx, omega=sim.omega, inlet_rho=sim.inlet_rho,
        outlet_rho=sim.outlet_rho, equilibrium=equilibrium,
        has_obstacle=obstacle, interpret=True)
    f = sim.state
    for _ in range(4):
        f = kernel(f, jnp.asarray(mask)) if obstacle else kernel(f)
    got = _reference_run(sim, sim.state, mask)
    d = float(np.abs(np.asarray(f) - got).max())
    assert d < TOL, d


@pytest.mark.parametrize("equilibrium,obstacle", VARIANTS, ids=IDS)
def test_reference_matches_xla_step_unaligned(equilibrium, obstacle):
    ny, nx = 31, 61
    sim = _jax_sim(ny, nx, equilibrium, obstacle)
    assert (sim.ny, sim.nx) == (ny, nx)
    f0 = np.asarray(sim.state)
    got = _reference_run(sim, f0, _mask(ny, nx) if obstacle else None)
    sim.run(4)
    d = float(np.abs(np.asarray(sim.state) - got).max())
    assert d < TOL, d


@pytest.mark.parametrize("equilibrium,obstacle,shape,k", [
    ("compressible", False, (80, 128), 2),
    ("incompressible", True, (96, 128), 3),
], ids=["compressible-K2", "incompressible-obstacle-K3"])
def test_temporal_wrapper_matches_pallas_kernel(equilibrium, obstacle, shape,
                                                k):
    ny, nx = shape
    sim = _jax_sim(ny, nx, equilibrium, obstacle)
    mask = _mask(ny, nx) if obstacle else None
    kernel = make_temporal_pipe_step(
        ny=ny, nx=nx, omega=sim.omega, inlet_rho=sim.inlet_rho,
        outlet_rho=sim.outlet_rho, equilibrium=equilibrium,
        has_obstacle=obstacle, interpret=True, k_steps=k)
    f = sim.state
    f = kernel(f, jnp.asarray(mask)) if obstacle else kernel(f)
    f_in = torch.from_numpy(np.array(sim.state))
    got = temporal_pipe_step(
        f_in, torch.empty_like(f_in), k, sim.omega, sim.inlet_rho,
        sim.outlet_rho, incompressible=equilibrium == "incompressible",
        mask=None if mask is None else torch.from_numpy(mask))
    d = float(np.abs(np.asarray(f) - got.numpy()).max())
    assert d < TOL, d


@pytest.mark.parametrize("equilibrium,obstacle", [
    ("compressible", False), ("incompressible", True)],
    ids=["compressible", "incompressible-obstacle"])
def test_resident_wrapper_matches_pallas_kernel(equilibrium, obstacle):
    ny, nx, n = 32, 128, 7
    sim = _jax_sim(ny, nx, equilibrium, obstacle)
    mask = _mask(ny, nx) if obstacle else None
    run = make_resident_pipe_step(
        ny=ny, nx=nx, omega=sim.omega, inlet_rho=sim.inlet_rho,
        outlet_rho=sim.outlet_rho, equilibrium=equilibrium,
        has_obstacle=obstacle, interpret=True)
    f = run(sim.state, n, jnp.asarray(mask)) if obstacle else run(sim.state, n)
    got = torch.from_numpy(np.array(sim.state))
    assert resident_pipe_run(
        got, torch.empty_like(got), n, sim.omega, sim.inlet_rho,
        sim.outlet_rho, incompressible=equilibrium == "incompressible",
        mask=None if mask is None else torch.from_numpy(mask)) is got
    d = float(np.abs(np.asarray(f) - got.numpy()).max())
    assert d < TOL, d


def test_multi_step_wrappers_on_cpu_count_nothing():
    sim = _jax_sim(31, 61, "compressible", True)
    f0 = torch.from_numpy(np.array(sim.state))
    mask = torch.from_numpy(_mask(31, 61))
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False, mask=mask)
    want = f0
    for _ in range(3):
        want = pipe_step_reference(want, **kw)
    out = temporal_pipe_step(f0, torch.empty_like(f0), 3, **kw)
    assert torch.equal(out, want)
    f = f0.clone()
    resident_pipe_run(f, torch.empty_like(f), 3, **kw)
    assert torch.equal(f, want)
    resident_pipe_run(f, torch.empty_like(f), 0, **kw)
    assert torch.equal(f, want)
    assert temporal_pipe_step.launches == resident_pipe_run.launches == 0
    assert temporal_velocity_step.launches == 0


def test_multi_step_wrappers_reject_bad_step_counts():
    f = torch.zeros((9, 8, 12))
    kw = dict(omega=1.0, inlet_rho=1.0, outlet_rho=1.0, incompressible=False)
    for k in (0, MAX_TEMPORAL_K + 1):
        with pytest.raises(ValueError, match="k_steps"):
            temporal_pipe_step(f, torch.zeros_like(f), k, **kw)
    with pytest.raises(ValueError, match="n must be"):
        resident_pipe_run(f, torch.zeros_like(f), -1, **kw)
    vel = dict(omega=1.0, u_w=0.1, u_e=0.1, incompressible=False)
    with pytest.raises(ValueError, match="k_steps"):
        temporal_velocity_step(f, torch.zeros_like(f), MAX_TEMPORAL_K + 1,
                               outlet="velocity", **vel)
    with pytest.raises(ValueError, match="outlet"):
        temporal_velocity_step(f, torch.zeros_like(f), 2, outlet="open", **vel)
    with pytest.raises(ValueError, match="distinct"):
        resident_pipe_run(f, f, 2, **kw)


def test_wrapper_on_cpu_runs_the_reference_and_counts_nothing():
    sim = _jax_sim(31, 61, "compressible", True)
    f_in = torch.from_numpy(np.array(sim.state))
    mask = torch.from_numpy(_mask(31, 61))
    f_out = torch.empty_like(f_in)
    before = pipe_step.launches
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False)
    assert pipe_step(f_in, f_out, mask=mask, **kw) is f_out
    assert pipe_step.launches == before == 0
    assert torch.equal(f_out, pipe_step_reference(f_in, mask=mask, **kw))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.zeros((9, 8, 12))
    kw = dict(omega=1.0, inlet_rho=1.0, outlet_rho=1.0, incompressible=False)
    with pytest.raises(ValueError, match="distinct"):
        pipe_step(f, f, **kw)
    with pytest.raises(TypeError, match="float32"):
        pipe_step(f.double(), torch.zeros_like(f).double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pipe_step(f, torch.zeros((9, 12, 8)).transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="mask"):
        pipe_step(f, torch.zeros_like(f), mask=torch.zeros((8, 12)), **kw)


def test_kernel_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        PipeFlow(N=15, pipe_length=2.0, device="cpu", backend="kernel",
                 **PHYS)


@pytest.mark.parametrize("backend", ["temporal", "resident"])
def test_multi_step_kernel_backends_on_cpu_raise(backend):
    with pytest.raises(ValueError, match="CUDA"):
        PipeFlow(N=15, pipe_length=2.0, device="cpu", backend=backend,
                 **PHYS)


@pytest.mark.parametrize("backend", ["pipelined", "fused"])
def test_unported_backends_name_their_roadmap_entry(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PipeFlow(N=15, pipe_length=2.0, device="cpu", backend=backend, **PHYS)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The build module pointed at an empty build directory."""
    from lb2d_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "_build" / "lib.so")
    return _build


def test_build_without_nvcc_raises(fresh_build, monkeypatch, tmp_path):
    monkeypatch.setattr(fresh_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fresh_build.load_library()


def test_failed_build_raises_with_nvcc_stderr(fresh_build, monkeypatch,
                                               tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(fresh_build.shutil, "which", lambda name: str(nvcc))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        fresh_build.load_library()
    assert not fresh_build.LIB_PATH.exists()
    assert not list(fresh_build.LIB_PATH.parent.glob("*.tmp"))
