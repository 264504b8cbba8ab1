"""The port's flow models against the JAX models, and its physics on its own.

Parity: each port model is built from the same arguments as its JAX model,
given the JAX state with ``load_numpy_state``, and both run 4 steps (the
port on the CPU through its eager path). Tolerance 5e-7, the reference's
kernel-vs-XLA bar (tests/test_fused.py).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lb2d_tpu.models as jax_models
import lb2d_tpu_torch.models as torch_models

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 5e-7
PHYS = dict(diameter=1.0, rho=10.0, viscosity=5.0, pressure_grad=-100.0)
POISEUILLE = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
                  pipe_length=3.0)


def _mask(ny, nx):
    mask = np.zeros((ny, nx), np.int32)
    mask[ny // 3:ny // 2 + 2, nx // 3:nx // 2] = 1
    return mask


def _pipe(ny, nx, **kw):
    N = ny - 1
    return dict(N=N, pipe_length=(nx - 1.5) / N, **PHYS, **kw)


# name -> (class name, constructor arguments for a ny x nx grid)
CASES = {
    "compressible": ("PipeFlow", lambda ny, nx: _pipe(ny, nx)),
    "incompressible": ("PipeFlow", lambda ny, nx: _pipe(
        ny, nx, equilibrium="incompressible")),
    "obstacle": ("PipeFlowObstacles", lambda ny, nx: _pipe(
        ny, nx, obstacle_mask=_mask(ny, nx))),
    "incompressible-obstacle": ("PipeFlowObstacles", lambda ny, nx: _pipe(
        ny, nx, obstacle_mask=_mask(ny, nx), equilibrium="incompressible")),
    "lattice-units": ("LatticePipeFlow", lambda ny, nx: dict(
        omega=1.1, lx=nx - 1, ly=ny - 1, deltaP=-0.001)),
    "velocity-inlet": ("PipeFlowVelocityInlet", lambda ny, nx: dict(
        u_w=0.05, omega=1.2, lx=nx - 1, ly=ny - 1)),
    "velocity-inlet-obstacle": ("PipeFlowVelocityInlet", lambda ny, nx: dict(
        u_w=0.05, omega=1.2, lx=nx - 1, ly=ny - 1,
        obstacle_mask=_mask(ny, nx))),
    "velocity-pair": ("PipeFlowVelocityInlet", lambda ny, nx: dict(
        u_w=0.05, omega=1.2, lx=nx - 1, ly=ny - 1, outlet="velocity")),
}


def _perturbed(state):
    """A 1% numpy perturbation, so that flows starting uniform move too."""
    rng = np.random.RandomState(1)
    return (np.asarray(state) * (1 + 0.01 * rng.randn(*np.shape(state)))
            ).astype(np.float32)


def _parity(jax_sim, torch_sim, n=4):
    assert (torch_sim.ny, torch_sim.nx) == (jax_sim.ny, jax_sim.nx)
    f0 = _perturbed(jax_sim.state)
    jax_sim.state = jnp.asarray(f0)
    torch_sim.load_numpy_state(f0)
    jax_sim.run(n)
    torch_sim.run(n)
    d = float(np.abs(np.asarray(jax_sim.state) - torch_sim.state_numpy()).max())
    assert d < TOL, d


@pytest.mark.parametrize("shape", [(32, 128), (31, 61)], ids=["32x128", "31x61"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, shape):
    cls, make_kw = CASES[case]
    kw = make_kw(*shape)
    jax_sim = getattr(jax_models, cls)(**kw)
    torch_sim = getattr(torch_models, cls)(device="cpu", **kw)
    assert torch_sim.backend == "eager"
    _parity(jax_sim, torch_sim)


def test_cylinder_matches_jax():
    # N=10 keeps the inlet density near 1 (it grows as nx / N^3)
    kw = dict(cylinder_center=(0.2, 0.15), cylinder_radius=0.1, N=10,
              **dict(PHYS, diameter=0.3), pipe_length=0.6)
    jax_sim = jax_models.PipeFlowCylinder(**kw)
    torch_sim = torch_models.PipeFlowCylinder(device="cpu", **kw)
    assert (torch_sim.ny, torch_sim.nx) == (31, 61)
    np.testing.assert_array_equal(torch_sim.obstacle_mask.numpy(),
                                  np.asarray(jax_sim.obstacle_mask))
    _parity(jax_sim, torch_sim)


@pytest.mark.parametrize("case", ["compressible", "incompressible",
                                  "velocity-inlet"])
def test_initial_state_is_bitwise_the_jax_one(case):
    cls, make_kw = CASES[case]
    kw = make_kw(31, 61)
    jax_sim = getattr(jax_models, cls)(seed=3, **kw)
    torch_sim = getattr(torch_models, cls)(device="cpu", seed=3, **kw)
    np.testing.assert_array_equal(torch_sim.state_numpy(),
                                  np.asarray(jax_sim.state))
    assert torch_sim.state.is_contiguous()  # the kernel takes C order only


def poiseuille_rms_error(N, time_to_run=10.0):
    """The recipe of tests/test_pipe_flow.py on the port's eager path."""
    sim = torch_models.PipeFlow(N=N, time_prefactor=1.0, device="cpu",
                                **POISEUILLE)
    sim.run(int(time_to_run / sim.units.delta_t))
    mean_u = sim.get_physical_fields()["u"].T.mean(axis=1)  # [ny]
    y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
    D, rho, nu = (POISEUILLE[k] for k in ("diameter", "rho", "viscosity"))
    predicted = (1.0 / (2 * rho * nu)) * POISEUILLE["pressure_grad"] * y * (y - D)
    return float(np.sqrt(((mean_u - predicted) ** 2).mean())), float(predicted.max())


def test_poiseuille_matches_theory():
    err, umax = poiseuille_rms_error(N=10)
    assert umax == pytest.approx(0.5625, rel=1e-12)
    assert err < 0.05 * umax, f"RMS error {err} too large vs u_max {umax}"


def test_poiseuille_resolution_convergence():
    err10, _ = poiseuille_rms_error(N=10)
    err30, _ = poiseuille_rms_error(N=30)
    assert err30 < err10, (err10, err30)


def test_cylinder_runs_and_conserves_mass():
    sim = torch_models.PipeFlowCylinder(
        cylinder_center=(0.75, 0.75), cylinder_radius=0.1, N=8, device="cpu",
        **POISEUILLE)
    rho_before = sim.get_fields()["rho"].mean()
    sim.run(200)
    fields = sim.get_fields()
    assert np.isfinite(fields["rho"]).all()
    assert abs(fields["rho"].mean() - rho_before) < 0.1
    assert int(sim.obstacle_mask.sum()) > 0.9 * np.pi * sim.units.N**2


def test_get_fields_shapes_and_xy_order():
    sim = torch_models.PipeFlow(device="cpu", **_pipe(31, 61))
    sim.run(3)
    fields = sim.get_fields()
    assert fields["f"].shape == fields["feq"].shape == (9, 61, 31)
    for name in ("rho", "u", "v"):
        assert fields[name].shape == (61, 31)
    f = sim.state_numpy()
    x, y = 5, 17
    assert fields["rho"][x, y] == pytest.approx(float(f[:, y, x].sum()), abs=1e-6)
    assert fields["f"][2, x, y] == f[2, y, x]
    rho_dev = sim.device_field("rho")
    assert tuple(rho_dev.shape) == (31, 61)
    phys = sim.get_physical_fields()
    scale = (sim.units.velocity_lb_to_nondim * sim.units.velocity_nondim_to_phys)
    np.testing.assert_allclose(phys["u"], fields["u"] * scale, rtol=1e-6)


def test_lattice_units_api():
    sim = torch_models.LatticePipeFlow(omega=0.99, lx=31, ly=15,
                                       deltaP=-0.001, device="cpu")
    assert (sim.nx, sim.ny) == (32, 16)
    assert sim.outlet_rho == pytest.approx(1.0 - 0.001 * 3.0)
    sim.run(300)
    assert sim.steps_taken == 300
    fields = sim.get_fields()
    assert np.isfinite(fields["u"]).all()
    assert fields["u"][2:-2, 2:-2].mean() > 0
    visc, Re, Ma = sim.update_dimensionless_nums()
    assert visc == pytest.approx((1.0 / 3.0) * (0.99 - 0.5))
    assert Re > 0 and Ma > 0
    with pytest.raises(NotImplementedError):
        sim.get_nondim_fields()


def test_velocity_inlet_kernel_backend_is_not_ported():
    with pytest.raises(NotImplementedError, match="K2"):
        torch_models.PipeFlowVelocityInlet(lx=31, ly=15, device="cpu",
                                           backend="kernel")


def _seen_on_cuda(sim):
    """The model as the backend picker would see it on a CUDA device (the
    picker reads only the device type, the dtype and the grid)."""
    sim.device = torch.device("cuda")
    return sim


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_auto_backend_on_cuda_never_picks_eager_quietly(dtype):
    sim = torch_models.PipeFlow(device="cpu", dtype=dtype, **_pipe(31, 61))
    assert sim.backend == "eager"  # the CPU default
    _seen_on_cuda(sim)
    for backend in ("auto", "resident", "temporal", "kernel"):
        with pytest.raises(ValueError, match="float32"):
            sim._pick_backend(backend)
    assert sim._pick_backend("eager") == "eager"


def test_auto_backend_ladder_on_cuda():
    sim = _seen_on_cuda(torch_models.PipeFlow(device="cpu", **_pipe(32, 256)))
    assert sim._pick_backend("auto") == "resident"
    sim.ny, sim.nx = 4096, 4096
    assert sim._pick_backend("auto") == "temporal"
    for backend in ("resident", "temporal", "kernel"):
        assert sim._pick_backend(backend) == backend
    inlet = _seen_on_cuda(torch_models.PipeFlowVelocityInlet(
        lx=31, ly=15, device="cpu"))
    assert inlet._pick_backend("auto") == "temporal"
    assert inlet._pick_backend("resident") == "resident"  # by name only
    with pytest.raises(NotImplementedError, match="K2"):
        inlet._pick_backend("kernel")


WIRING = {  # case -> (model of CASES, backend)
    "resident": ("obstacle", "resident"),
    "temporal": ("obstacle", "temporal"),
    "kernel": ("obstacle", "kernel"),
    "velocity-inlet-obstacle": ("velocity-inlet-obstacle", "temporal"),
    "velocity-pair": ("velocity-pair", "temporal"),
    "velocity-inlet-obstacle-resident": ("velocity-inlet-obstacle",
                                         "resident"),
}
WRAPPERS = ("pipe_step", "temporal_pipe_step", "resident_pipe_run",
            "temporal_velocity_step", "resident_velocity_run")


@pytest.mark.parametrize("case", list(WIRING))
def test_kernel_backend_wiring_matches_eager(case, monkeypatch):
    """The kernel backends' buffers and run hooks, one `_make_kernel_step`
    for the pressure-driven and the velocity-inlet models, on the CPU where
    each wrapper runs its plain version: K + 3 steps, K the model's
    TEMPORAL_K or VELOCITY_TEMPORAL_K, are one K2 launch of K steps and one
    of 3 with "temporal", one K3 call with "resident" and K + 3 K1 steps
    with "kernel"."""
    from lb2d_tpu_torch.models import lattice_units, pipe_flow
    from lb2d_tpu_torch.ops import fused

    monkeypatch.setattr(pipe_flow._build, "load_library", lambda: None)
    model, backend = WIRING[case]
    cls, make_kw = CASES[model]
    kw = make_kw(31, 61)
    eager = getattr(torch_models, cls)(device="cpu", **kw)
    sim = getattr(torch_models, cls)(device="cpu", **kw)
    sim.backend = backend
    calls = []  # (wrapper, steps)
    for module in (pipe_flow, lattice_units):
        for name in WRAPPERS:
            if not hasattr(module, name):
                continue

            def counted(*args, _w=getattr(fused, name), _n=name, **kwargs):
                calls.append((_n, args[2] if len(args) > 2 else 1))
                return _w(*args, **kwargs)

            monkeypatch.setattr(module, name, counted)
    sim._step = sim.make_step()
    velocity = cls == "PipeFlowVelocityInlet"
    k = pipe_flow.VELOCITY_TEMPORAL_K if velocity else pipe_flow.TEMPORAL_K
    n = k + 3
    f0 = _perturbed(eager.state)
    eager.load_numpy_state(f0)
    sim.load_numpy_state(f0)
    eager.run(n)
    sim.run(n)
    assert torch.equal(sim.state, eager.state)
    assert sim.steps_taken == n
    family = "velocity" if velocity else "pipe"
    assert calls == {
        "resident": [(f"resident_{family}_run", n)],
        "temporal": [(f"temporal_{family}_step", k),
                     (f"temporal_{family}_step", 3)],
        "kernel": [("pipe_step", 1)] * n}[backend]
    assert sim.steps_per_call == (k if backend == "temporal" else 1)



def test_velocity_inlet_launch_length_follows_the_loop():
    """The velocity inlet's steps per K2 launch: VELOCITY_TEMPORAL_K where
    the wrapper runs the 32 x 32 tiles (up to VELOCITY_TILE_MAX_CELLS
    cells), TEMPORAL_K on the row sweep above."""
    from lb2d_tpu_torch.models import pipe_flow
    from lb2d_tpu_torch.ops import fused

    side = {"tiles": 400, "sweep": 640}  # lx: an (lx + 1)^2 grid
    for loop, lx in side.items():
        sim = torch_models.PipeFlowVelocityInlet(lx=lx, ly=lx, device="cpu")
        tiles = sim.ny * sim.nx <= fused.VELOCITY_TILE_MAX_CELLS
        assert tiles == (loop == "tiles")
        assert sim._temporal_k == (pipe_flow.VELOCITY_TEMPORAL_K if tiles
                                   else pipe_flow.TEMPORAL_K)


def test_velocity_inlet_matches_jax_temporal_kernel():
    """The CPU path of the velocity K2 wrapper against JAX's
    physics="velocity_inlet" Pallas kernel (interpret mode) with its
    y-seam patch, 2 steps from a perturbed state."""
    from lb2d_tpu_torch.ops.fused import temporal_velocity_step

    kw = dict(u_w=0.05, omega=1.2, lx=127, ly=95)
    jax_sim = jax_models.PipeFlowVelocityInlet(**kw)
    step2 = jax_sim._make_temporal_step(2, interpret=True)
    f0 = _perturbed(jax_sim.state)
    want = np.asarray(step2(jnp.asarray(f0)))
    f_in = torch.from_numpy(f0)
    got = temporal_velocity_step(f_in, torch.empty_like(f_in), 2, 1.2, 0.05,
                                 0.05, outlet="zero_gradient",
                                 incompressible=False)
    d = float(np.abs(want - got.numpy()).max())
    assert d < TOL, d


def test_timed_run_records_mlups():
    sim = torch_models.PipeFlow(device="cpu", **_pipe(31, 61))
    sim.run(2, timed=True)
    assert sim.last_mlups > 0 and sim.steps_taken == 2


def test_port_source_never_imports_jax():
    offenders = []
    for path in (REPO / "lb2d_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path}: {n}" for n in names
                          if n == "jax" or n.startswith(("jax.", "jaxlib"))]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = ("import sys, lb2d_tpu_torch.models; "
            "sys.exit('jax' in sys.modules or 'jaxlib' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
