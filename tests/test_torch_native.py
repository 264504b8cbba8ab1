"""The port's C++ CPU engine (``lb2d_tpu_torch.native``) against the JAX
package's, and against the port's eager step.

The two packages build the same source with the same flags and compiler,
so their engines give the same bits: held equal, raw and through the
models (``run(20)``: the state, and ``get_fields()`` to the ulps of the
getters' own sums). Against the eager step
the bar is ``tests/test_native.py``'s, 1e-5. Grids stay tiny: six test
workers share the machine's cores, each with OpenMP threads. No wall-clock
assertion.
"""

import numpy as np
import pytest
import torch

import lb2d_tpu.models as jax_models
import lb2d_tpu_torch.models as torch_models
from lb2d_tpu.native import native_run as jax_native_run
from lb2d_tpu_torch import native
from lb2d_tpu_torch.native import native_run

torch.set_num_threads(1)

PHYS = dict(diameter=1.0, rho=10.0, viscosity=5.0, pressure_grad=-100.0)
PIPE = dict(N=15, pipe_length=30.5 / 15, **PHYS)  # 16 x 32
TOL = 1e-5  # tests/test_native.py:24
# the fields of two equal states: torch and XLA add a cell's moments in
# their own orders, so a cell's rho, u, v or feq may differ by an ulp or two
FIELDS_TOL = 1e-6


def _obstacle():
    mask = np.zeros((16, 32), np.int32)
    mask[6:10, 12:18] = 1
    return mask


# tests/test_native.py:15-52: name -> (model arguments, steps)
RAW_CASES = {
    "compressible": (dict(), 10),
    "obstacle": (dict(obstacle_mask=_obstacle()), 8),
    "incompressible": (dict(equilibrium="incompressible"), 6),
}


def _engine_args(sim):
    return dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
                outlet_rho=sim.outlet_rho,
                incompressible=sim.equilibrium == "incompressible")


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_native_run_is_the_jax_engine_bit_for_bit(case):
    kw, n = RAW_CASES[case]
    sim = jax_models.PipeFlow(backend="xla", **PIPE, **kw)
    f0 = np.asarray(sim.state)
    mask = kw.get("obstacle_mask")
    want = jax_native_run(f0, n, mask=mask, **_engine_args(sim))
    got = native_run(f0, n, mask=mask, **_engine_args(sim))
    assert got.dtype == np.float32 and got.shape == f0.shape
    assert np.array_equal(got, want)


# and the case that the JAX package's engine gets wrong: the incompressible
# equilibrium zeroes the velocity inside an obstacle (opencl_dim_D2Q9i.py:
# 494-502), which JAX's XLA step and the port do and JAX's engine does not
EAGER_CASES = dict(RAW_CASES, **{"incompressible-obstacle": (dict(
    equilibrium="incompressible", obstacle_mask=_obstacle()), 20)})


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_native_run_matches_the_eager_step(case):
    kw, n = EAGER_CASES[case]
    sim = torch_models.PipeFlow(device="cpu", backend="eager", **PIPE, **kw)
    f0 = sim.state.clone()
    got = native_run(f0, n, mask=kw.get("obstacle_mask"), **_engine_args(sim))
    sim.run(n)
    d = float(np.abs(got - sim.state_numpy()).max())
    assert d < TOL, d


def test_incompressible_obstacle_follows_jax_xla_step():
    kw = dict(PIPE, equilibrium="incompressible", obstacle_mask=_obstacle())
    want = jax_models.PipeFlow(backend="xla", **kw)
    got = torch_models.PipeFlow(backend="native", device="cpu", **kw)
    want.run(20)
    got.run(20)
    d = float(np.abs(got.state_numpy() - np.asarray(want.state)).max())
    assert d < TOL, d


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_native_run_leaves_its_input_alone(as_tensor):
    sim = torch_models.PipeFlow(device="cpu", **PIPE)
    f0 = sim.state_numpy()
    f = torch.from_numpy(f0.copy()) if as_tensor else f0.copy()
    out = native_run(f, 5, **_engine_args(sim))
    before = f.numpy() if as_tensor else f
    assert np.array_equal(before, f0)
    assert not np.array_equal(out, f0)
    assert not np.shares_memory(out, before)


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_native_run_other_dtypes_raise(dtype):
    f = np.ones((9, 4, 6), dtype)
    with pytest.raises(ValueError, match="float32"):
        native_run(f, 1, omega=1.0, inlet_rho=1.0, outlet_rho=1.0)


def test_native_run_checks_shapes():
    with pytest.raises(ValueError, match=r"\[9, ny, nx\]"):
        native_run(np.ones((5, 4, 6), np.float32), 1, omega=1.0,
                   inlet_rho=1.0, outlet_rho=1.0)
    with pytest.raises(ValueError, match="mask"):
        native_run(np.ones((9, 4, 6), np.float32), 1, omega=1.0,
                   inlet_rho=1.0, outlet_rho=1.0,
                   mask=np.zeros((6, 4), np.int32))


# name -> (JAX model, port model, arguments)
MODEL_CASES = {
    "PipeFlow": ("PipeFlow", dict(PIPE)),
    "PipeFlow-incompressible": ("PipeFlow", dict(
        PIPE, equilibrium="incompressible")),
    "PipeFlowObstacles": ("PipeFlowObstacles", dict(
        PIPE, obstacle_mask=_obstacle())),
    "PipeFlowCylinder": ("PipeFlowCylinder", dict(
        N=4, pipe_length=3.0, cylinder_center=(0.75, 0.5),
        cylinder_radius=0.1, diameter=1.0, rho=1.0, viscosity=1.0,
        pressure_grad=-10.0)),
    "LatticePipeFlow": ("LatticePipeFlow", dict(
        omega=1.1, lx=31, ly=15, deltaP=-0.001)),
    "LatticePipeFlow-incompressible": ("LatticePipeFlow", dict(
        omega=1.1, lx=31, ly=15, deltaP=-0.001,
        equilibrium="incompressible")),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_native_model_is_the_jax_native_model(case):
    name, kw = MODEL_CASES[case]
    want = getattr(jax_models, name)(backend="native", **kw)
    got = getattr(torch_models, name)(backend="native", device="cpu", **kw)
    assert got.backend == "native"
    assert np.array_equal(got.state_numpy(), np.asarray(want.state))
    want.run(20)
    got.run(20, timed=True)
    assert got.steps_taken == 20 and got.last_mlups > 0
    assert isinstance(got.state, torch.Tensor) and got.state.device.type == "cpu"
    assert np.array_equal(got.state_numpy(), np.asarray(want.state))
    want_fields, got_fields = want.get_fields(), got.get_fields()
    assert set(got_fields) == set(want_fields)
    np.testing.assert_array_equal(got_fields["f"], np.asarray(want_fields["f"]))
    for key, value in want_fields.items():  # the getters' own float32 sums
        d = float(np.abs(got_fields[key] - np.asarray(value)).max())
        assert d <= FIELDS_TOL, (key, d)


@pytest.mark.parametrize("equilibrium", ["compressible", "incompressible"])
def test_native_model_matches_the_eager_model(equilibrium):
    kw = dict(PIPE, obstacle_mask=_obstacle(), equilibrium=equilibrium)
    nat = torch_models.PipeFlowObstacles(backend="native", device="cpu", **kw)
    eager = torch_models.PipeFlowObstacles(backend="eager", device="cpu", **kw)
    nat.run(13)
    nat.run(7)
    eager.run(20)
    assert nat.steps_taken == 20
    d = float((nat.state - eager.state).abs().max())
    assert d < TOL, d


def test_native_model_steps_and_getters_use_the_eager_step():
    sim = torch_models.PipeFlow(backend="native", device="cpu", **PIPE)
    eager = torch_models.PipeFlow(backend="eager", device="cpu", **PIPE)
    assert torch.equal(sim.make_step()(sim.state), eager._step(eager.state))
    fields = sim.get_physical_fields()
    assert fields["u"].shape == (sim.nx, sim.ny)


def test_auto_never_picks_native():
    sim = torch_models.PipeFlow(device="cpu", **PIPE)
    assert sim.backend == "eager"
    sim.device = torch.device("cuda")  # as the picker would see it on a card
    assert sim._pick_backend("auto") in ("resident", "temporal")
    assert sim._pick_backend("native") == "native"


def test_velocity_inlet_native_raises():
    with pytest.raises(ValueError, match="pressure BCs only"):
        torch_models.PipeFlowVelocityInlet(lx=31, ly=15, device="cpu",
                                           backend="native")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_native_model_other_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="float32"):
        torch_models.PipeFlow(backend="native", device="cpu", dtype=dtype,
                              **PIPE)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The engine's build pointed at an empty build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "_build" / "lib.so")
    return native


def _count_eager_steps(monkeypatch):
    from lb2d_tpu_torch.models import pipe_flow

    calls = []
    plain = pipe_flow.pipe_step_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(pipe_flow, "pipe_step_reference", counted)
    return calls


def test_build_without_gxx_raises_and_runs_nothing(fresh_native,
                                                   monkeypatch):
    monkeypatch.setattr(fresh_native.shutil, "which", lambda name: None)
    calls = _count_eager_steps(monkeypatch)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        torch_models.PipeFlow(backend="native", device="cpu", **PIPE)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_run(np.ones((9, 4, 6), np.float32), 1, omega=1.0,
                   inlet_rho=1.0, outlet_rho=1.0)
    assert not fresh_native.is_available()
    assert calls == []
    assert not fresh_native.LIB_PATH.exists()


def test_failed_build_raises_with_gxx_stderr(fresh_native, monkeypatch,
                                             tmp_path):
    gxx = tmp_path / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: no such builtin' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(fresh_native.shutil, "which", lambda name: str(gxx))
    calls = _count_eager_steps(monkeypatch)
    with pytest.raises(RuntimeError, match="no such builtin"):
        torch_models.PipeFlow(backend="native", device="cpu", **PIPE)
    assert calls == []
    assert not fresh_native.LIB_PATH.exists()
    assert not list(fresh_native.LIB_PATH.parent.glob("*.tmp"))


def test_build_lands_in_the_packages_build_directory(fresh_native,
                                                     monkeypatch):
    """A first use builds the library under ``_build`` from the port's own
    source, and a source newer than the library rebuilds it."""
    fresh_native.build()
    lib = fresh_native.LIB_PATH
    assert lib.exists() and lib.parent.name == "_build"
    assert fresh_native._SRC.parent.name == "native"
    assert fresh_native._SRC.parent.parent.name == "lb2d_tpu_torch"
    built = []
    compile_ = fresh_native._compile
    monkeypatch.setattr(fresh_native, "_compile",
                        lambda: built.append(1) or compile_())
    fresh_native.build(force=False)
    assert built == []  # loaded, not rebuilt
    monkeypatch.setattr(fresh_native, "_lib", None)
    old = fresh_native._SRC.stat().st_mtime - 100
    import os
    os.utime(lib, (old, old))
    fresh_native.build()
    assert built == [1]
