"""The flow moments' dispatch (``lb2d_tpu_torch.ops.moments.hydro_planes``)
and the kernel's wrapper (``flow_moments``), on the CPU.

The kernel (``csrc/moments.cu``) runs only on the card, where
``tests/test_torch_kernel_cuda.py`` holds it to the plain version. Here:
the plain path of ``hydro_planes`` equals ``hydro_compressible`` and
``hydro_incompressible`` bit for bit for every subset of planes; the flow
models' ``device_field`` equals the matching plane of their moments; the
wrapper's argument checks; and the dispatch by device and dtype, driven on
the ``meta`` device (float32 off the CPU, as a CUDA state) with the C call
replaced by a recorder: exactly the planes named reach the kernel, and
the plain path's lattice columns (``lattice_columns``) are never read.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

import lb2d_tpu_torch.models as models
from lb2d_tpu_torch.core import D2Q25
from lb2d_tpu_torch.ops import moments
from lb2d_tpu_torch.ops.moments import (FIELDS, flow_moments,
                                        hydro_compressible,
                                        hydro_incompressible, hydro_planes)

SUBSETS = [s for r in (1, 2, 3) for s in itertools.permutations(FIELDS, r)]
FORMS = {"compressible": (False, hydro_compressible),
         "incompressible": (True, hydro_incompressible)}


def _state(ny=6, nx=10, dtype=torch.float32):
    rng = np.random.RandomState(3)
    return torch.tensor((1.0 + 0.05 * rng.randn(9, ny, nx)) / 9.0,
                        dtype=dtype)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("fields", SUBSETS,
                         ids=["-".join(s) for s in SUBSETS])
def test_plain_path_equals_the_hydro_functions(form, fields):
    incompressible, hydro = FORMS[form]
    f = _state()
    want = dict(zip(FIELDS, hydro(f)))
    launches = flow_moments.launches
    planes = hydro_planes(f, fields, incompressible)
    assert flow_moments.launches == launches  # the CPU path launches nothing
    assert len(planes) == len(fields)
    for name, plane in zip(fields, planes):
        assert torch.equal(plane, want[name]), name


def _flow_model(name):
    kw = dict(device="cpu", seed=1)
    pipe = dict(N=7, pipe_length=2.0, diameter=1.0, rho=1.0, viscosity=1.0,
                pressure_grad=-10.0)
    if name == "PipeFlow":
        return models.PipeFlow(**pipe, **kw)
    if name == "PipeFlow-incompressible":
        return models.PipeFlow(**pipe, equilibrium="incompressible", **kw)
    if name == "PipeFlowCylinder":
        return models.PipeFlowCylinder(
            N=7, diameter=1.0, rho=1.0, viscosity=1.0, pressure_grad=-10.0,
            pipe_length=3.0, cylinder_center=(0.75, 0.5),
            cylinder_radius=0.2, **kw)
    if name == "LatticePipeFlow-incompressible":
        return models.LatticePipeFlow(omega=1.1, lx=15, ly=7, deltaP=-0.01,
                                      equilibrium="incompressible", **kw)
    return models.PipeFlowVelocityInlet(u_w=0.05, omega=1.2, lx=15, ly=7,
                                        **kw)


MODELS = ["PipeFlow", "PipeFlow-incompressible", "PipeFlowCylinder",
          "LatticePipeFlow-incompressible", "PipeFlowVelocityInlet"]


@pytest.mark.parametrize("model", MODELS)
def test_device_field_is_the_plane_of_the_models_moments(model):
    sim = _flow_model(model)
    sim.run(3)
    want = dict(zip(FIELDS, sim._hydro_fn()(sim.state)))
    for name in FIELDS:
        got = sim.device_field(name)
        assert got.shape == (sim.ny, sim.nx)
        assert torch.equal(got, want[name]), name
    for other in ("f", "feq", "rho0", "U"):
        assert sim.device_field(other) is None


def test_wrapper_checks_its_arguments():
    f = torch.empty((9, 4, 8), device="meta")   # off the CPU, as on the card
    with pytest.raises(ValueError, match="on the card"):
        flow_moments(_state(4, 8))
    with pytest.raises(ValueError, match="float32"):
        flow_moments(f.double())
    with pytest.raises(ValueError, match=r"\[9, ny, nx\]"):
        flow_moments(f[:8])
    with pytest.raises(ValueError, match=r"\[9, ny, nx\]"):
        flow_moments(f[0])
    with pytest.raises(ValueError, match="contiguous"):
        flow_moments(f.transpose(1, 2))
    for fields in ((), ("u", "u"), ("rho", "w"), ("f",)):
        with pytest.raises(ValueError, match="fields"):
            flow_moments(f, fields)


class _Recorder:
    """Stands in for the C call: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, entry, *args):
        self.calls.append((entry,) + args)


@pytest.fixture
def recorder(monkeypatch):
    """The kernel path on the meta device: the C call recorded, no CUDA
    device context, and the plain path's lattice columns refused."""
    rec = _Recorder()

    def refuse(*args):
        raise AssertionError("lattice_columns on the kernel path")

    monkeypatch.setattr(moments, "_launch", rec)
    monkeypatch.setattr(moments, "lattice_columns", refuse)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return rec


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("fields", SUBSETS,
                         ids=["-".join(s) for s in SUBSETS])
def test_kernel_path_asks_for_exactly_the_planes_named(recorder, form,
                                                       fields):
    incompressible, _ = FORMS[form]
    f = torch.empty((9, 5, 12), device="meta")
    launches = flow_moments.launches
    planes = hydro_planes(f, fields, incompressible)
    assert flow_moments.launches == launches + 1
    assert len(planes) == len(fields)
    assert all(p.shape == (5, 12) and p.device.type == "meta"
               for p in planes)
    [(entry, f_arg, rho, u, v, cells, incomp)] = recorder.calls
    assert entry == "lb2d_moments" and f_arg is f
    assert cells == 60 and incomp == int(incompressible)
    asked = {"rho": rho, "u": u, "v": v}
    assert {n for n, p in asked.items() if p is not None} == set(fields)
    for name, plane in zip(fields, planes):
        assert asked[name] is plane   # each plane named goes to its pointer


def test_hydro_functions_and_device_field_take_the_kernel_path(recorder):
    f = torch.empty((9, 4, 8), device="meta")
    for hydro, incomp in ((hydro_compressible, 0),
                          (hydro_incompressible, 1)):
        rho, u, v = hydro(f)
        assert recorder.calls[-1][2:5] == (rho, u, v)
        assert recorder.calls[-1][6] == incomp
    sim = _flow_model("PipeFlow-incompressible")
    sim.state = torch.empty((9, sim.ny, sim.nx), device="meta")
    before = len(recorder.calls)
    u = sim.device_field("u")
    [(_, _, rho, got_u, v, cells, incomp)] = recorder.calls[before:]
    assert (rho, v) == (None, None) and got_u is u
    assert (cells, incomp) == (sim.ny * sim.nx, 1)
    assert sim.device_field("feq") is None
    assert len(recorder.calls) == before + 1


def test_other_states_run_the_plain_functions(recorder):
    """A CPU state, or another dtype off the CPU, never reaches the C call;
    a non-D2Q9 lattice on the kernel path raises."""
    f = _state()
    launches = flow_moments.launches
    with pytest.raises(AssertionError, match="lattice_columns"):
        hydro_planes(f)          # the plain path: it reads the columns
    with pytest.raises(AssertionError, match="lattice_columns"):
        hydro_planes(torch.empty((9, 4, 8), dtype=torch.float64,
                                 device="meta"))
    with pytest.raises(ValueError, match="D2Q9"):
        hydro_planes(torch.empty((25, 4, 8), device="meta"),
                     lattice=D2Q25)
    assert recorder.calls == [] and flow_moments.launches == launches
