"""The port's model surface that JAX callers rely on, on the CPU.

``backend="xla"``, JAX's name of the plain path, runs the port's
``"eager"`` path in every family (``lb2d_tpu/models/pipe_flow.py:112-147``,
``lattice_units.py:153-154``, ``multicomponent.py:239``);
``LBModel.block_until_ready`` and the default ``device_field``
(``lb2d_tpu/models/base.py:101-110``); ``PipeFlow(init_state=False)``
(``pipe_flow.py:83,151-154``), the configuration-only model that
``ShardedPipeFlow`` builds on. Every name that ``lb2d_tpu``,
``lb2d_tpu.core``, ``lb2d_tpu.models`` and ``lb2d_tpu.utils`` export
resolves in the port.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import lb2d_tpu.models as jax_models
import lb2d_tpu.utils as jax_utils
import lb2d_tpu_torch.models as torch_models
from lb2d_tpu_torch.models.base import LBModel

torch.set_num_threads(1)

PIPE = dict(N=15, diameter=1.5, rho=10.0, viscosity=5.0,
            pressure_grad=-100.0, pipe_length=1.5 * 30.5 / 15)
DIFFUSION = dict(N=20, z=0.1, D=0.005, Lx=0.101, Ly=0.101, g=1.0)
FISHER = dict(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0, 1.0],
              D_standard=1.0, D_list=[1.0, 1.0], N=10,
              initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
MODELS = {
    "PipeFlow": lambda **kw: torch_models.PipeFlow(**PIPE, **kw),
    "PipeFlowVelocityInlet": lambda **kw: torch_models.PipeFlowVelocityInlet(
        u_w=0.05, omega=1.2, lx=20, ly=12, **kw),
    "ReactionDiffusion": lambda **kw: torch_models.ReactionDiffusion(
        **DIFFUSION, **kw),
    "FisherExpansion": lambda **kw: torch_models.FisherExpansion(**FISHER,
                                                                 **kw),
    "RocketYeast": lambda **kw: torch_models.RocketYeast(
        Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=16, G_chen=-0.1,
        **kw),
}


NOT_YET_PORTED = set()


@pytest.mark.parametrize("module", ["", ".core", ".models", ".utils"],
                         ids=["package", "core", "models", "utils"])
def test_every_jax_export_resolves_in_the_port(module):
    jax_mod = importlib.import_module("lb2d_tpu" + module)
    port = importlib.import_module("lb2d_tpu_torch" + module)
    missing = [name for name in jax_mod.__all__
               if name not in NOT_YET_PORTED and not hasattr(port, name)]
    assert missing == []
    assert set(jax_mod.__all__) - NOT_YET_PORTED <= set(port.__all__)
    if not module:
        assert port.__version__ == jax_mod.__version__


@pytest.mark.parametrize(
    "module,name", [(".models", n) for n in jax_models.__all__]
    + [(".utils", n) for n in jax_utils.__all__])
def test_every_argument_and_public_method_is_ported(module, name):
    """Each exported class or function of the JAX package: every argument
    of the constructor (or function) and every public attribute of the
    class exist in the port's counterpart."""
    jax_obj = getattr(importlib.import_module("lb2d_tpu" + module), name)
    port_obj = getattr(importlib.import_module("lb2d_tpu_torch" + module),
                       name)
    fn = jax_obj.__init__ if inspect.isclass(jax_obj) else jax_obj
    port_fn = port_obj.__init__ if inspect.isclass(port_obj) else port_obj
    params = set(inspect.signature(fn).parameters)
    assert params <= set(inspect.signature(port_fn).parameters)
    if inspect.isclass(jax_obj):
        public = {m for m in dir(jax_obj) if not m.startswith("_")}
        assert public <= set(dir(port_obj))


@pytest.mark.parametrize("name", list(MODELS))
def test_xla_backend_is_the_eager_path(name):
    xla = MODELS[name](device="cpu", backend="xla")
    eager = MODELS[name](device="cpu", backend="eager")
    assert xla.backend == eager.backend == "eager"
    xla.run(3)
    eager.run(3)
    assert torch.equal(xla.state, eager.state)


def _runner(backend):
    sim = torch_models.SimulationRunner(nx=16, ny=12, L_lb=16,
                                        num_populations=2, device="cpu",
                                        backend=backend)
    for i in range(2):
        sim.add_fluid(torch_models.Fluid(sim, i, nu_e=1.0 / 6.0))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(0).rand(12, 16)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="linear")
    return sim


def test_xla_backend_of_the_runner():
    xla, eager = _runner("xla"), _runner("eager")
    assert xla.backend == eager.backend == "eager"
    xla.run(3)
    eager.run(3)
    assert torch.equal(xla.f, eager.f)


def test_block_until_ready_returns_the_model(monkeypatch):
    sim = MODELS["PipeFlow"](device="cpu")
    assert sim.block_until_ready() is sim
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    sim.device = torch.device("cuda", 0)  # what the model waits for
    assert sim.block_until_ready() is sim
    assert synced == [torch.device("cuda", 0)]


def test_device_field_defaults_to_none():
    class Bare(LBModel):
        device = torch.device("cpu")
        state = torch.zeros(9, 2, 2)

        def make_step(self):
            return lambda f: f

    assert Bare().device_field("rho") is None
    sim = MODELS["PipeFlow"](device="cpu")
    assert sim.device_field("rho").shape == (sim.ny, sim.nx)
    assert sim.device_field("nothing") is None


def test_pipe_flow_without_state():
    sim = torch_models.PipeFlow(device="cpu", init_state=False, **PIPE)
    assert not hasattr(sim, "state")
    assert (sim.ny, sim.nx, sim.backend) == (16, 32, "eager")
    full = torch_models.PipeFlow(device="cpu", **PIPE)
    perturb = full._init_perturb(np.random.RandomState(full.seed))
    # a block built from the perturbation alone is that block of the state
    block = sim._init_from_perturb(perturb[:, 4:9, 10:20], "cpu", x0=10)
    assert torch.equal(block, full.state[:, 4:9, 10:20])
