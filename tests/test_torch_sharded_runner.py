"""``SimulationRunner.shard_over`` (the port's sharded multicomponent engine)
against the JAX package and against the port's unsharded runner, on the
CPU.

The counterparts of ``tests/test_multicomponent.py:229-289, 608`` and
``tests/test_sharding.py``: the runner cut into meshes of CPU shards
(``make_mesh(devices=["cpu"] * 4)``, 4x1 and 2x2), where the sharded step
runs K6h's plain twins (``device="cpu"``: the ``eager`` backend). Each
sharded run is held to JAX's unsharded XLA step from the same state at
JAX's own bar (atol 5e-7, rtol 1e-5; 1e-12 in float64) and to the port's
unsharded eager run at 1e-7, where it is expected to agree exactly (the
twins evaluate the same expressions on the same values). Cases: BASELINE
config 5 (porous, Shan-Chen, the screened-Poisson force) at 96x64, a
D2Q25 runner (configuration (d) of ``lb2d_tpu_torch.mc_cases``), the
second belt with the static radial force (b), three fluids (g), and
zero-gradient edges with a clamped interaction (e) on 2x2, where shards on
the grid's edges clamp by global coordinates. A JAX state loads into the
shards, and two-process gloo runs (this file re-run as the child), by
rows and by columns, equal the one-process run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import lb2d_tpu_torch.models.multicomponent as torch_mc
from lb2d_tpu_torch.mc_cases import mc_case
from lb2d_tpu_torch.ops.fused_halo import Halo
from lb2d_tpu_torch.ops.fused_mc import mc_density_halo
from lb2d_tpu_torch.parallel import (
    Mesh,
    global_mesh,
    init_distributed,
    make_mesh,
)
from lb2d_tpu_torch.parallel.sharded import ShardedRunner

torch.set_num_threads(1)

ATOL, RTOL = 5e-7, 1e-5   # tests/test_multicomponent.py's kernel bar
EXACT = 1e-7              # against the port's unsharded run (expected 0)
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}


def _mesh(shape):
    return make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


def config5(mod, ny=96, nx=64, **kw):
    """BASELINE config 5 (``benchmarks/c5_one.py``: porous, two fluids,
    Shan-Chen, the screened-Poisson repulsion of fluid 0 on fluid 1) at
    ``ny x nx``, with an interaction length and amplitude that make the
    force matter at this size."""
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
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=4.0,
                                   amplitude=0.05)
    return sim


def _build(case, package, **kw):
    """The runner of ``case`` from ``package`` (``"jax"``: its XLA step;
    ``"torch"``: on the CPU)."""
    if package == "jax":
        import lb2d_tpu.models.multicomponent as jax_mc
        from lb2d_tpu.core.lattice import D2Q25 as JAX_D2Q25

        if case == "config5":
            return config5(jax_mc, backend="xla", **kw)
        return mc_case(case, 64, 48, runner=jax_mc.SimulationRunner,
                       fluid=jax_mc.Fluid, d2q25=JAX_D2Q25, backend="xla",
                       **kw)
    if case == "config5":
        return config5(torch_mc, device="cpu", **kw)
    return mc_case(case, 64, 48, device="cpu", **kw)


_JAX_RUNS = {}


def _jax_state(case, steps):
    """JAX's unsharded XLA run of ``case``, ``steps`` steps (cached)."""
    if (case, steps) not in _JAX_RUNS:
        sim = _build(case, "jax")
        sim.run(steps)
        _JAX_RUNS[case, steps] = np.asarray(sim.f)
    return _JAX_RUNS[case, steps]


RUNS = [("config5", "4x1"), ("config5", "2x2"), ("d", "4x1"), ("d", "2x2"),
        ("b", "2x2"), ("g", "4x1"), ("e", "2x2"), ("e", "4x1")]


@pytest.mark.parametrize("case,mesh", RUNS,
                         ids=[f"{c}-{m}" for c, m in RUNS])
def test_shard_over_matches_jax_and_unsharded(case, mesh):
    single = _build(case, "torch")
    sim = _build(case, "torch")
    assert sim.shard_over(_mesh(MESHES[mesh])) is sim
    assert sim.f is None and isinstance(sim._sharded, ShardedRunner)
    assert np.array_equal(sim.state_numpy(), single.state_numpy())
    single.run(5)
    sim.run(3)
    sim.run(2)
    assert sim.steps_taken == 5 and sim.backend_used == "eager"
    got = sim.state_numpy()
    np.testing.assert_allclose(got, _jax_state(case, 5), atol=ATOL,
                               rtol=RTOL)
    assert float(np.abs(got - single.state_numpy()).max()) <= EXACT


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_over_stale_force_equals_unsharded(mesh):
    """``stale_force=2``: ``run(5)`` is two sweeps that each solve once on
    the gathered density, then one exact step, as the unsharded runner."""
    single = config5(torch_mc, device="cpu", stale_force=2)
    sim = config5(torch_mc, device="cpu", stale_force=2).shard_over(
        _mesh(MESHES[mesh]))
    single.run(5)
    sim.run(5)
    assert sim.steps_per_call == 2
    assert float(np.abs(sim.state_numpy()
                        - single.state_numpy()).max()) <= EXACT
    capped = config5(torch_mc, device="cpu", stale_force=4).shard_over(
        _mesh(MESHES[mesh]))
    capped.run(4, k_steps=2)
    assert capped.steps_per_call == 2


def test_shard_over_float64_matches_jax_x64():
    import jax

    with jax.enable_x64(True):
        ref = _build("a", "jax")
        ref.run(5)
        want = np.asarray(ref.f)
    sim = _build("a", "torch", dtype=torch.float64)
    sim.shard_over(_mesh((2, 2)))
    sim.run(5)
    got = sim.state_numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_sharded_getters_equal_unsharded():
    """``get_fields``, ``rho``, ``u_bary``, ``v_bary``, ``check_fields``
    and ``last_mlups`` read the shards; ``debug`` runs single steps."""
    single = _build("config5", "torch")
    sim = _build("config5", "torch").shard_over(_mesh((2, 2)))
    single.run(4)
    sim.run(3, timed=True)
    assert sim.last_mlups > 0
    sim.run(1, debug=True)
    a, b = single.get_fields(), sim.get_fields()
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    for name in ("rho", "u_bary", "v_bary"):
        assert torch.equal(getattr(single, name), getattr(sim, name)), name
    # float32 partial sums per row, then float64: a shard's shorter rows
    # round apart from the whole grid's, both close to the float64 sum
    f64 = single.state_numpy().astype(np.float64)
    sums_a, sums_b = single.check_fields(), sim.check_fields()
    for i in range(2):
        exact = f64[:, i].sum()
        for name in (f"sum_rho_{i}", f"sum_f_{i}"):
            assert sums_a[name] == pytest.approx(exact, rel=1e-7), name
            assert sums_b[name] == pytest.approx(exact, rel=1e-7), name
    assert sim.f is None


def test_jax_state_loads_into_the_shards():
    """load_numpy_state splits a JAX runner's global state into the
    shards; both then run on together."""
    ref = _build("config5", "jax")
    ref.run(2)
    sim = _build("config5", "torch").shard_over(_mesh((2, 2)))
    sim.load_numpy_state(np.asarray(ref.f))
    assert np.array_equal(sim.state_numpy(), np.asarray(ref.f))
    ref.run(3)
    sim.run(3)
    np.testing.assert_allclose(sim.state_numpy(), np.asarray(ref.f),
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="state must be"):
        sim.load_numpy_state(np.zeros((9, 2, 8, 8)))


def test_shard_over_again_recuts_the_shards():
    """A second ``shard_over`` gathers the shards and cuts them anew."""
    single = _build("config5", "torch")
    sim = _build("config5", "torch").shard_over(_mesh((4, 1)))
    single.run(2)
    sim.run(2)
    sim.shard_over(_mesh((2, 2)))
    assert sim._sharded.mesh.shape == {"y": 2, "x": 2}
    single.run(2)
    sim.run(2)
    assert np.array_equal(sim.state_numpy(), single.state_numpy())


def test_shard_over_checks_the_mesh():
    sim = _build("a", "torch")
    with pytest.raises(ValueError, match="must divide"):
        sim.shard_over(_mesh((5, 1)))
    q25 = _build("d", "torch")
    with pytest.raises(ValueError, match="reach"):
        q25.shard_over(make_mesh(devices=["cpu"] * 32, shape=(32, 1)))
    kernel = torch_mc.SimulationRunner(nx=16, ny=16, device="cpu")
    kernel.backend = "kernel"  # as built on a card
    with pytest.raises(ValueError, match="CUDA devices"):
        kernel.shard_over(_mesh((2, 2)))


def test_shard_over_keeps_the_model_on_its_device_type():
    """A runner built on the CPU (whose ``auto`` is the plain step) does not
    shard over a CUDA mesh: the plain step would run on the card without
    being named. It keeps its state and runs on."""
    sim = _build("config5", "torch")
    cuda_mesh = Mesh([(0, "cuda:0")] * 4, (4, 1))
    with pytest.raises(ValueError, match="built on cpu.*device='cuda'"):
        sim.shard_over(cuda_mesh)
    assert sim.f is not None and sim._sharded is None
    sim.run(1)


def test_shard_over_checks_the_belt_and_zero_gradient_edges():
    """Shards one row high: the second belt reads two rows past the shard,
    and a zero-gradient edge cell pulls at the cell inside it, whose
    stream reads one row past a one-row halo; both raise, as does K6h's
    density pass on such a shard."""
    rows = make_mesh(devices=["cpu"] * 64, shape=(64, 1))
    second_belt = _build("b", "torch").shard_over(rows)
    with pytest.raises(ValueError, match="interactions' belt of 2"):
        second_belt.run(1)
    with pytest.raises(ValueError, match="zero-gradient edge's reach of 2"):
        _build("e", "torch").shard_over(rows)
    sim = _build("e", "torch")
    cfg = sim.config()
    f = sim.f.reshape(-1, sim.ny, sim.nx)
    rho = torch.empty((2, sim.ny, sim.nx), dtype=f.dtype)
    with pytest.raises(ValueError, match="at least 2 cells across, not 1x"):
        mc_density_halo(Halo.cut(f, 0, 0, 1, sim.nx, 1), rho, cfg,
                        sim.lattice)
    mc_density_halo(Halo.cut(f, 0, 0, 2, sim.nx, 1), rho, cfg, sim.lattice)


def _two_process_run(mesh, case="config5"):
    sim = _build(case, "torch").shard_over(mesh)
    sim.run(4)
    return sim.state_numpy()


def _column_mesh():
    """A 2x2 mesh whose shard columns lie on two processes: the x strips
    and the density belt's columns cross them, the rows do not."""
    return Mesh([(ix, "cpu") for iy in range(2) for ix in range(2)], (2, 2))


def _two_processes(tmp_path, layout, case):
    """Run this file as two gloo processes on a localhost port; their
    local positions and global states."""
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + sys.path))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         str(tmp_path), layout, case], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for rank in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (out[-1000:], err[-3000:])
    return ([json.loads((tmp_path / f"rank{r}.json").read_text())["local"]
             for r in range(2)],
            [np.load(tmp_path / f"rank{r}.npy") for r in range(2)])


def test_two_process_gloo_shard_over_equals_one_process(tmp_path):
    """Two CPU processes (this file as the child) join through a localhost
    port on gloo, each holding 2 shards of a 4x1 ``global_mesh()``; config
    5, whose screened solve reads the density gathered across the
    processes, equals the one-process run bit for bit."""
    local, states = _two_processes(tmp_path, "rows", "config5")
    assert local == [[[0, 0], [1, 0]], [[2, 0], [3, 0]]]
    want = _two_process_run(_mesh((4, 1)))
    for state in states:
        assert np.array_equal(state, want)


@pytest.mark.parametrize("case", ["config5", "b"])
def test_two_process_gloo_shard_over_by_columns_equals_one_process(
        tmp_path, case):
    """The same with each process holding one column of a 2x2 mesh: the
    density belt (1 for config 5, 2 for the second belt of (b)) and its
    corners come across the processes through the x strips."""
    local, states = _two_processes(tmp_path, "columns", case)
    assert local == [[[0, 0], [1, 0]], [[0, 1], [1, 1]]]
    want = _two_process_run(_mesh((2, 2)), case)
    for state in states:
        assert np.array_equal(state, want)


def _child(rank, port, out_dir, layout, case):
    import torch.distributed as dist

    init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                     device="cpu")
    mesh = (global_mesh(shape=(4, 1), devices=["cpu", "cpu"])
            if layout == "rows" else _column_mesh())
    np.save(os.path.join(out_dir, f"rank{rank}.npy"),
            _two_process_run(mesh, case))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"local": mesh.local_positions()}, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
