"""The port's domain decomposition (``lb2d_tpu_torch.parallel``) against the
JAX package and against the port's unsharded models, on the CPU.

The counterparts of ``tests/test_sharding.py``: meshes of shards on
``device="cpu"`` (``make_mesh(devices=["cpu"] * n)``, the port's
counterpart of JAX's virtual CPU devices), where the K9 wrapper runs its
plain twin. The sharded pipe flow is held to JAX's ``PipeFlow(backend=
"xla")`` at JAX's own bar (rtol 1e-6, atol 1e-7); the diffusion and
multifield models to JAX's XLA steps (atol 1e-6, rtol 1e-5, as
``test_sharding.py``) and to the unsharded port bit for bit, noise
included, since K9 keys its noise and its walls by global coordinates;
K9's plain twin to JAX's K9 in interpret mode. A two-process run on gloo
(this file re-run as the child) equals the single-process run bit for
bit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import lb2d_tpu_torch.models as torch_models
from lb2d_tpu_torch.ops.fused_halo import (
    Halo,
    supports_temporal_halo,
    temporal_halo_step,
    temporal_halo_step_reference,
)
from lb2d_tpu_torch.parallel import (
    ShardedCoupled,
    ShardedDiffusion,
    ShardedMultifield,
    ShardedPipeFlow,
    extend_with_halo,
    global_mesh,
    init_distributed,
    is_initialized,
    make_mesh,
)
from lb2d_tpu_torch.parallel import distributed

torch.set_num_threads(1)

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0)
PIPE_16x32 = dict(N=15, pipe_length=1.5 * 30.5 / 15, **PARAMS)
DIFFUSION_128 = dict(N=126, z=0.1, D=0.005, vx=1.0, vy=0.5, vc=1.0,
                     Lx=0.101, Ly=0.101, g=1.0)
FISHER_128 = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
                  D_standard=1.0, D_list=[1.0, 1.0], N=126,
                  initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
EXPANSION_64 = dict(Lx=2.05, Ly=2.05, mu_standard=1.0, mu_list=[1.0, 0.8],
                    D_standard=1.0, D_list=[1.0, 1.0], N=62)
RTOL, ATOL = 1e-6, 1e-7  # tests/test_sharding.py's bar for the flow


def _mesh(shape):
    return make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


def _obstacle():
    mask = np.zeros((16, 32), np.int32)
    mask[6:10, 12:16] = 1
    return mask


@pytest.fixture(scope="module")
def jax_pipe():
    """JAX's PipeFlow(backend="xla") states at 16x32 after n steps."""
    from lb2d_tpu.models.pipe_flow import PipeFlow

    def run(n, **kw):
        sim = PipeFlow(backend="xla", **PIPE_16x32, **kw)
        sim.run(n)
        return np.asarray(sim.state)
    return run


def test_mesh_factoring():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape["y"] * mesh.shape["x"] == 8 and mesh.size == 8
    mesh = make_mesh(8, shape=(2, 4), devices=["cpu"] * 8)
    assert mesh.shape == {"y": 2, "x": 4}
    assert mesh.local_positions() == mesh.positions()


def test_make_mesh_raises_on_too_few_devices(monkeypatch):
    with pytest.raises(ValueError, match="only"):
        make_mesh(1024, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="only 0"):
        make_mesh()  # the CUDA default, on a machine without a card


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (4, 2)],
                         ids=["2x4", "8x1", "4x2"])
@pytest.mark.parametrize("backend", ["temporal", "eager"])
def test_sharded_matches_jax(jax_pipe, shape, backend):
    """20 steps (sweeps and a remainder sweep) against JAX's unsharded XLA
    step; the initial state is the unsharded model's, bit for bit."""
    sh = ShardedPipeFlow(mesh=_mesh(shape), backend=backend, **PIPE_16x32)
    assert sh.backend == backend
    single = torch_models.PipeFlow(device="cpu", **PIPE_16x32)
    assert np.array_equal(sh.state_numpy(), single.state_numpy())
    sh.run(20)
    assert sh.steps_taken == 20
    np.testing.assert_allclose(sh.state_numpy(), jax_pipe(20), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["temporal", "xla"])
def test_sharded_with_obstacle(jax_pipe, backend):
    sh = ShardedPipeFlow(mesh=_mesh((2, 4)), backend=backend,
                         obstacle_mask=_obstacle(), **PIPE_16x32)
    assert sh.backend == ("eager" if backend == "xla" else backend)
    sh.run(10)
    np.testing.assert_allclose(sh.state_numpy(),
                               jax_pipe(10, obstacle_mask=_obstacle()),
                               rtol=RTOL, atol=ATOL)


def test_remainder_and_split_runs(jax_pipe):
    """run(11) is two sweeps of 4 and one of 3; run(4); run(7) is the
    same steps in another cut (one sweep of 4, one of 3)."""
    a = ShardedPipeFlow(mesh=_mesh((4, 2)), backend="temporal", **PIPE_16x32)
    b = ShardedPipeFlow(mesh=_mesh((4, 2)), backend="temporal", **PIPE_16x32)
    assert a.steps_per_call == 4  # HALO_TEMPORAL_K["flow"]
    a.run(11)
    b.run(4)
    b.run(7)
    np.testing.assert_allclose(a.state_numpy(), jax_pipe(11), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b.state_numpy(), a.state_numpy(), rtol=RTOL,
                               atol=ATOL)


def test_get_fields_sharded():
    from lb2d_tpu.models.pipe_flow import PipeFlow

    single = PipeFlow(backend="xla", **PIPE_16x32)
    sh = ShardedPipeFlow(mesh=_mesh((2, 4)), backend="temporal",
                         **PIPE_16x32)
    single.run(8)
    sh.run(8)
    a, b = single.get_fields(), sh.get_fields()
    for k in ("rho", "u", "v"):
        assert b[k].shape == a[k].shape
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6)
    assert not hasattr(sh.base, "state") or sh.base.state is None


def test_kernel_path_takes_every_shard():
    """JAX falls back to its XLA step for tiny shards, unaligned widths and
    obstacles (test_sharding.py:172-177, 503-508); K9 takes them all, with
    K capped by the shard's edge."""
    tiny = ShardedPipeFlow(mesh=_mesh((8, 1)), backend="temporal",
                           k_steps=8, **PIPE_16x32)  # 2-row shards
    assert (tiny.backend, tiny.steps_per_call) == ("temporal", 2)
    narrow = ShardedPipeFlow(mesh=_mesh((2, 4)), backend="temporal",
                             obstacle_mask=_obstacle(), **PIPE_16x32)
    assert (narrow.backend, narrow.steps_per_call) == ("temporal", 4)
    assert supports_temporal_halo(2, 8, 2) and not supports_temporal_halo(
        2, 8, 3)
    assert supports_temporal_halo(64, 2, 8, x_sharded=False)
    auto = ShardedPipeFlow(mesh=_mesh((2, 4)), **PIPE_16x32)
    assert auto.backend == "eager"  # "auto" on the CPU


def test_one_shard_mesh():
    """1x1: ``auto`` is the unsharded model's own path; ``temporal`` runs K9
    on the one shard, whose halo is its own wrap."""
    kw = dict(N=63, pipe_length=1.5 * 127 / 63, **PARAMS)  # 64 x 128
    single = torch_models.PipeFlow(device="cpu", **kw)
    auto = ShardedPipeFlow(mesh=_mesh((1, 1)), **kw)
    k9 = ShardedPipeFlow(mesh=_mesh((1, 1)), backend="temporal", **kw)
    assert (auto.backend, auto.steps_per_call) == ("eager", 1)
    assert (k9.backend, k9.steps_per_call) == ("temporal", 4)
    for sim in (single, auto, k9):
        sim.run(7)
    assert torch.equal(auto.state[0], single.state)
    np.testing.assert_allclose(k9.state_numpy(), single.state_numpy(),
                               rtol=RTOL, atol=ATOL)


def test_extend_with_halo_matches_the_wrapped_grid():
    """1-cell halos on a 2x4 mesh (corners in two hops) are the cells of
    the periodically wrapped grid."""
    f = torch.arange(3 * 8 * 12, dtype=torch.float32).reshape(3, 8, 12)
    mesh = _mesh((2, 4))
    shards = {(iy, ix): f[:, 4 * iy:4 * iy + 4, 3 * ix:3 * ix + 3].clone()
              for iy, ix in mesh.positions()}
    ext = extend_with_halo(mesh, shards, width=1)
    for (iy, ix), e in ext.items():
        ys = torch.arange(4 * iy - 1, 4 * iy + 5) % 8
        xs = torch.arange(3 * ix - 1, 3 * ix + 4) % 12
        assert torch.equal(e, f[:, ys][:, :, xs])


@pytest.mark.parametrize("shape", [(4, 1), (2, 4)], ids=["4x1", "2x4"])
def test_sharded_diffusion_matches_jax_and_unsharded(shape):
    from lb2d_tpu.models.diffusion import ReactionAdvectionDiffusion

    ref = ReactionAdvectionDiffusion(**DIFFUSION_128)
    step = ref._make_xla_step()
    fref = ref.state
    for _ in range(11):
        fref = step(fref)
    single = torch_models.ReactionAdvectionDiffusion(device="cpu",
                                                     **DIFFUSION_128)
    sh = ShardedDiffusion(torch_models.ReactionAdvectionDiffusion(
        device="cpu", **DIFFUSION_128), mesh=_mesh(shape))
    assert sh.steps_per_call == 8  # HALO_TEMPORAL_K["diffusion"]
    single.run(11)
    sh.run(11)  # one sweep of 8 and one of 3
    np.testing.assert_allclose(sh.state_numpy(), np.asarray(fref),
                               atol=1e-6, rtol=1e-5)
    assert np.array_equal(sh.state_numpy(), single.state_numpy())


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_sharded_stochastic_diffusion_equals_unsharded(shape):
    """The noise of a cell does not depend on the mesh: the sharded
    stochastic Fisher wave equals the unsharded one bit for bit."""
    kw = dict(DIFFUSION_128, Dg=0.2, rng_seed=11)
    single = torch_models.ReactionAdvectionDiffusionStochastic(device="cpu",
                                                               **kw)
    sh = ShardedDiffusion(torch_models.ReactionAdvectionDiffusionStochastic(
        device="cpu", **kw), mesh=_mesh(shape))
    assert sh.noisy and sh.steps_per_call == 4  # HALO_TEMPORAL_K
    single.run(7)
    sh.run(3)  # one sweep of 3
    sh.run(4)  # one of 4
    assert sh.steps_taken == 7
    assert np.array_equal(sh.state_numpy(), single.state_numpy())
    rho = sh.get_fields()["rho"]
    assert np.isfinite(rho).all() and rho.min() >= 0.0


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_sharded_multifield_fisher_matches_jax_and_unsharded(shape):
    """No-flux walls by global coordinates: no wall band patch."""
    from lb2d_tpu.models.multifield import FisherExpansion

    ref = FisherExpansion(**FISHER_128)
    step = ref._make_xla_step()
    fref = ref.state
    for _ in range(7):
        fref = step(fref)
    single = torch_models.FisherExpansion(device="cpu", **FISHER_128)
    sh = ShardedMultifield(torch_models.FisherExpansion(device="cpu",
                                                        **FISHER_128),
                           mesh=_mesh(shape))
    assert sh.steps_per_call == 8  # FISHER_TEMPORAL_K
    single.run(7)
    sh.run(7)
    got = sh.state_numpy().reshape(np.shape(fref))
    np.testing.assert_allclose(got, np.asarray(fref), atol=1e-6, rtol=1e-5)
    assert np.array_equal(got, single.state_numpy())


def test_sharded_expansion_equals_unsharded():
    single = torch_models.Expansion(device="cpu", **EXPANSION_64)
    sh = ShardedMultifield(torch_models.Expansion(device="cpu",
                                                  **EXPANSION_64),
                           mesh=_mesh((2, 2)))
    assert sh.noisy and sh.steps_per_call == 4
    single.run(9)
    sh.run(9)
    assert np.array_equal(sh.state_numpy().reshape(single.state.shape),
                          single.state_numpy())
    assert sh.get_fields()["rho"].shape == (64, 64, 3)


@pytest.mark.parametrize("family", ["diffusion", "expansion"])
def test_wrapped_model_gives_up_its_state(family):
    """The shards take over the wrapped model's state (no device keeps the
    whole grid); the wrapped model follows steps_taken, and the getters
    read the shards."""
    cls, kw, sharded = {
        "diffusion": (torch_models.ReactionAdvectionDiffusionStochastic,
                      dict(DIFFUSION_128, N=30, Dg=0.2), ShardedDiffusion),
        "expansion": (torch_models.Expansion, EXPANSION_64,
                      ShardedMultifield)}[family]
    single = cls(device="cpu", **kw)
    sh = sharded(cls(device="cpu", **kw), mesh=_mesh((2, 2)))
    assert sh.base.state is None
    single.run(5)
    sh.run(5)
    assert sh.base.state is None
    assert sh.base.steps_taken == sh.steps_taken == single.steps_taken == 5
    a, b = single.get_fields(), sh.get_fields()
    assert a.keys() == b.keys()
    for name in a:
        assert np.array_equal(np.asarray(b[name]), np.asarray(a[name])), name
    assert sh.base.state is None


def test_state_crosses_from_jax():
    """load_numpy_state splits a JAX model's global state into the shards."""
    from lb2d_tpu.models.pipe_flow import PipeFlow

    jax_sim = PipeFlow(backend="xla", **PIPE_16x32)
    jax_sim.run(3)
    sh = ShardedPipeFlow(mesh=_mesh((2, 4)), backend="temporal",
                         **PIPE_16x32)
    sh.load_numpy_state(np.asarray(jax_sim.state))
    assert np.array_equal(sh.state_numpy(), np.asarray(jax_sim.state))
    jax_sim.run(6)
    sh.run(6)
    np.testing.assert_allclose(sh.state_numpy(), np.asarray(jax_sim.state),
                               rtol=RTOL, atol=ATOL)


def test_sharded_coupled_is_not_ported():
    """Once a stub that raised (ROADMAP queue 1 item 2): ShardedCoupled is
    ported. It takes the model's state (``state`` becomes None) and its
    run equals the unsharded model's bit for bit
    (``tests/test_torch_sharded_coupled.py`` holds it to JAX)."""
    kw = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, N=32, G_chen=-0.1)
    single = torch_models.RocketYeast(device="cpu", **kw)
    sh = ShardedCoupled(torch_models.RocketYeast(device="cpu", **kw),
                        mesh=_mesh((2, 2)))
    assert sh.base.state is None
    single.run(3)
    sh.run(3)
    assert np.array_equal(sh.state_numpy().reshape(single.state.shape),
                          single.state_numpy())


def _jax_halo_case(physics, rng):
    """A random state, its 32-row shard at rows [32, 64) and JAX's CH = 8
    row halo chunks (the port's halo is their K rows next to the shard).
    The flow and diffusion grids are 64x128, so the shard holds the top
    wall; the multifield grid 96x128 keeps the shard K rows off the walls,
    which JAX's multifield K9 leaves to its wall band patch
    (``lb2d_tpu/parallel/sharded.py:501-580``)."""
    F, ny = (2, 96) if physics == "multifield_fisher" else (1, 64)
    f = (rng.rand(9 * F, ny, 128) * 0.2 + 0.02).astype(np.float32)
    rows = np.arange(64, 72) % ny
    return ny, f[:, 32:64], f[:, 24:32], f[:, rows]


@pytest.mark.parametrize("physics", ["flow", "diffusion",
                                     "multifield_fisher"])
def test_halo_twin_matches_jax_halo_kernel(physics):
    """K9's plain twin (and its wrapper's CPU path) against JAX's K9 in
    interpret mode on one shard, K = 3."""
    import jax.numpy as jnp
    from lb2d_tpu.ops.fused_halo import make_temporal_halo_step

    K = 3
    ny, f_loc, top, bot = _jax_halo_case(physics, np.random.RandomState(9))
    kw = {"flow": dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0),
          "diffusion": dict(omega=1.7, u_lb=0.01, v_lb=-0.02, lb_G=0.01),
          "multifield_fisher": dict(omegas=[1.9, 1.8], lb_Gs=[1e-3, 2e-3],
                                    u_lb=0.001, v_lb=0.0, num_fields=2)}[
        physics]
    step = make_temporal_halo_step(ny=ny, nx=128, H=32, k_steps=K,
                                   physics=physics, interpret=True,
                                   **dict({"omega": 1.0}, **kw))
    assert step.chunk == 8
    want = np.asarray(step(jnp.asarray(f_loc), jnp.asarray(top),
                           jnp.asarray(bot), jnp.asarray([[32]], jnp.int32)))
    port_kw = {"flow": dict(kw, incompressible=False),
               "diffusion": kw,
               "multifield_fisher": dict(omegas=np.float32([1.9, 1.8]),
                                         lb_G=np.float32([1e-3, 2e-3]),
                                         u_lb=0.001, v_lb=0.0)}[physics]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    halo = Halo(t(f_loc), t(top[:, 8 - K:]), t(bot[:, :K]), None, None, 32, 0,
                ny, 128)
    launches = temporal_halo_step.launches
    got = temporal_halo_step_reference(halo, K, physics, **port_kw)
    # JAX's multifield kernel sums in another order than its XLA step: its
    # own bar (test_sharding.py:264); the flow bar for the others
    tol = (dict(atol=1e-6, rtol=1e-5) if physics == "multifield_fisher"
           else dict(rtol=RTOL, atol=ATOL))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    out = torch.empty_like(halo.f)
    assert torch.equal(temporal_halo_step(halo, out, K, physics, **port_kw),
                       got)
    assert temporal_halo_step.launches == launches  # the CPU path launches


def test_halo_step_checks_its_inputs():
    f = torch.rand(9, 8, 16)
    halo = Halo.cut(f, 0, 0, 4, 16, 2)
    kw = dict(omega=1.7, u_lb=0.0, v_lb=0.0, lb_G=0.0)
    out = torch.empty_like(halo.f)
    with pytest.raises(ValueError, match="k_steps"):
        temporal_halo_step(halo, out, 3, "diffusion", **kw)
    with pytest.raises(TypeError, match="arguments"):
        temporal_halo_step(halo, out, 1, "diffusion", omega=1.7)
    with pytest.raises(ValueError, match="physics"):
        temporal_halo_step(halo, out, 1, "plasma", **kw)
    with pytest.raises(ValueError, match="x strips"):
        temporal_halo_step(
            Halo.cut(f, 0, 0, 4, 8, 2)._replace(left=None, right=None),
            torch.empty(9, 4, 8), 1, "diffusion", **kw)
    with pytest.raises(ValueError, match="distinct"):
        temporal_halo_step(halo, halo.f, 1, "diffusion", **kw)


def test_distributed_single_process_init(monkeypatch):
    # the module's globals are restored after the test
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_local_devices", None)
    init_distributed(num_processes=1, device="cpu")
    assert is_initialized()
    mesh = global_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.shape["y"] >= mesh.shape["x"]
    sh = ShardedPipeFlow(mesh=global_mesh(shape=(8, 1), devices=["cpu"] * 8),
                         **PIPE_16x32)
    sh.run(4)
    assert np.isfinite(sh.state_numpy()).all()


def _two_process_runs(mesh):
    """The runs the two-process test compares: ShardedPipeFlow through K9
    (5 steps) and the stochastic ShardedDiffusion (6 steps)."""
    pipe = ShardedPipeFlow(mesh=mesh, backend="temporal", **PIPE_16x32)
    pipe.run(5)
    sto = ShardedDiffusion(torch_models.ReactionAdvectionDiffusionStochastic(
        device="cpu", Dg=0.2, **dict(DIFFUSION_128, N=30)), mesh=mesh)
    sto.run(6)
    return pipe.state_numpy(), sto.state_numpy()


def test_two_process_gloo_run_equals_one_process(tmp_path):
    """Two CPU processes (this file as the child) join through a localhost
    port on gloo, each holding 2 shards of a 4x1 mesh, and equal the
    single-process run bit for bit (``test_sharding.py:555-645``)."""
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + sys.path))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for rank in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (out[-1000:], err[-3000:])
    results = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(2)]
    assert [r["local"] for r in results] == [[[0, 0], [1, 0]],
                                             [[2, 0], [3, 0]]]
    pipe, sto = _two_process_runs(_mesh((4, 1)))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as got:
            assert np.array_equal(got["pipe"], pipe)
            assert np.array_equal(got["sto"], sto)


def _child(rank, port, out_dir):
    import torch.distributed as dist

    init_distributed(f"localhost:{port}", num_processes=2, process_id=rank,
                     device="cpu")
    mesh = global_mesh(shape=(4, 1), devices=["cpu", "cpu"])
    pipe, sto = _two_process_runs(mesh)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), pipe=pipe, sto=sto)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"local": mesh.local_positions()}, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
