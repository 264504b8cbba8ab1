"""``ShardedCoupled`` (the port's sharded coupled families) against the JAX
package and against the port's unsharded models, on the CPU.

The counterparts of ``tests/test_sharding.py:305-445``: each coupled model
cut into meshes of CPU shards (``make_mesh(devices=["cpu"] * 4)``, 4x1 and
2x2), where the sharded sweeps run K7h's plain twin (the rocket yeasts
``COUPLED_TEMPORAL_K`` steps per sweep on 4x1, ``COUPLED_X_SHARDED_K`` on
2x2, from halos of twice that, the rest of ``run(n)`` one shorter
sweep) and the screened velocity is solved once
on the gathered density (``device="cpu"``: the ``eager`` backend). Each run is held to JAX's unsharded XLA step from the
same state at 128^2 (atol 5e-7, rtol 1e-5) and to the port's unsharded run
at 1e-7, where it is expected to agree exactly. JAX's XLA step solves its
velocity every step, so the ``stale_velocity`` runs are held to the port's
unsharded stale runs, which ``tests/test_torch_coupled.py`` holds to JAX's
kernel path.
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch import models as torch_models
from lb2d_tpu_torch.ops.fused_coupled import COUPLED_TEMPORAL_K
from lb2d_tpu_torch.parallel import Mesh, ShardedCoupled, make_mesh
from lb2d_tpu_torch.parallel.sharded import COUPLED_X_SHARDED_K

torch.set_num_threads(1)

ATOL, RTOL = 5e-7, 1e-5
EXACT = 1e-7  # against the port's unsharded run (expected 0)
MODELS = {
    "RocketYeast": dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0,
                        N=128, G_chen=-0.1),
    "RocketYeastForcesOnly": dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05,
                                  Gc=2.0, N=128, G_chen=-0.1, c_o=0.25,
                                  alpha=2.0),
    "ScreenedFisherWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
                               N=128),
    "SurfactantNutrientWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
                                   N=128),
    "ClumpySurfactantNutrientWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5,
                                         R0=0.2, N=128, rho_o=1.0,
                                         G_chen=-5.0),
}
STEPS = {"RocketYeast": 7, "RocketYeastForcesOnly": 7}  # the rest: 5
RUNS = [("RocketYeast", (4, 1)), ("RocketYeast", (2, 2)),
        ("RocketYeastForcesOnly", (2, 2)), ("ScreenedFisherWave", (4, 1)),
        ("ScreenedFisherWave", (2, 2)), ("SurfactantNutrientWave", (2, 2)),
        ("ClumpySurfactantNutrientWave", (2, 2))]


def _mesh(shape):
    return make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


def _model(name, **kw):
    return getattr(torch_models, name)(device="cpu", **MODELS[name], **kw)


def _jax_state(name, steps):
    """JAX's unsharded XLA step, ``steps`` steps from its initial state."""
    import jax
    import lb2d_tpu.models as jax_models

    sim = getattr(jax_models, name)(**MODELS[name])
    step = jax.jit(sim._make_xla_step())
    f = sim.state
    for _ in range(steps):
        f = step(f)
    return np.asarray(f)


class TestShardedCoupled:
    """``ShardedCoupled`` on CPU meshes (named so that ``-k ShardedCoupled``
    selects it)."""

    @pytest.mark.parametrize("name,mesh", RUNS,
                             ids=[f"{n}-{m[0]}x{m[1]}" for n, m in RUNS])
    def test_sharded_coupled_matches_jax_and_unsharded(self, name, mesh):
        steps = STEPS.get(name, 5)
        single = _model(name)
        sh = ShardedCoupled(_model(name), mesh=_mesh(mesh))
        rocket = name.startswith("Rocket")
        # the rocket yeasts' K: 8 where the mesh cuts x (its exchanges cost
        # the host more than a sweep's launches), COUPLED_TEMPORAL_K else
        K = (1 if not rocket else COUPLED_X_SHARDED_K if mesh[1] > 1
             else COUPLED_TEMPORAL_K[single.coupled_config().physics])
        assert sh.base.state is None and sh.steps_per_call == K
        single.run(steps)
        sh.run(2)
        sh.run(steps - 2)
        assert sh.steps_taken == sh.base.steps_taken == steps
        got = sh.state_numpy().reshape(single.state.shape)
        np.testing.assert_allclose(got, _jax_state(name, steps), atol=ATOL,
                                   rtol=RTOL)
        assert float(np.abs(got - single.state_numpy()).max()) <= EXACT

    @pytest.mark.parametrize("name", ["ScreenedFisherWave",
                                      "ClumpySurfactantNutrientWave"])
    def test_sharded_stale_velocity_equals_unsharded(self, name):
        """``stale_velocity=3``: ``run(7)`` is two sweeps that each solve
        once on the gathered density, then one exact step; ``k_steps``
        overrides the depth, as JAX's."""
        single = _model(name, stale_velocity=3)
        sh = ShardedCoupled(_model(name, stale_velocity=3),
                            mesh=_mesh((2, 2)))
        assert sh.steps_per_call == 3
        single.run(7)
        sh.run(7)
        got = sh.state_numpy().reshape(single.state.shape)
        assert float(np.abs(got - single.state_numpy()).max()) <= EXACT
        assert ShardedCoupled(_model(name, stale_velocity=3),
                              mesh=_mesh((2, 2)),
                              k_steps=2).steps_per_call == 2

    def test_sharded_coupled_getters_and_state(self):
        """get_fields and ``_state_model`` read the shards; a JAX state
        loads into them and both run on together."""
        import lb2d_tpu.models as jax_models

        name = "SurfactantNutrientWave"
        single = _model(name)
        sh = ShardedCoupled(_model(name), mesh=_mesh((4, 1)))
        single.run(3)
        sh.run(3)
        a, b = single.get_fields(), sh.get_fields()
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key
        assert torch.equal(sh._state_model(), single.state)
        assert sh.base.state is None
        ref = getattr(jax_models, name)(**MODELS[name])
        ref.run(2)
        sh.load_numpy_state(np.asarray(ref.state))
        ref.run(3)
        sh.run(3)
        np.testing.assert_allclose(
            sh.state_numpy().reshape(ref.state.shape),
            np.asarray(ref.state), atol=ATOL, rtol=RTOL)

    def test_sharded_coupled_checks_its_model(self):
        with pytest.raises(TypeError, match="unsupported model"):
            ShardedCoupled(torch_models.Diffusion(device="cpu", N=16),
                           mesh=_mesh((2, 2)))
        with pytest.raises(ValueError, match="must divide"):
            ShardedCoupled(_model("RocketYeast"), mesh=_mesh((3, 1)))
        sim = _model("RocketYeast")
        sim.backend = "kernel"  # as built on a card
        with pytest.raises(ValueError, match="CUDA devices"):
            ShardedCoupled(sim, mesh=_mesh((2, 2)))

    def test_sharded_coupled_keeps_the_model_on_its_device_type(self):
        """A model built on the CPU (its ``auto`` is the plain step) does
        not shard over a CUDA mesh, the default one included: the plain
        step would run on the card without being named. It keeps its
        state."""
        sim = _model("ScreenedFisherWave")
        cuda_mesh = Mesh([(0, "cuda:0")] * 4, (2, 2))
        with pytest.raises(ValueError, match="built on cpu.*device='cuda'"):
            ShardedCoupled(sim, mesh=cuda_mesh)
        assert sim.state is not None
