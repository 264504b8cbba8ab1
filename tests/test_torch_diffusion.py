"""The port's diffusion family against the JAX package, on the CPU.

Parity: each port model is built from the same arguments as its JAX model
(128x128: N=42, Lx=Ly=0.31, as tests/test_diffusion.py), given the JAX
state with ``load_numpy_state``, and both run 4 steps (the port through its
eager path). Tolerance 5e-7, the reference's kernel-vs-XLA bar
(tests/test_fused.py); 1e-6 and 2e-6 against JAX's temporal (with its seam
patch) and resident Pallas kernels in interpret mode, the bars of
tests/test_diffusion.py. The stochastic step is held to JAX with the same
normals fed to both; the port's own Philox noise is held to the three
checks of tests/test_noisy_kernel.py and to Random123's known answers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lb2d_tpu.models as jax_models
from lb2d_tpu.ops.equilibrium import feq_linear as jax_feq_linear
from lb2d_tpu.ops.fused import make_temporal_pipe_step
import lb2d_tpu_torch.models as torch_models
from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.models import diffusion
from lb2d_tpu_torch.ops.equilibrium import feq_linear
from lb2d_tpu_torch.ops.fused import (
    noisy_fisher_step_reference,
    resident_diffusion_run,
    temporal_diffusion_step,
)
from lb2d_tpu_torch.ops.random import (
    normals,
    normals_reference,
    philox4x32_10,
    philox_bits,
)

torch.set_num_threads(1)

TOL = 5e-7
GRID = dict(N=42, z=0.1, Lx=0.31, Ly=0.31)  # 128 x 128
ADVECTED = dict(D=0.01, vx=1.0, vy=0.5, vc=1.0)
CASES = {
    "diffusion": ("Diffusion", dict(D=1.0)),
    "advection": ("AdvectionDiffusion", ADVECTED),
    "reaction": ("ReactionDiffusion", dict(D=1.0, g=200.0)),
    "reaction-advection": ("ReactionAdvectionDiffusion",
                           dict(ADVECTED, g=5.0)),
    "stochastic-Dg0": ("ReactionAdvectionDiffusionStochastic",
                       dict(ADVECTED, g=5.0, Dg=0.0)),
    "noisy-wave-Nc-inf": ("NoisyAdvectedFisherWave",
                          dict(D=1.0, g=1.0, Nc=np.inf, vx=1.0, vy=0.5,
                               vc=1.0)),
}
NOISY = {
    "stochastic": ("ReactionAdvectionDiffusionStochastic",
                   dict(ADVECTED, g=5.0, Dg=1e-3)),
    "noisy-wave": ("NoisyAdvectedFisherWave",
                   dict(D=1.0, g=1.0, Nc=10.0, vx=1.0, vy=0.5, vc=1.0)),
}


def _pair(name, kw):
    """The JAX model and the port's (on the CPU) from the same arguments."""
    jax_sim = getattr(jax_models, name)(**GRID, **kw)
    sim = getattr(torch_models, name)(device="cpu", **GRID, **kw)
    return jax_sim, sim


def _jax_f(jax_sim):
    state = jax_sim.state
    return np.asarray(state[0] if isinstance(state, tuple) else state)


def test_feq_linear_matches_jax():
    rs = np.random.RandomState(3)
    rho = rs.rand(31, 61).astype(np.float32)
    u, v = np.float32(0.021), np.float32(-0.013)
    want = np.asarray(jax_feq_linear(jnp.asarray(rho), jnp.full((1, 1), u),
                                     jnp.full((1, 1), v)))
    got = feq_linear(torch.from_numpy(rho), torch.full((1, 1), float(u)),
                     torch.full((1, 1), float(v))).numpy()
    assert np.abs(want - got).max() <= 1e-7


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    name, kw = CASES[case]
    jax_sim, sim = _pair(name, kw)
    assert (sim.ny, sim.nx) == (jax_sim.ny, jax_sim.nx) == (128, 128)
    assert sim.backend == "eager"
    assert np.float32(sim.omega) == np.float32(jax_sim.omega)
    assert sim.u_lb == float(np.asarray(jax_sim.u).ravel()[0])
    assert sim.v_lb == float(np.asarray(jax_sim.v).ravel()[0])
    f0 = _jax_f(jax_sim)
    assert np.abs(sim.state_numpy() - f0).max() <= 1e-7  # same initial state
    sim.load_numpy_state(f0)
    sim.run(4)
    jax_sim.run(4)
    assert sim.steps_taken == 4
    d = float(np.abs(sim.state_numpy() - _jax_f(jax_sim)).max())
    assert d < TOL, d


def test_temporal_wrapper_matches_jax_kernel_with_seam_patch():
    """The K2 wrapper's CPU path against JAX's physics="diffusion" temporal
    kernel (interpret mode) plus its periodic seam patch, K=4."""
    jax_sim, sim = _pair("ReactionAdvectionDiffusion", dict(ADVECTED, g=5.0))
    step4 = jax_sim._make_temporal_step(4, make_temporal_pipe_step,
                                        interpret=True)
    want = np.asarray(step4(jax_sim.state))
    f_in = torch.from_numpy(_jax_f(jax_sim).copy())
    got = temporal_diffusion_step(f_in, torch.empty_like(f_in), 4, sim.omega,
                                  sim.u_lb, sim.v_lb, sim.G)
    d = float(np.abs(want - got.numpy()).max())
    assert d < 1e-6, d


def test_resident_wrapper_matches_jax_kernel():
    """The K3 wrapper's CPU path against JAX's physics="diffusion" resident
    kernel (interpret mode), 7 steps."""
    jax_sim, sim = _pair("ReactionAdvectionDiffusion", dict(ADVECTED, g=5.0))
    f0 = _jax_f(jax_sim).copy()
    jax_sim._install_resident_run(interpret=True)
    want = np.asarray(jax_sim._run_compiled(jnp.asarray(f0), jnp.int32(7)))
    got = torch.from_numpy(f0.copy())
    assert resident_diffusion_run(got, torch.empty_like(got), 7, sim.omega,
                                  sim.u_lb, sim.v_lb, sim.G) is got
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("case", list(NOISY))
def test_noisy_step_matches_jax_with_the_same_noise(case, monkeypatch):
    """4 stochastic steps with the same normals in both packages: numpy
    draws them, the port takes them as ``eta=``, JAX's ``jax.random.normal``
    is replaced to return them."""
    name, kw = NOISY[case]
    jax_sim, sim = _pair(name, kw)
    assert sim._lb_Dg() > 0
    etas = np.random.RandomState(11).randn(4, sim.ny, sim.nx).astype(
        np.float32)
    fed = iter(etas)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(next(fed)))
    step = jax_sim._make_xla_stochastic_step()
    state = jax_sim.state
    f = torch.from_numpy(_jax_f(jax_sim).copy())
    phys = sim.step_kwargs()
    for i in range(4):
        state = step(state)
        f = noisy_fisher_step_reference(
            f, phys["omega"], phys["u_lb"], phys["v_lb"], phys["lb_G"],
            phys["lb_Dg"], seed=sim.rng_seed, step=i,
            eta=torch.from_numpy(etas[i]))
    d = float(np.abs(np.asarray(state[0]) - f.numpy()).max())
    assert d < TOL, d


def test_noise_off_equals_the_deterministic_model():
    """Dg = 0: the stochastic model's trajectory equals the deterministic
    one bit for bit, through the eager step and the K2 and K3 wrappers'
    CPU paths (tests/test_noisy_kernel.py:26-39)."""
    kw = dict(GRID, **ADVECTED, g=5.0, device="cpu")
    noisy = torch_models.ReactionAdvectionDiffusionStochastic(Dg=0.0, **kw)
    det = torch_models.ReactionAdvectionDiffusion(**kw)
    noisy.run(6)
    det.run(6)
    assert torch.equal(noisy.state, det.state)
    f0 = det.state.clone()
    phys = noisy.step_kwargs()
    a = temporal_diffusion_step(f0, torch.empty_like(f0), 5, step0=6, **phys)
    b = temporal_diffusion_step(f0, torch.empty_like(f0), 5, det.omega,
                                det.u_lb, det.v_lb, det.G)
    assert torch.equal(a, b)
    c = f0.clone()
    resident_diffusion_run(c, torch.empty_like(c), 5, step0=6, **phys)
    assert torch.equal(c, b)


def test_noise_amplitude_from_uniform_density():
    """From uniform rho = 0.5, one K=2 sweep adds density noise of mean ~0
    and std within 0.5-2x of sqrt(2 Dg rho (1 - rho))
    (tests/test_noisy_kernel.py:42-65); a single step adds exactly
    sqrt(Dg / 4) eta, so its std is within 3% of sqrt(Dg / 4) (5 sampling
    sigmas at 16k cells)."""
    sim = torch_models.NoisyAdvectedFisherWave(
        device="cpu", **dict(NOISY["noisy-wave"][1], N=63, z=0.1, Lx=0.21,
                             Ly=0.21))
    assert (sim.ny, sim.nx) == (128, 128)
    phys = sim.step_kwargs()
    Dg = phys["lb_Dg"]
    w = torch.tensor(D2Q9.w, dtype=torch.float32)[:, None, None]
    f0 = (0.5 * w).expand(9, sim.ny, sim.nx).contiguous()
    for k, expected, lo, hi in ((2, np.sqrt(2 * Dg * 0.25), 0.5, 2.0),
                                (1, np.sqrt(Dg * 0.25), 0.97, 1.03)):
        noisy = temporal_diffusion_step(f0, torch.empty_like(f0), k, **phys)
        base = temporal_diffusion_step(f0, torch.empty_like(f0), k,
                                       **dict(phys, lb_Dg=0.0))
        diff = (noisy - base).sum(0)[8:-8].numpy()  # interior rows
        assert abs(diff.mean()) < 0.1 * expected
        assert lo * expected < diff.std() < hi * expected, (
            k, diff.std(), expected)


def test_fixed_seed_reproduces_and_another_differs():
    kw = dict(NOISY["noisy-wave"][1], **GRID, device="cpu")
    a = torch_models.NoisyAdvectedFisherWave(**kw)
    b = torch_models.NoisyAdvectedFisherWave(**kw)
    c = torch_models.NoisyAdvectedFisherWave(rng_seed=123, **kw)
    for sim in (a, b, c):
        sim.run(5)
    assert torch.equal(a.state, b.state)
    assert not torch.equal(a.state, c.state)


@pytest.mark.parametrize("backend", ["eager", "temporal", "resident"])
def test_split_runs_equal_one_run(backend, monkeypatch):
    """run(3); run(6) equals run(9) bit for bit, and each backend's wiring
    (driven on the CPU, where the wrappers run their plain versions) gives
    the eager trajectory: the noise is keyed by the global step."""
    monkeypatch.setattr(diffusion._build, "load_library", lambda: None)
    kw = dict(NOISY["stochastic"][1], **GRID, device="cpu")
    whole = torch_models.ReactionAdvectionDiffusionStochastic(**kw)
    split = torch_models.ReactionAdvectionDiffusionStochastic(**kw)
    split.backend = backend
    split._step = split.make_step()
    whole.run(9)
    split.run(3)
    split.run(6)
    assert split.steps_taken == 9
    assert torch.equal(split.state, whole.state)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32_10."""
    got = philox4x32_10(counter, key)
    assert [int(x) for x in got] == list(want)


def _philox_int(c, k):
    """Philox4x32-10 on Python integers, independent of the torch code."""
    m = 0xFFFFFFFF
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & m]
    return c


def test_philox_matches_integer_arithmetic():
    rs = np.random.RandomState(5)
    counters = rs.randint(0, 1 << 32, size=(4, 64), dtype=np.int64)
    key = (int(rs.randint(0, 1 << 32, dtype=np.int64)),
           int(rs.randint(0, 1 << 32, dtype=np.int64)))
    got = philox4x32_10(tuple(torch.from_numpy(c) for c in counters), key)
    for i in range(counters.shape[1]):
        want = _philox_int([int(c) for c in counters[:, i]], key)
        assert [int(x) for x in got[:, i]] == want


def test_normals_moments_and_wrapper_on_cpu():
    """2^17 normals: mean, std and excess kurtosis of N(0, 1) within 5
    sampling sigmas (as benchmarks/tpu_tests.py probes the TPU's PRNG); the
    wrapper on the CPU is the plain version and launches nothing."""
    eta = normals_reference(1234, 7, 512, 256).double().numpy()
    n = eta.size
    assert n == 1 << 17 and np.isfinite(eta).all()
    assert abs(eta.mean()) < 5.0 / np.sqrt(n)
    assert abs(eta.std() - 1.0) < 5.0 / np.sqrt(2 * n)
    kurt = ((eta - eta.mean()) ** 4).mean() / eta.var() ** 2 - 3.0
    assert abs(kurt) < 5 * np.sqrt(24.0 / n)
    got = normals(1234, 7, (512, 256), "cpu")
    assert torch.equal(got, normals_reference(1234, 7, 512, 256))
    bits = philox_bits(1234, 7, 16, "cpu")
    assert bits.shape == (4, 16) and int(bits.max()) < 1 << 32
    assert normals.launches == philox_bits.launches == 0
    other = normals_reference(1234, 8, 512, 256).numpy()
    assert abs(np.corrcoef(eta.ravel(), other.ravel())[0, 1]) < 5.0 / np.sqrt(n)


def test_model_noise_is_the_field_its_step_draws():
    sim = torch_models.NoisyAdvectedFisherWave(
        device="cpu", **NOISY["noisy-wave"][1], **GRID)
    sim.run(3)
    assert torch.equal(sim.noise(), normals_reference(0, 3, sim.ny, sim.nx))
    with pytest.raises(ValueError, match="no noise"):
        torch_models.Diffusion(device="cpu", **GRID).noise()


def _seen_on_cuda(sim):
    """The model as the backend picker would see it on a CUDA device (the
    picker reads only the device type, the dtype and the grid)."""
    sim.device = torch.device("cuda")
    return sim


def test_auto_backend_ladder():
    sim = torch_models.AdvectionDiffusion(device="cpu", **GRID, **ADVECTED)
    assert sim.backend == "eager"  # the CPU default
    for backend in ("resident", "temporal"):
        with pytest.raises(ValueError, match="CUDA"):
            sim._pick_backend(backend)
    _seen_on_cuda(sim)
    assert sim._pick_backend("auto") == "resident"
    sim.ny = sim.nx = 2048
    assert sim._pick_backend("auto") == "temporal"
    for backend in ("resident", "temporal", "eager"):
        assert sim._pick_backend(backend) == backend
    with pytest.raises(ValueError, match="unknown backend"):
        sim._pick_backend("kernel")


def test_float64_on_cuda_needs_the_eager_backend_by_name():
    sim = torch_models.NoisyAdvectedFisherWave(device="cpu",
                                               dtype=torch.float64, **GRID)
    assert sim.backend == "eager" and sim.state.dtype == torch.float64
    _seen_on_cuda(sim)
    for backend in ("auto", "resident", "temporal"):
        with pytest.raises(ValueError, match="float32"):
            sim._pick_backend(backend)
    assert sim._pick_backend("eager") == "eager"


def test_getters_and_scales():
    sim = torch_models.ReactionAdvectionDiffusion(device="cpu", g=1.0, D=0.1,
                                                  vx=0.0, vy=0.0, vc=1.0,
                                                  **GRID)
    assert sim.vf_dim == pytest.approx(2 * np.sqrt(sim.G_dim / sim.Pe))
    fields = sim.get_physical_fields()
    assert fields["f"].shape == (9, sim.nx, sim.ny)
    assert fields["rho"].shape == fields["u"].shape == (sim.nx, sim.ny)
    np.testing.assert_array_equal(
        fields["rho"], sim.device_field("rho").numpy().T)
    with pytest.raises(ValueError, match="unstable"):
        torch_models.Diffusion(device="cpu", N=10, time_prefactor=0.0)
