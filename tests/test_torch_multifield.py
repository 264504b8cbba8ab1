"""The port's multifield range expansions against the JAX package, on the CPU.

Parity: each port model is built from the same arguments as its JAX model
(22x22, the recipes of tests/test_multifield.py and tests/test_utils.py),
given the JAX state with ``load_numpy_state``, and both run 4 steps (the
port through its eager path). Tolerance 5e-7, the reference's
kernel-vs-XLA bar (tests/test_fused.py); 1e-6 against JAX's K4 (with its
wall or seam patch) and K5 Pallas kernels in interpret mode at 128x128, the
bar of tests/test_multifield.py. The noisy Expansion step is held to JAX
with the same normals fed to both; the port's own Philox noise to a fixed
seed, split runs, its pairing of populations and its amplitude.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lb2d_tpu.models.multifield as jax_multifield
from lb2d_tpu.core.lattice import D2Q9 as JAX_D2Q9
from lb2d_tpu.ops.fused import make_expansion_band_step
import lb2d_tpu_torch.models as torch_models
from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.models import multifield
from lb2d_tpu_torch.ops import _build
from lb2d_tpu_torch.ops.equilibrium import feq_linear
from lb2d_tpu_torch.ops.fused import (
    MAX_MULTIFIELD_FIELDS,
    expansion_band_reference,
    expansion_band_step,
    expansion_step_reference,
    multifield_max_k,
    multifield_run_reference,
    temporal_multifield_step,
)
from lb2d_tpu_torch.ops.random import (
    normals_reference,
    population_normals_reference,
)
from lb2d_tpu_torch.ops.stream import stream

torch.set_num_threads(1)

TOL = 5e-7
KERNEL_TOL = 1e-6
FISHER = dict(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0, 1.0],
              D_standard=1.0, D_list=[1.0, 1.0], N=10,
              initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
EXPANSION = dict(Lx=4.0, Ly=4.0, mu_standard=1.0, mu_list=[1.0, 1.0],
                 D_standard=1.0, D_list=[1.0, 1.0], N=10, Dc=1.0)
# 128 x 128, as tests/test_multifield.py holds the TPU kernels
GRID128 = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
               D_standard=1.0, D_list=[1.0, 1.2], N=63)
STRIPES = dict(initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
CASES = {
    "fisher": ("FisherExpansion", FISHER),
    "fisher-one-population": ("FisherExpansion", dict(
        FISHER, mu_list=[1.0], D_list=[1.0], initial_frac_widths=[1.0],
        initial_frac_indices=[0])),
    "expansion-Nb-inf": ("Expansion", dict(EXPANSION, Nb=np.inf)),
}


def _pair(name, kw):
    """The JAX model and the port's (on the CPU) from the same arguments."""
    jax_sim = getattr(jax_multifield, name)(**kw)
    sim = getattr(torch_models, name)(device="cpu", **kw)
    return jax_sim, sim


def _jax_f(jax_sim):
    state = jax_sim.state
    return np.asarray(state[0] if isinstance(state, tuple) else state)


def _random_fields(F, ny, nx, seed=3):
    return np.random.RandomState(seed).rand(9, F, ny, nx).astype(np.float32)


def test_stream_and_feq_on_fields_match_jax():
    f = _random_fields(3, 13, 17)
    want = np.asarray(jax_multifield._stream_fields(jnp.asarray(f), JAX_D2Q9))
    assert np.array_equal(stream(torch.from_numpy(f)).numpy(), want)
    jax_sim, sim = _pair("FisherExpansion", dict(FISHER, vx=0.3, vy=-0.2,
                                                 vc=1.0))
    assert sim.u_lb != 0 and sim.v_lb != 0
    rho = f.sum(0)
    want = np.asarray(jax_sim._feq(jnp.asarray(rho)))
    got = feq_linear(torch.from_numpy(rho), sim.u, sim.v).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(22, 22), (5, 7)], ids=["22x22", "5x7"])
def test_noflux_walls_match_jax(shape):
    f = _random_fields(2, *shape)
    want = np.asarray(jax_multifield.noflux_bcs_multifield(jnp.asarray(f)))
    got = multifield.noflux_bcs_multifield(torch.from_numpy(f)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    name, kw = CASES[case]
    jax_sim, sim = _pair(name, kw)
    assert (sim.ny, sim.nx) == (jax_sim.ny, jax_sim.nx) == (22, 22)
    assert sim.backend == "eager"
    np.testing.assert_array_equal(sim.omega, jax_sim.omega)
    np.testing.assert_array_equal(sim.lb_G, jax_sim.lb_G)
    if name == "Expansion":
        np.testing.assert_array_equal(sim.lb_Dg, jax_sim.lb_Dg)
        assert sim.omega_nutrient == jax_sim.omega_nutrient
    f0 = _jax_f(jax_sim)
    assert np.array_equal(sim.state_numpy(), f0)  # same initial state
    sim.load_numpy_state(f0)
    sim.run(4)
    jax_sim.run(4)
    assert sim.steps_taken == 4
    d = float(np.abs(sim.state_numpy() - _jax_f(jax_sim)).max())
    assert d < TOL, d


def test_noisy_expansion_matches_jax_with_the_same_noise(monkeypatch):
    """4 Milstein steps with the same normals in both packages: numpy draws
    them, the port takes them as ``eta=``, JAX's ``jax.random.normal`` is
    replaced to return them."""
    jax_sim, sim = _pair("Expansion", dict(EXPANSION, Nb=10.0))
    kw = sim.step_kwargs()
    assert (kw["lb_Dg"] > 0).all()
    P = sim.num_populations
    etas = np.random.RandomState(11).randn(4, P, sim.ny, sim.nx).astype(
        np.float32)
    fed = iter(etas)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(next(fed)))
    step = jax_sim._make_xla_stochastic_step()
    state = jax_sim.state
    f = torch.from_numpy(_jax_f(jax_sim).copy())
    for i in range(4):
        state = step(state)
        f = expansion_step_reference(
            f, kw["omegas"], kw["omega_nutrient"], kw["lb_G"], kw["lb_Dg"],
            kw["cutoff"], kw["u_lb"], kw["v_lb"], seed=sim.rng_seed, step=i,
            eta=torch.from_numpy(etas[i]))
    d = float(np.abs(np.asarray(state[0]) - f.numpy()).max())
    assert d < TOL, d


def test_temporal_wrapper_matches_jax_fisher_kernel():
    """The K4 wrapper's CPU path against JAX's fisher temporal kernel
    (interpret mode) with its wall seam patch, K=2, three calls."""
    jax_sim, sim = _pair("FisherExpansion", dict(GRID128, **STRIPES))
    assert (sim.ny, sim.nx) == (128, 128)
    step2 = jax_sim._make_temporal_step(2, interpret=True)
    kw = sim.step_kwargs()
    a = jax_sim.state
    f = torch.from_numpy(_jax_f(jax_sim).copy())
    for _ in range(3):
        a = step2(a)
        f = temporal_multifield_step(f, torch.empty_like(f), 2, **kw)
    d = float(np.abs(np.asarray(a) - f.numpy()).max())
    assert d < KERNEL_TOL, d


def test_temporal_wrapper_matches_jax_expansion_kernel():
    """The K4 wrapper's CPU path against JAX's expansion temporal kernel
    and its K5 seam band (interpret mode) at Nb = inf, K=2."""
    jax_sim, sim = _pair("Expansion", dict(GRID128, Nb=np.inf, Dc=1.0))
    step2 = jax_sim._make_expansion_temporal_step(2, interpret=True)
    f = torch.from_numpy(_jax_f(jax_sim).copy())
    want = np.asarray(step2(jax_sim.state)[0])
    got = temporal_multifield_step(f, torch.empty_like(f), 2,
                                   **sim.step_kwargs())
    d = float(np.abs(want - got.numpy()).max())
    assert d < KERNEL_TOL, d


def _band(f, B):
    """Rows [-B, B) of a [9, F, ny, nx] state."""
    return torch.cat([f[:, :, -B:], f[:, :, :B]], dim=2).contiguous()


def _band_args(kw):
    return (kw["omegas"], kw["omega_nutrient"], kw["lb_G"], kw["lb_Dg"],
            kw["cutoff"], kw["u_lb"], kw["v_lb"])


def test_band_matches_jax_band_kernel_without_noise():
    """K5's plain version and its wrapper's CPU path against JAX's band
    kernel (interpret mode) at Dg = 0: a band of 2B = 16 rows, K=3."""
    jax_sim, sim = _pair("Expansion", dict(GRID128, Nb=np.inf, Dc=1.0))
    kw = sim.step_kwargs()
    K, B = 3, 8
    run = make_expansion_band_step(
        band_rows=2 * B, nx=sim.nx, num_fields=sim.num_fields,
        omegas=list(sim.omega) + [float(sim.omega_nutrient)],
        lb_G=sim.lb_G, lb_Dg=sim.lb_Dg, cutoff=sim.zero_cutoff,
        u_lb=sim.u_lb, v_lb=sim.v_lb, k_steps=K, interpret=True)
    band = _band(sim.state, B)
    want = np.asarray(run(jnp.asarray(band.numpy())))
    band_kw = dict(seed=sim.rng_seed, step0=5, row0=sim.ny - B, ny=sim.ny)
    got = expansion_band_reference(band, K, *_band_args(kw), **band_kw)
    assert got.shape == (9, sim.num_fields, 2 * K, sim.nx)
    d = float(np.abs(want - got.numpy()).max())
    assert d < KERNEL_TOL, d
    assert torch.equal(expansion_band_step(band, K, *_band_args(kw),
                                           **band_kw), got)
    assert expansion_band_step.launches == 0


@pytest.mark.parametrize("B", [6, 11], ids=["B=2K", "B=11"])
def test_band_with_noise_equals_the_whole_grid_rows(B):
    """With noise on, K5's rows are rows [-K, K) of K plain steps of the
    whole grid, bit for bit: band row r draws global row (row0 + r) mod ny.
    """
    sim = torch_models.Expansion(device="cpu", Nb=10.0, Dc=1.0, **dict(
        GRID128, N=15))
    kw = sim.step_kwargs()
    K, step0 = 3, 2**32 - 2
    f = multifield_run_reference(sim.state, 40, step0=0, **kw)  # a front
    whole = multifield_run_reference(f, K, step0=step0, **kw)
    got = expansion_band_step(_band(f, B), K, *_band_args(kw),
                              seed=sim.rng_seed, step0=step0,
                              row0=sim.ny - B, ny=sim.ny)
    assert torch.equal(got, _band(whole, K))
    with pytest.raises(ValueError, match="too short"):
        expansion_band_step(_band(f, B), B // 2 + 1, *_band_args(kw),
                            ny=sim.ny)


@pytest.mark.parametrize("backend", ["eager", "temporal"])
def test_split_runs_equal_one_run(backend, monkeypatch):
    """run(3); run(6) equals run(9) bit for bit, and each backend's wiring
    (driven on the CPU, where K4's wrapper runs its plain version) gives
    the eager trajectory: the noise is keyed by the global step."""
    monkeypatch.setattr(multifield._build, "load_library", lambda: None)
    kw = dict(EXPANSION, Nb=10.0, device="cpu")
    whole = torch_models.Expansion(**kw)
    split = torch_models.Expansion(**kw)
    split.backend = backend
    split._step = split.make_step()
    whole.run(9)
    split.run(3)
    split.run(6)
    assert split.steps_taken == 9
    assert torch.equal(split.state, whole.state)


def test_fixed_seed_reproduces_and_another_differs():
    kw = dict(EXPANSION, Nb=10.0, device="cpu")
    a = torch_models.Expansion(rng_seed=1, **kw)
    b = torch_models.Expansion(rng_seed=1, **kw)
    c = torch_models.Expansion(rng_seed=2, **kw)
    for sim in (a, b, c):
        sim.run(20)
    assert torch.equal(a.state, b.state)
    assert not torch.allclose(a.state, c.state)
    assert torch.isfinite(a.state).all() and (a.state >= 0).all()


def test_population_normals_pair_their_draws():
    """Population 0 is the single-field normal; populations 2a and 2a+1
    share one Philox call and are uncorrelated."""
    eta = population_normals_reference(9, 4, 3, 64, 128)
    assert eta.shape == (3, 64, 128)
    assert torch.equal(eta[0], normals_reference(9, 4, 64, 128))
    e = eta.reshape(3, -1).double().numpy()
    n = e.shape[1]
    for p, q in ((0, 1), (0, 2), (1, 2)):
        assert abs(np.corrcoef(e[p], e[q])[0, 1]) < 5.0 / np.sqrt(n)


def test_noise_amplitude_from_uniform_density():
    """From uniform rho_p = 0.5 and c = 1, one step adds to each population
    the Milstein term, whose std is sqrt(Dg rho c + (Dg c)^2 / 8), within
    5% (about 9 sampling sigmas at 16k cells); the nutrient loses what the
    populations gain."""
    sim = torch_models.Expansion(device="cpu", Nb=10.0, Dc=1.0, **GRID128)
    kw = sim.step_kwargs()
    P = sim.num_populations
    w = torch.tensor(D2Q9.w, dtype=torch.float32)[:, None, None, None]
    rho = torch.full((P + 1, sim.ny, sim.nx), 0.5)
    rho[P] = 1.0
    f0 = (w * rho).contiguous()
    f1 = temporal_multifield_step(f0, torch.empty_like(f0), 1, step0=7, **kw)
    d_rho = (f1.sum(0) - f0.sum(0)).double().numpy()
    for p in range(P):
        dg = float(kw["lb_Dg"][p])
        expected = np.sqrt(dg * 0.5 + dg**2 / 8)
        assert abs(d_rho[p].std() / expected - 1.0) < 0.05, (p, expected)
    np.testing.assert_allclose(d_rho[P], -d_rho[:P].sum(0), rtol=0,
                               atol=1e-6)


def test_auto_backend_and_kernel_limits(monkeypatch):
    """``auto`` is eager on the CPU; on a CUDA device (the picker reads only
    the device type, the dtype and the number of fields) it is K4 and
    raises, naming ``backend='eager'``, for float64 and for more fields
    than the kernel takes."""
    sim = torch_models.FisherExpansion(device="cpu", **FISHER)
    assert sim.backend == "eager"
    with pytest.raises(ValueError, match="CUDA"):
        sim._pick_backend("temporal")
    with pytest.raises(ValueError, match="unknown backend"):
        sim._pick_backend("resident")
    sim.device = torch.device("cuda")
    assert sim._pick_backend("auto") == "temporal"
    sim.dtype = torch.float64
    for backend in ("auto", "temporal"):
        with pytest.raises(ValueError, match="float32.*backend='eager'"):
            sim._pick_backend(backend)
    assert sim._pick_backend("eager") == "eager"
    many = MAX_MULTIFIELD_FIELDS + 1
    wide = torch_models.FisherExpansion(
        device="cpu", **dict(FISHER, mu_list=[1.0] * many,
                             D_list=[1.0] * many,
                             initial_frac_widths=[1.0 / many] * many,
                             initial_frac_indices=list(range(many))))
    wide.device = torch.device("cuda")
    with pytest.raises(ValueError, match=f"{MAX_MULTIFIELD_FIELDS} fields.*"
                                         "backend='eager'"):
        wide._pick_backend("auto")
    assert [multifield_max_k(F) for F in (1, 3, 4, 5, 6, 8)] == [8] * 6


def test_kernel_params_struct_layout():
    """The ctypes mirror of the kernels' by-value ``Lb2dMultifieldParams``:
    3 x 8 floats, 3 floats, 2 words, the 64-bit step at offset 120."""
    struct = _build.MultifieldParams
    assert ctypes.sizeof(struct) == 128
    assert (struct.cutoff.offset, struct.k0.offset, struct.step0.offset) == (
        96, 108, 120)


def test_wrappers_check_their_inputs():
    sim = torch_models.Expansion(device="cpu", Nb=10.0, **dict(GRID128,
                                                              N=15))
    kw = sim.step_kwargs()
    f = sim.state
    with pytest.raises(TypeError, match="float32"):
        temporal_multifield_step(f.double(), f.double().clone(), 1, **kw)
    with pytest.raises(ValueError, match=r"\[9, F, ny, nx\]"):
        temporal_multifield_step(f[0], f[0].clone(), 1, **kw)
    with pytest.raises(ValueError, match="k_steps"):
        temporal_multifield_step(f, torch.empty_like(f), 9, **kw)
    with pytest.raises(ValueError, match="population"):
        temporal_multifield_step(f, torch.empty_like(f), 1,
                                 **dict(kw, physics="fisher"))
    with pytest.raises(ValueError, match="distinct"):
        temporal_multifield_step(f, f, 1, **kw)


def test_scales_stripes_and_getters_match_jax():
    jax_sim, sim = _pair("FisherExpansion", FISHER)
    assert sim.L == pytest.approx(2.0) and sim.T == pytest.approx(1.0)
    assert sim.num_populations == sim.num_fields == 2
    assert sim.lb_G == pytest.approx([sim.delta_t] * 2)
    np.testing.assert_allclose(sim.omega, 1.0 / (
        0.5 + (0.25 * sim.delta_t / sim.delta_x**2) / (1 / 3)))
    rho0 = sim.get_fields()["rho"]  # [nx, ny, P]
    assert rho0[2, 5, 0] == pytest.approx(1.0, abs=1e-5)
    assert rho0[2, 5, 1] == pytest.approx(0.0, abs=1e-5)
    assert rho0[-3, 5, 1] == pytest.approx(1.0, abs=1e-5)
    assert rho0[2, 2 * sim.N + 1, 0] == pytest.approx(0.0, abs=1e-5)
    for getter in ("get_fields", "get_nondim_fields", "get_physical_fields"):
        want, got = getattr(jax_sim, getter)(), getattr(sim, getter)()
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape, (getter, key)
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=TOL)
    np.testing.assert_allclose(sim.device_field("rho").numpy(),
                               np.asarray(jax_sim.device_field("rho")),
                               rtol=0, atol=1e-6)
    assert sim.device_field("u") is None
    expansion = torch_models.Expansion(device="cpu", Nb=10.0, **EXPANSION)
    P = expansion.num_populations
    rho = expansion.get_fields()["rho"]
    assert rho.shape == (expansion.nx, expansion.ny, P + 1)
    np.testing.assert_allclose(rho[:, :2 * expansion.N, :P], 1.0 / P,
                               atol=1e-6)
    np.testing.assert_allclose(rho[:, :, P], 1.0, atol=1e-6)
