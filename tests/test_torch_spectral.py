"""The port's spectral solve against JAX, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and
its counterpart in the port:

* the plain screened-gradient solve (``screened_gradients_reference``, and
  ``screened_gradients`` on CPU tensors) against JAX's
  ``_ScreenedVelocity(method="fft")`` at square, oblong and odd sizes, to
  1e-6 of max |g| (two complex64 FFT libraries);
* the same against JAX's K8, ``screened_gradients_pl`` run in interpret
  mode as tests/test_dft_pallas.py runs it, to 1e-5 of max |g| (its 4-step
  matmul DFT is ~5e-6 off an FFT);
* ``dft_axis0_reference`` against ``make_axis0_dft`` in interpret mode,
  real and complex, forward and inverse, to 1e-6 of the scale;
* ``ScreenedPoisson`` and ``screened_poisson_solve`` against JAX's, both
  ``dx`` conventions, to 1e-6 relative.

K8 itself is CUDA and is held to these plain versions on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lb2d_tpu.models.spectral as jax_spectral
from lb2d_tpu.models.waves import _ScreenedVelocity as JaxScreenedVelocity
from lb2d_tpu.ops.dft_pallas import make_axis0_dft, screened_gradients_pl
from lb2d_tpu_torch.models import spectral as torch_spectral
from lb2d_tpu_torch.models.waves import _ScreenedVelocity
from lb2d_tpu_torch.ops.spectral import (
    dft_axis0,
    dft_axis0_reference,
    fft_radices,
    screened_gradients,
    screened_gradients_reference,
    spectral_grids,
)

torch.set_num_threads(1)

SHAPES = [(64, 64), (48, 48), (64, 96), (45, 50)]


def _rho(ny, nx, seed=0):
    return np.random.RandomState(seed).rand(ny, nx).astype(np.float32)


def _rel(a, b):
    """max |a - b| over max |b| of the two gradient planes."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{y}x{x}" for y, x in SHAPES])
def test_screened_gradients_reference_matches_jax_fft(shape):
    ny, nx = shape
    rho = _rho(ny, nx)
    vel = JaxScreenedVelocity(ny, nx, lam=0.7, delta_x=1.0 / nx, vc=1.3,
                              ulb=0.01, method="fft")
    u, v = vel(jnp.asarray(rho))
    want = np.stack([np.asarray(u), np.asarray(v)])
    got = screened_gradients_reference(torch.from_numpy(rho), vel._lam2,
                                       out_scale=vel.scale).numpy()
    assert _rel(got, want) < 1e-6
    xg, yg = screened_gradients_reference(torch.from_numpy(rho), vel._lam2)
    np.testing.assert_array_equal(np.float32(vel.scale) * xg.numpy(), got[0])
    np.testing.assert_array_equal(np.float32(vel.scale) * yg.numpy(), got[1])
    # the port's velocity object, as the models call it
    port = _ScreenedVelocity(ny, nx, lam=0.7, delta_x=1.0 / nx, vc=1.3,
                             ulb=0.01)
    assert port.scale == vel.scale and port._lam2 == vel._lam2
    pu, pv = port(torch.from_numpy(rho))
    assert _rel(np.stack([pu.numpy(), pv.numpy()]), want) < 1e-6


@pytest.mark.parametrize("shape", [(256, 384), (128, 256)],
                         ids=["256x384", "128x256"])
def test_screened_gradients_match_jax_k8_interpret(shape):
    ny, nx = shape
    rho = _rho(ny, nx, seed=1)
    fx, fy, gx, gy = (t.numpy() for t in spectral_grids(ny, nx))
    lam2, s = np.float32(25.0), -3.0e-4
    want = screened_gradients_pl(jnp.asarray(rho), jnp.asarray(fx),
                                 jnp.asarray(fy), jnp.asarray(gx),
                                 jnp.asarray(gy), lam2, interpret=True,
                                 out_scale=s)
    got = screened_gradients(torch.from_numpy(rho), lam2, out_scale=s)
    assert got.shape == (2, ny, nx)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("method", ["auto", "fft"])
def test_ext_planes_match_jax(method):
    """The multicomponent engine's hand-off ``stack(amp u, amp v)``: K8's
    plain version (``auto`` on CPU tensors) and ``torch.fft`` by name."""
    ny, nx = 48, 64
    rho = _rho(ny, nx, seed=2)
    kw = dict(lam=4.0, delta_x=1.0, vc=1.0, ulb=1.0)
    want = JaxScreenedVelocity(ny, nx, method="fft", **kw).ext_planes(
        jnp.asarray(rho), -0.05)
    port = _ScreenedVelocity(ny, nx, method=method, **kw)
    out = torch.empty((2, ny, nx))
    got = port.ext_planes(torch.from_numpy(rho), -0.05, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert _rel(got.numpy(), want) < 1e-6


def test_spectral_grids_match_jax_multipliers():
    for ny, nx in ((64, 96), (45, 50)):
        vel = JaxScreenedVelocity(ny, nx, lam=1.0, delta_x=1.0 / nx, vc=1.0,
                                  ulb=1.0)
        fx, fy, gx, gy = spectral_grids(ny, nx)
        for ours, theirs in ((fx, vel._fx), (fy, vel._fy), (gx, vel._gx),
                             (gy, vel._gy)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


AXIS0 = [(True, False, None), (False, False, None), (False, True, None),
         (True, False, 129)]


@pytest.mark.parametrize("real,inverse,out_rows", AXIS0,
                         ids=["real", "complex", "inverse", "half-spectrum"])
def test_dft_axis0_reference_matches_jax_interpret(real, inverse, out_rows):
    n = W = 256
    rs = np.random.RandomState(0)
    xr = rs.rand(n, W).astype(np.float32)
    xi = rs.rand(n, W).astype(np.float32)
    kw = dict(real_input=real, inverse=inverse, interpret=True)
    if out_rows is not None:
        kw["out_rows"] = out_rows
    fn = make_axis0_dft(n, W, **kw)
    yr, yi = fn(jnp.asarray(xr)) if real else fn(jnp.asarray(xr),
                                                   jnp.asarray(xi))
    rows = n if out_rows is None else out_rows
    args = (torch.from_numpy(xr), None if real else torch.from_numpy(xi))
    ar, ai = dft_axis0_reference(*args, inverse=inverse, out_rows=out_rows)
    scale = max(float(ar.abs().max()), float(ai.abs().max()))
    assert ar.shape == (rows, W)
    np.testing.assert_allclose(ar.numpy(), np.asarray(yr)[:rows],
                               atol=1e-6 * scale)
    np.testing.assert_allclose(ai.numpy(), np.asarray(yi)[:rows],
                               atol=1e-6 * scale)
    # the wrapper on CPU tensors is the plain version
    br, bi = dft_axis0(*args, inverse=inverse, out_rows=out_rows)
    assert torch.equal(br, ar) and torch.equal(bi, ai)


@pytest.mark.parametrize("dx", [1.0, 1.0 / 48], ids=["dx=1", "dx=1/N"])
def test_screened_poisson_matches_jax(dx):
    ny, nx = 64, 48
    rs = np.random.RandomState(4)
    charge = rs.rand(ny, nx).astype(np.float32)
    want = jax_spectral.screened_poisson_solve(charge, lam=0.3, dx=dx,
                                               method="fft")
    got = torch_spectral.screened_poisson_solve(charge, lam=0.3, dx=dx,
                                                device="cpu")
    if not torch.cuda.is_available():  # an array solves on the card by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_spectral.screened_poisson_solve(charge, lam=0.3, dx=dx)
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-6 * np.abs(np.asarray(w)).max())
    # the class API, with the reference's x-major layout
    jp = jax_spectral.ScreenedPoisson(charge.T, lam=0.3, dx=dx, xy=True,
                                      method="fft")
    tp = torch_spectral.ScreenedPoisson(charge.T, lam=0.3, dx=dx, xy=True,
                                        device="cpu")
    for sp in (jp, tp):
        sp.create_grad_fields()
        sp.solve_and_update_grad_fields()
    for name in ("charge", "xgrad", "ygrad"):
        w = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), w,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    for sp in (jp, tp):
        sp.inverse_fft()
    w = np.asarray(jp.charge)
    np.testing.assert_allclose(tp.charge.numpy(), w,
                               atol=1e-6 * np.abs(w).max())
    tp.set_charge(charge.T, xy=True)
    assert torch.equal(tp.charge, torch.from_numpy(charge).to(torch.complex64))


def test_spectral_method_names_torch_fft():
    for method in ("auto", "fft", "matmul", "pallas"):
        assert torch_spectral.spectral_method(method) == "fft"
    with pytest.raises(ValueError, match="unknown method"):
        torch_spectral.spectral_method("cufft")


def test_wrappers_on_cpu_run_the_plain_solve_and_check_arguments():
    rho = torch.from_numpy(_rho(30, 34))
    before = (screened_gradients.launches, dft_axis0.launches)
    out = torch.empty((2, 30, 34))
    got = screened_gradients(rho, 2.0, out=out, out_scale=0.5)
    assert got is out
    assert torch.equal(out, screened_gradients_reference(rho, 2.0,
                                                         out_scale=0.5))
    xg, yg = screened_gradients(rho, 2.0)
    want = screened_gradients_reference(rho, 2.0)
    assert torch.equal(xg, want[0]) and torch.equal(yg, want[1])
    assert (screened_gradients.launches, dft_axis0.launches) == before
    with pytest.raises(TypeError, match="float32"):
        screened_gradients(rho.double(), 2.0)
    with pytest.raises(ValueError, match="out must be"):
        screened_gradients(rho, 2.0, out=torch.empty((2, 30, 33)))
    with pytest.raises(ValueError, match="contiguous"):
        screened_gradients(rho.t(), 2.0)
    with pytest.raises(ValueError, match="out_rows"):
        dft_axis0(rho, out_rows=31)


@pytest.mark.parametrize("n", [1, 2, 48, 50, 127, 250, 8192, 14528, 20000,
                               2 * 3 * 5 * 7 * 11 * 13])
def test_fft_radices_factor_every_length(n):
    radices = fft_radices(n)
    assert int(np.prod(radices)) == n
    small = [r for r in radices if r <= 8]
    assert small == sorted(small, key=(8, 4, 2, 3, 5, 7).index)
    if n == 8192:
        assert radices == [8, 8, 8, 8, 2]
    if n == 127:
        assert radices == [127]
