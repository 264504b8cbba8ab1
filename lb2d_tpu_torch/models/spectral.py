"""Spectral screened-Poisson solver on ``torch.fft`` (counterpart of
``lb2d_tpu.models.spectral``).

Solves ``(1 - lam^2 nabla^2) phi = charge`` in Fourier space with the
multiplier ``1 / (lam^2 k^2 + 1)`` (``screened_poisson.py:38``) and the two
gradient fields by spectral differentiation ``2 pi i k phi_hat``
(``screened_poisson.py:60-84``), with the reference's frequencies ``k = L
fftfreq(n, d=dx)`` (integer cycles per box) and no ``1/L`` in the gradient
multiplier (consumers absorb it). Complex64 throughout.

JAX runs these with ``jnp.fft``, or on a TPU with its matmul DFT (the TPU
backend had no FFT), never through a Pallas kernel, so plain ``torch.fft``
is their port; the matmul DFT (``lb2d_tpu/ops/dft.py``) is not ported. The
models' per-step screened gradients run through K8
(:mod:`lb2d_tpu_torch.ops.spectral`).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import resolve_device

__all__ = ["ScreenedPoisson", "screened_poisson_solve", "spectral_method"]

_METHODS = ("auto", "fft", "matmul", "pallas")


def spectral_method(method: str = "auto") -> str:
    """The FFT implementation of :class:`ScreenedPoisson`: always ``"fft"``
    (``torch.fft``). JAX picks its matmul DFT on a TPU, which has no FFT;
    the port takes ``"matmul"`` and ``"pallas"`` for the API and runs
    ``torch.fft`` for them too."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; use one of "
                         f"{', '.join(_METHODS)}")
    return "fft"


def _freqs(ny, nx, dx):
    """The reference's frequency grids ``(n dx) fftfreq(n, d=dx)`` along x
    and y, float64 (``lb2d_tpu/models/spectral.py:65-68``)."""
    fx = (nx * dx) * np.fft.fftfreq(nx, d=dx)
    fy = (ny * dx) * np.fft.fftfreq(ny, d=dx)
    return fx, fy


def _multipliers(ny, nx, lam, dx, device):
    """``(rescaling, kx 2 pi i, ky 2 pi i)`` as complex64 ``[ny, nx]``,
    computed in float32 as JAX computes them."""
    fx, fy = _freqs(ny, nx, dx)
    KX = torch.tensor(np.broadcast_to(fx[None, :], (ny, nx)),
                      dtype=torch.float32, device=device)
    KY = torch.tensor(np.broadcast_to(fy[:, None], (ny, nx)),
                      dtype=torch.float32, device=device)
    rescaling = 1.0 / (lam**2 * (KX**2 + KY**2) + 1.0)
    return (rescaling.to(torch.complex64),
            (2j * np.pi) * KX.to(torch.complex64),
            (2j * np.pi) * KY.to(torch.complex64))


def screened_poisson_solve(charge, lam=1.0, dx=1.0, method="auto",
                           device="cuda"):
    """One-shot solve: ``(phi, xgrad, ygrad)`` as complex64 tensors of
    ``charge``'s ``[y, x]`` shape. ``charge`` is a tensor (solved on its
    device) or an array (solved on ``device``, default ``"cuda"``; pass
    ``device="cpu"`` on a machine without a card)."""
    spectral_method(method)
    if isinstance(charge, torch.Tensor):
        c = charge.to(torch.complex64)
    else:
        c = torch.tensor(np.asarray(charge), device=resolve_device(device)
                         ).to(torch.complex64)
    ny, nx = c.shape
    rescaling, kx2pi, ky2pi = _multipliers(ny, nx, lam, dx, c.device)
    chat = torch.fft.fft2(c) * rescaling
    return (torch.fft.ifft2(chat), torch.fft.ifft2(chat * kx2pi),
            torch.fft.ifft2(chat * ky2pi))


class ScreenedPoisson:
    """API mirror of ``Screened_Poisson``. ``charge`` is ``[ny, nx]``
    complex64 (the reference's is (nx, ny) x-major; pass ``xy=True`` to
    accept that layout), on ``device`` (default ``"cuda"``; pass
    ``device="cpu"`` on a machine without a card)."""

    def __init__(self, charge_cpu, lam=1.0, dx=1.0, xy=False, method="auto",
                 device="cuda"):
        c = np.asarray(charge_cpu)
        if xy:
            c = c.T
        self.lam = lam
        self.dx = dx
        self.method = spectral_method(method)
        self.device = resolve_device(device)
        self.charge = torch.tensor(c, device=self.device).to(torch.complex64)
        ny, nx = self.charge.shape
        (self.rescaling, self.xgrad_rescale,
         self.ygrad_rescale) = _multipliers(ny, nx, lam, dx, self.device)
        self.xgrad = None
        self.ygrad = None

    # -- reference API --------------------------------------------------------
    def create_grad_fields(self):
        self.xgrad = self.charge + 0
        self.ygrad = self.charge + 0

    def fft_and_screen(self):
        """In the reference this leaves ``charge`` holding the *screened
        spectrum* (``screened_poisson.py:50-55``)."""
        self.charge = torch.fft.fft2(self.charge) * self.rescaling

    def inverse_fft(self):
        self.charge = torch.fft.ifft2(self.charge)

    def update_grad_fields(self):
        """Requires :meth:`fft_and_screen` first (charge = screened
        spectrum)."""
        self.xgrad = torch.fft.ifft2(self.charge * self.xgrad_rescale)
        self.ygrad = torch.fft.ifft2(self.charge * self.ygrad_rescale)

    def solve_and_update_grad_fields(self):
        self.fft_and_screen()
        self.update_grad_fields()

    def set_charge(self, charge, xy=False):
        c = (charge.to(self.device) if isinstance(charge, torch.Tensor)
             else torch.tensor(np.asarray(charge), device=self.device))
        if xy:
            c = c.T
        self.charge = c.to(torch.complex64)
