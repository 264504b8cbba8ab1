"""The plain reference of ``porous_two_fluid`` (BASELINE config 5): the
porous two-fluid Shan-Chen step with the screened-Poisson repulsion
(``single_component.py``, ``multi.py:488-511``) in plain PyTorch, in the
dtype of the state it is given (float64 for the check, bfloat16 for the
control).

A frozen copy written for the benchmark, for this configuration only; it
imports nothing of ``lb2d_tpu_torch``, ``lb2d_tpu`` or ``jax``, and takes
the deployment's parameters from ``lbbench/configs/porous_two_fluid.py``.
Departures from the port's plain step (``ops/fused_mc.py::
mc_step_reference`` and ``ops/spectral.py::screened_gradients_reference``):

* the hooks this configuration does not register (constant and radial
  forces, collisions, zero-gradient edges, the second belt, the other
  pseudopotentials) are left out;
* the screened solve runs in complex128 for a float64 state (the port
  solves in complex64 whatever the state); ``torch.fft`` has no bfloat16,
  so for a bfloat16 state it solves in complex64 and rounds the force to
  bfloat16;
* the screen's ``lam2`` and amplitude are not rounded to float32;
* the BGK, equilibrium and Guo terms are applied one direction at a time,
  in place; sums add in any order.
"""

import math

import numpy as np
import torch

from lbbench.configs import porous_two_fluid as deployment

W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
CS2 = 1.0 / 3.0

SNAPSHOT_GROUPS = {"rho_win": ("rho0", "rho1")}
# the planes the program holds after an interval, compared together
HELD_GROUPS = {"force_win": ("fx", "fy")}


def initial_state(mix, inputs, dtype, device) -> torch.Tensor:
    """``f[9, 2, ny, nx]``: each fluid's equilibrium at rest of its density,
    ``base`` for fluid 0 and ``1 - base`` for fluid 1 (the barycentric
    velocity is 0 before the first step)."""
    base = inputs["base"].to(device=device, dtype=torch.float64)
    rho = torch.stack((base, 1.0 - base))
    w = torch.tensor(W, dtype=torch.float64, device=device)
    return (w[:, None, None, None] * rho[None]).to(dtype)


def _stream(f):
    out = torch.empty_like(f)
    for j in range(9):
        out[j] = torch.roll(f[j], shifts=(CY[j], CX[j]), dims=(-2, -1))
    return out


def _shifted(field, cx, cy):
    """``field(x + c)`` with periodic wrap."""
    return torch.roll(field, shifts=(-cy, -cx), dims=(-2, -1))


def screened_force(rho, lam2, amplitude):
    """``amplitude (d/dx, d/dy)`` of the screened density: ``rho`` through
    ``1 / (lam2 |k|^2 + 1)`` with integer wave numbers ``k`` and the
    gradients' multipliers ``2 pi k`` with the Nyquist bin of an even
    length zeroed (``waves.py:218-235, 311-315``)."""
    ny, nx = rho.shape
    ctype = torch.complex128 if rho.dtype == torch.float64 else torch.complex64
    rtype = torch.float64 if rho.dtype == torch.float64 else torch.float32
    dev = rho.device

    def freqs(n):
        k = torch.fft.fftfreq(n, d=1.0 / n, dtype=rtype, device=dev)
        g = k.clone()
        if n % 2 == 0:
            g[n // 2] = 0.0
        return k, g

    kx, gx = freqs(nx)
    ky, gy = freqs(ny)
    screen = 1.0 / (lam2 * (kx[None, :] ** 2 + ky[:, None] ** 2) + 1.0)
    chat = torch.fft.fft2(rho.to(rtype).to(ctype)) * screen
    ax = (2 * math.pi) * gx[None, :]
    ay = (2 * math.pi) * gy[:, None]
    g = torch.fft.ifft2(chat * (1j * ax) + 1j * (chat * (1j * ay)))
    return (amplitude * g.real).to(rho.dtype), (amplitude * g.imag).to(
        rho.dtype)


def moments(f):
    """Per fluid ``rho``, ``jx``, ``jy`` of ``f[9, 2, ...]``."""
    rho = f.sum(dim=0)
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return rho, jx, jy


def step(f):
    """One step of config 5. Returns a new tensor."""
    d = deployment
    f = _stream(f)
    rho, jx, jy = moments(f)
    good = rho > d.ZERO_DENSITY
    safe = torch.where(good, rho, 1.0)
    u = torch.where(good, jx / safe, 0.0)
    v = torch.where(good, jy / safe, 0.0)

    # the hooks in registration order: Shan-Chen, then the screened force
    rho0 = d.PSI[1][0]
    psi = rho0 * (1 - torch.exp(-rho / rho0))
    sx = torch.zeros_like(rho)
    sy = torch.zeros_like(rho)
    for j in range(1, 9):   # the D2Q9 moving vectors (first belt)
        other = _shifted(psi.flip(0), CX[j], CY[j])  # the other fluid's psi
        if CX[j]:
            sx += (W[j] * CX[j]) * other
        if CY[j]:
            sy += (W[j] * CY[j]) * other
    gx = torch.where(good, -d.G_INT * psi * sx / safe, 0.0)
    gy = torch.where(good, -d.G_INT * psi * sy / safe, 0.0)
    del psi, sx, sy
    fx, fy = screened_force(rho[0], d.SCREEN_LENGTH ** 2, d.SCREEN_AMPLITUDE)
    gx[1] += fx
    gy[1] += fy
    del fx, fy

    # Darcy and Forchheimer drag (update_forces_pourous), the last force
    eps, nuf, K, Fe = (d.FLUID[k] for k in ("epsilon", "nu_fluid", "K", "Fe"))
    speed = torch.sqrt(u * u + v * v)
    gx = torch.where(good, gx * eps - (eps * nuf / K) * u
                     - (eps * Fe / math.sqrt(K)) * speed * u, 0.0)
    gy = torch.where(good, gy * eps - (eps * nuf / K) * v
                     - (eps * Fe / math.sqrt(K)) * speed * v, 0.0)
    del speed, u, v, good, safe

    # barycentric velocity with the half force
    rho_tot = rho.sum(dim=0)
    ub = (jx.sum(dim=0) + (rho * gx).sum(dim=0) / 2) / rho_tot
    vb = (jy.sum(dim=0) + (rho * gy).sum(dim=0) / 2) / rho_tot
    del jx, jy, rho_tot
    usq = ub * ub + vb * vb
    uf = gx * ub + gy * vb                     # per fluid
    omega = 1.0 / (0.5 + d.FLUID["nu_e"] / CS2)
    for j in range(9):
        cu = CX[j] * ub + CY[j] * vb
        cf = CX[j] * gx + CY[j] * gy           # per fluid
        feq = W[j] * rho * (1.0 + cu / CS2 + cu * cu / (2 * CS2 * CS2 * eps)
                            - usq / (2 * CS2 * eps))
        guo = W[j] * rho * (1 - 0.5 * omega) * (
            cf / CS2 + cf * cu / (CS2 * CS2 * eps) - uf / (CS2 * eps))
        f[j] += omega * (feq - f[j]) + guo
    return f


def held(f, mix) -> dict:
    """The screened-Poisson force that the step from ``f`` applies, and
    that the program holds after it (K8's planes of an interval's last
    step): ``screened_force`` of fluid 0's density after streaming."""
    d = deployment
    rho0 = sum(torch.roll(f[j, 0], shifts=(CY[j], CX[j]), dims=(-2, -1))
               for j in range(9))
    fx, fy = screened_force(rho0, d.SCREEN_LENGTH ** 2, d.SCREEN_AMPLITUDE)
    return {"fx": fx, "fy": fy}


def advance(f, mix, steps):
    """``steps`` plain steps of ``f`` in its dtype."""
    for _ in range(steps):
        f = step(f)
    return f


def monitor(f, mix) -> np.ndarray:
    """``conservation_report``'s sums: of all populations, and of the
    densities."""
    return np.array([float(f.sum()), float(f.sum(dim=0).sum())])


def snapshot(f, mix) -> dict:
    rho = f.sum(dim=0)
    return {"rho0": rho[0], "rho1": rho[1]}
