"""The plain reference of ``pipe_flow``: the pressure-driven D2Q9 channel of
the reference's ``opencl_dim.py`` (``Pipe_Flow``, ``Pipe_Flow_Cylinder``)
in plain PyTorch, in the dtype of the state it is given (float64 for the
check, bfloat16 for the control).

A frozen copy written for the benchmark; it imports nothing of
``lb2d_tpu_torch``, ``lb2d_tpu`` or ``jax``, and takes the seeded inputs'
standing waves from ``lbbench/configs/pipe_flow.py``. Departures from the
port's plain ops (``ops/fused.py::pipe_step_reference`` and what it
calls):

* the units, grid, boundary densities and the cylinder's mask are worked
  out here again from the mix's physical parameters (W convention,
  diffusive scaling) in float64; the steps then take ``omega`` and the two
  boundary densities rounded to float32, the precision the configuration
  states (the port holds its scalars so), and compute in the state's
  dtype. With the exact values the 4096^2 channel's density drop, 1.8e-7,
  would not be float32's (the nearest is 2.4e-7), and its velocities,
  which that drop drives, would differ by ~10% for any float32 program;
* the Zou-He edge values are computed from slices of the streamed state
  and written in place (the port clones the whole state first); the
  formulas are the same (``D2Q9.cl:173-261``);
* BGK as ``f + omega (feq - f)`` one direction at a time (the port:
  ``f (1 - omega) + omega feq`` on all nine);
* the moments in float64 add in any order (the port adds in direction
  order so that blocks of rows give the grid's bits).
"""

import math

import numpy as np
import torch

from lbbench.configs import pipe_flow as deployment

W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
CS2 = 1.0 / 3.0
PERTURBATION = 0.001    # the program's initial perturbation (opencl_dim.py:318-321)

# the snapshot's fields compared together, under each number's name
SNAPSHOT_GROUPS = {"rho_win": ("rho",), "uv_win": ("u", "v")}


def units(mix) -> dict:
    """Grid, relaxation rate, boundary densities and obstacle of the mix
    (``opencl_dim.py:64-120, 186-201, 266-276, 441-518``)."""
    p = mix["physical"]
    N = int(p["N"])
    cyl = mix.get("cylinder") if mix["model"] == "PipeFlowCylinder" else None
    L = cyl["radius"] if cyl else p["diameter"]
    zeta = abs(p["pressure_grad"]) / p["rho"]
    T = math.sqrt(L / zeta)
    w_number = zeta * L * T / p["viscosity"]
    dx = 1.0 / N
    dt = dx * dx
    nu_lb = (dt / dx ** 2) / w_number
    omega = 1.0 / (nu_lb / CS2 + 0.5)
    lx = int(math.ceil((p["pipe_length"] / L) * N))
    ly = int(math.ceil((p["diameter"] / L) * N)) if cyl else N
    nx, ny = lx + 1, ly + 1
    rho_in = 1.0 + abs(nx * (dt ** 2 / dx) * (1.0 / CS2))
    mask = None
    if cyl:
        cx, cy = N * cyl["center"][0] / L, N * cyl["center"][1] / L
        X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
        mask = (X - cx) ** 2 + (Y - cy) ** 2 <= N ** 2
    return {"nx": nx, "ny": ny, "omega": omega, "rho_in": rho_in,
            "rho_out": 1.0, "mask": mask}


def initial_state(mix, inputs, dtype, device) -> torch.Tensor:
    """The equilibrium at rest of the inlet-to-outlet density ramp times,
    for the mix's ``initial`` ``"density_waves"``, ``1 + amplitude s`` with
    the standing waves ``s`` of the seeded inputs (``configs/pipe_flow.py``'s
    ``wave_field``), or, for ``"program"``, ``1 + 0.001 randn`` per
    population, randn drawn from ``np.random.RandomState(seed)`` as the
    program draws it; worked out in float64 and rounded to ``dtype``."""
    u = units(mix)
    ny, nx = u["ny"], u["nx"]
    ramp = u["rho_in"] - torch.arange(nx, dtype=torch.float64,
                                      device=device) * (
        (u["rho_in"] - u["rho_out"]) / nx)
    if mix["initial"]["kind"] == "density_waves":
        rho = ramp[None, :] * (1.0 + mix["initial"]["amplitude"]
                               * deployment.wave_field(mix, inputs, ny, nx,
                                                       device))
        w = torch.tensor(W, dtype=torch.float64, device=device)
        return (w[:, None, None] * rho[None]).to(dtype)
    rng = np.random.RandomState(inputs["seed"])
    perturb = (1.0 + PERTURBATION * rng.randn(9, ny, nx)).astype(np.float32)
    f = torch.from_numpy(perturb).to(device=device, dtype=torch.float64)
    for j in range(9):
        f[j] *= W[j] * ramp[None, :]
    return f.to(dtype)


def _stream(f):
    out = torch.empty_like(f)
    for j in range(9):
        out[j] = torch.roll(f[j], shifts=(CY[j], CX[j]), dims=(0, 1))
    return out


def _pressure_bcs(f, rho_in, rho_out):
    """Zou-He pressure inlet (x = 0) and outlet (x = nx - 1), bounce-back
    walls (y = 0, ny - 1) and the four corners, on the streamed state, in
    place; every formula reads the streamed values."""
    def col(x):
        return [f[j, 1:-1, x].clone() for j in range(9)]

    new = []
    s = col(0)
    u_in = -((s[0] + s[2] + 2 * s[3] + s[4] + 2 * s[6] + 2 * s[7] - rho_in)
             / rho_in)
    new += [((1, slice(1, -1), 0), s[3] + (2 / 3) * rho_in * u_in),
            ((5, slice(1, -1), 0),
             -0.5 * s[2] + 0.5 * s[4] + s[7] + (1 / 6) * u_in * rho_in),
            ((8, slice(1, -1), 0),
             0.5 * s[2] - 0.5 * s[4] + s[6] + (1 / 6) * u_in * rho_in)]
    s = col(-1)
    u_out = -1.0 + (s[0] + 2 * s[1] + s[2] + s[4] + 2 * s[5] + 2 * s[8]) \
        / rho_out
    new += [((3, slice(1, -1), -1), s[1] - (2 / 3) * rho_out * u_out),
            ((6, slice(1, -1), -1),
             -0.5 * s[2] + 0.5 * s[4] + s[8] - (1 / 6) * u_out * rho_out),
            ((7, slice(1, -1), -1),
             0.5 * s[2] - 0.5 * s[4] + s[5] - (1 / 6) * u_out * rho_out)]
    s = [f[j, -1, 1:-1].clone() for j in range(9)]      # north wall
    new += [((4, -1, slice(1, -1)), s[2]),
            ((8, -1, slice(1, -1)), 0.5 * (-s[1] + s[3] + 2 * s[6])),
            ((7, -1, slice(1, -1)), 0.5 * (s[1] - s[3] + 2 * s[5]))]
    s = [f[j, 0, 1:-1].clone() for j in range(9)]       # south wall
    new += [((2, 0, slice(1, -1)), s[4]),
            ((6, 0, slice(1, -1)), 0.5 * (s[1] - s[3] + 2 * s[8])),
            ((5, 0, slice(1, -1)), 0.5 * (-s[1] + s[3] + 2 * s[7]))]
    c = [f[j, 0, 0].clone() for j in range(9)]          # bottom inlet
    d = 0.5 * (-c[0] - 2 * c[3] - 2 * c[4] - 2 * c[7] + rho_in)
    new += [((1, 0, 0), c[3]), ((2, 0, 0), c[4]), ((5, 0, 0), c[7]),
            ((6, 0, 0), d), ((8, 0, 0), d)]
    c = [f[j, -1, 0].clone() for j in range(9)]         # top inlet
    d = 0.5 * (-c[0] - 2 * c[2] - 2 * c[3] - 2 * c[6] + rho_in)
    new += [((1, -1, 0), c[3]), ((4, -1, 0), c[2]), ((8, -1, 0), c[6]),
            ((5, -1, 0), d), ((7, -1, 0), d)]
    c = [f[j, 0, -1].clone() for j in range(9)]         # bottom outlet
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[4] - 2 * c[8] + rho_out)
    new += [((3, 0, -1), c[1]), ((2, 0, -1), c[4]), ((6, 0, -1), c[8]),
            ((5, 0, -1), d), ((7, 0, -1), d)]
    c = [f[j, -1, -1].clone() for j in range(9)]        # top outlet
    d = 0.5 * (-c[0] - 2 * c[1] - 2 * c[2] - 2 * c[5] + rho_out)
    new += [((3, -1, -1), c[1]), ((4, -1, -1), c[2]), ((7, -1, -1), c[5]),
            ((6, -1, -1), d), ((8, -1, -1), d)]
    for idx, value in new:
        f[idx] = value
    return f


def moments(f):
    rho = f.sum(dim=0)
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    return rho, jx / rho, jy / rho


def step(f, u, mask=None):
    """One step: stream, pressure BCs, obstacle bounce-back, BGK with the
    quadratic equilibrium. Returns a new tensor."""
    f = _pressure_bcs(_stream(f), u["rho_in"], u["rho_out"])
    if mask is not None:
        f = torch.where(mask[None], f[list(OPP)], f)
    rho, ux, uy = moments(f)
    usq = ux * ux + uy * uy
    omega = u["omega"]
    for j in range(9):
        cu = CX[j] * ux + CY[j] * uy
        feq = W[j] * rho * (1.0 + cu / CS2 + cu * cu / (2 * CS2 * CS2)
                            - usq / (2 * CS2))
        f[j] += omega * (feq - f[j])
    return f


def float32_scalars(u) -> dict:
    """``u`` with ``omega`` and the boundary densities rounded to float32."""
    return dict(u, **{k: float(np.float32(u[k]))
                      for k in ("omega", "rho_in", "rho_out")})


def advance(f, mix, steps):
    """``steps`` plain steps of ``f`` in its dtype."""
    u = float32_scalars(units(mix))
    mask = (None if u["mask"] is None
            else torch.from_numpy(u["mask"]).to(f.device))
    for _ in range(steps):
        f = step(f, u, mask)
    return f


def monitor(f, mix) -> np.ndarray:
    """The monitoring readout: the Mach number max |u| / cs, or the ``u``
    profile across the channel at mid-length."""
    _, ux, uy = moments(f)
    if mix["monitor"] == "mach":
        ma = torch.sqrt(torch.max(ux * ux + uy * uy)) / math.sqrt(CS2)
        return np.array([float(ma)])
    return ux[:, f.shape[-1] // 2].double().cpu().numpy()


def snapshot(f, mix) -> dict:
    rho, ux, uy = moments(f)
    return {"rho": rho, "u": ux, "v": uy}
