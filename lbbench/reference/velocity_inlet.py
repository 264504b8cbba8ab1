"""The plain reference of ``velocity_inlet``: the reference's lattice-units
velocity-inlet channel (``OLD/opencl.py:281-375``, ``D2Q9.cl:263-321``)
with an obstacle, in plain PyTorch, in the dtype of the state it is given
(float64 for the check, bfloat16 for the control).

One step: stream, periodic on both axes; the Zou-He velocity inlet at u_w
on the whole west column (the wrap-compatible form, DIVERGENCES.md #20);
the zero-gradient outlet, populations 3, 6 and 7 of the east column copied
from column nx - 2 after the inlet's write (DIVERGENCES.md #21); full
bounce-back inside the mask; the compressible moments, u and v zero inside
the mask (``OLD/opencl.py:346-360``); the quadratic equilibrium and BGK.

A frozen copy written for the benchmark; it imports nothing of
``lb2d_tpu_torch``, ``lb2d_tpu`` or ``jax``, takes the lattice, streaming,
moments and Mach readout of ``reference/pipe_flow.py`` and the seeded
standing waves from ``configs/pipe_flow.py``. Departures from the port's
``ops/fused.py::velocity_step_reference``:

* the grid and the disk's mask are worked out here again from the mix;
  the steps take omega and u_w rounded to float32, the precision the
  configuration states (the port holds its scalars so), and compute in
  the state's dtype;
* the inlet's and outlet's values are computed from slices of the
  streamed state and written in place (the port clones the whole state
  first); the formulas are the same (``D2Q9.cl:291-296``);
* BGK as ``f + omega (feq - f)`` one direction at a time (the port:
  ``f (1 - omega) + omega feq`` on all nine);
* the moments in float64 add in any order (the port adds in direction
  order so that blocks of rows give the grid's bits);
* the zero-gradient outlet and the compressible equilibrium only (the
  port also has the velocity outlet and the He-Luo equilibrium).
"""

import numpy as np
import torch

from lbbench.configs import pipe_flow as deployment
from lbbench.reference.pipe_flow import (  # noqa: F401
    CS2, CX, CY, OPP, W, _stream, moments, monitor)

# the snapshot's fields compared together, under each number's name
SNAPSHOT_GROUPS = {"rho_win": ("rho",), "uv_win": ("u", "v")}


def units(mix) -> dict:
    """Grid, relaxation rate, inlet velocity and obstacle of the mix."""
    lat = mix["lattice"]
    if lat["outlet"] != "zero_gradient":
        raise ValueError(f"no outlet {lat['outlet']!r} in the reference")
    nx, ny = int(lat["lx"]) + 1, int(lat["ly"]) + 1
    obs = mix["obstacle"]
    X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
    r = obs["diameter"] / 2
    mask = (X - obs["center"][0]) ** 2 + (Y - obs["center"][1]) ** 2 <= r * r
    return {"nx": nx, "ny": ny, "omega": float(lat["omega"]),
            "u_w": float(lat["u_w"]), "mask": mask}


def float32_scalars(u) -> dict:
    """``u`` with ``omega`` and ``u_w`` rounded to float32."""
    return dict(u, **{k: float(np.float32(u[k])) for k in ("omega", "u_w")})


def _feq(rho, ux, uy):
    """The quadratic equilibrium, direction by direction."""
    usq = ux * ux + uy * uy
    out = []
    for j in range(9):
        cu = CX[j] * ux + CY[j] * uy
        out.append(W[j] * rho * (1.0 + cu / CS2 + cu * cu / (2 * CS2 * CS2)
                                 - usq / (2 * CS2)))
    return out


def initial_state(mix, inputs, dtype, device) -> torch.Tensor:
    """The plug flow ``feq(rho, u_w, 0)`` of ``rho = 1 + amplitude s``, the
    standing waves ``s`` of the seeded inputs (``configs/pipe_flow.py``'s
    ``wave_field``), u_w rounded to float32; worked out in float64 and
    rounded to ``dtype``."""
    u = float32_scalars(units(mix))
    rho = 1.0 + mix["initial"]["amplitude"] * deployment.wave_field(
        mix, inputs, u["ny"], u["nx"], device)
    ux = torch.full_like(rho, u["u_w"])
    return torch.stack(_feq(rho, ux, torch.zeros_like(rho))).to(dtype)


def _inlet(f, u_w):
    """The Zou-He velocity inlet on the whole west column, in place, from
    the streamed values (``D2Q9.cl:291-296``)."""
    s = [f[j, :, 0].clone() for j in range(9)]
    rho_w = (s[0] + s[2] + s[4] + 2 * (s[3] + s[6] + s[7])) / (1.0 - u_w)
    f[1, :, 0] = s[3] + (2 / 3) * rho_w * u_w
    f[5, :, 0] = s[7] - 0.5 * (s[2] - s[4]) + (1 / 6) * rho_w * u_w
    f[8, :, 0] = s[6] + 0.5 * (s[2] - s[4]) + (1 / 6) * rho_w * u_w


def _outlet(f):
    """The zero-gradient outlet, in place: populations 3, 6, 7 of the east
    column from column nx - 2, read after the inlet's write."""
    for j in (3, 6, 7):
        f[j, :, -1] = f[j, :, -2]


def _collide(f, omega, mask=None):
    """Bounce-back inside ``mask``, the moments with u and v zero there,
    and BGK with the quadratic equilibrium, in place where there is no
    mask."""
    if mask is not None:
        f = torch.where(mask[None], f[list(OPP)], f)
    rho, ux, uy = moments(f)
    if mask is not None:
        ux = torch.where(mask, 0.0, ux)
        uy = torch.where(mask, 0.0, uy)
    for j, feq in enumerate(_feq(rho, ux, uy)):
        f[j] += omega * (feq - f[j])
    return f


def step(f, u, mask=None):
    """One step: stream, velocity inlet, zero-gradient outlet, obstacle
    bounce-back, BGK. Returns a new tensor."""
    f = _stream(f)
    _inlet(f, u["u_w"])
    _outlet(f)
    return _collide(f, u["omega"], mask)


def advance(f, mix, steps):
    """``steps`` plain steps of ``f`` in its dtype."""
    u = float32_scalars(units(mix))
    mask = torch.from_numpy(u["mask"]).to(f.device)
    for _ in range(steps):
        f = step(f, u, mask)
    return f


def snapshot(f, mix) -> dict:
    rho, ux, uy = moments(f)
    return {"rho": rho, "u": ux, "v": uy}
