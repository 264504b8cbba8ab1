"""The flow update in its products form, emulated on the CPU.

Every flow kernel (K1, K2's sweep and 32 x 32 tiles, K3, K9) runs
``pipe_cell.cuh::collide``, which multiplies by 3, 4.5 and 1.5 where the
plain step divides by float32's cs2, 2 cs2 cs2 and 2 cs2. The kernels run
only on the card; here the update is written out in float32 torch, one
operation per kernel operation, without the FMAs nvcc may contract: the
stream; the Zou-He pressure inlet and outlet, the walls and corners
(``cell_update``), or the Zou-He velocity inlet with the zero-gradient or
the velocity outlet, periodic in y (``velocity_cell_update``);
bounce-back inside an obstacle; the moments in direction order; the
equilibrium (quadratic, or He-Luo with the velocity zeroed in the
obstacle; the velocity inlet's compressible moments with the velocity
zeroed there) with opposite directions paired; and BGK. Nothing of the
package computes it.

The products form is held to the plain step (``ops/fused.py``) within the
card tests' 1e-6 after 1 and 9 steps, on a 254x382 state with and without
an obstacle, for both equilibria of the pressure-driven flow and both
outlets of the velocity inlet (from its perturbed plug flow, and the
zero-gradient outlet also from the pressure-driven flow's state). Against
a float64 plain step from the same float32 state, it is held to the same
emulation in the division form, which in turn equals the plain float32
step bit for bit (so the emulation is the plain step's arithmetic): its
RMS error within 2% of the division form's in every case (they agree
within 1%), its largest error no larger for the pressure-driven flow and
within 1.2 times for the velocity inlet. Which form has the larger maximum
changes with the state and the step count (up to 1.37 times either way at
5 steps), so the cases pin 1 and 9 steps.
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.ops.fused import (pipe_run_reference,
                                     velocity_step_reference)

torch.set_num_threads(1)

NY, NX = 254, 382
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
F32 = np.float32
W = (F32(4.0 / 9.0), F32(1.0 / 9.0), F32(1.0 / 9.0), F32(1.0 / 9.0),
     F32(1.0 / 9.0), F32(1.0 / 36.0), F32(1.0 / 36.0), F32(1.0 / 36.0),
     F32(1.0 / 36.0))
CS2 = F32(1.0 / 3.0)
TWO_CS4 = F32(F32(2.0) * CS2) * CS2
TWO_CS2 = F32(2.0) * CS2
# float32 values, so that the float64 step runs the same parameters
OMEGA, RIN, ROUT = float(F32(1.7)), float(F32(1.03)), float(F32(0.99))
U_W = float(F32(0.05))  # the velocity inlet's u_w and u_e
TOL = 1e-6  # tests/test_torch_kernel_cuda.py's, after up to 9 steps


def _c(x):
    """A float32 scalar as a 0-d tensor: every product rounds to float32."""
    return torch.tensor(x, dtype=torch.float32)


def _pull(f):
    """s_j[y, x] = f[j, y - cy_j, x - cx_j], periodic."""
    return [torch.roll(f[j], shifts=(CY[j], CX[j]), dims=(0, 1))
            for j in range(9)]


def _bcs(s, incomp):
    """Zou-He pressure inlet and outlet, walls and corners of
    ``pipe_cell.cuh::apply_bcs`` on the pulled planes ``s``, each formula
    reading only ``s``."""
    st = [p.clone() for p in s]
    rin, rout = _c(RIN), _c(ROUT)
    third, sixth, two3 = _c(1.0 / 3.0), _c(1.0 / 6.0), _c(2.0 / 3.0)
    i, o, r = 0, -1, slice(1, -1)  # inlet, outlet column; inner rows
    a = [p[r, i] for p in s]
    b = [p[r, o] for p in s]
    if incomp:
        u_in = -a[0] - a[2] - 2 * a[3] - a[4] - 2 * a[6] - 2 * a[7] + rin
        st[1][r, i] = third * (3 * a[3] + 2 * u_in)
        st[5][r, i] = sixth * (-3 * a[2] + 3 * a[4] + 6 * a[7] + u_in)
        st[8][r, i] = sixth * (3 * a[2] - 3 * a[4] + 6 * a[6] + u_in)
        u_out = b[0] + 2 * b[1] + b[2] + b[4] + 2 * b[5] + 2 * b[8] - rout
        st[3][r, o] = third * (3 * b[1] - 2 * u_out)
        st[6][r, o] = sixth * (-3 * b[2] + 3 * b[4] + 6 * b[8] - u_out)
        st[7][r, o] = sixth * (3 * b[2] - 3 * b[4] + 6 * b[5] - u_out)
    else:
        u_in = -((a[0] + a[2] + 2 * a[3] + a[4] + 2 * a[6] + 2 * a[7] - rin)
                 / rin)
        st[1][r, i] = a[3] + two3 * rin * u_in
        st[5][r, i] = -0.5 * a[2] + 0.5 * a[4] + a[7] + sixth * u_in * rin
        st[8][r, i] = 0.5 * a[2] - 0.5 * a[4] + a[6] + sixth * u_in * rin
        u_out = -1.0 + (b[0] + 2 * b[1] + b[2] + b[4] + 2 * b[5]
                        + 2 * b[8]) / rout
        st[3][r, o] = b[1] - two3 * rout * u_out
        st[6][r, o] = -0.5 * b[2] + 0.5 * b[4] + b[8] - sixth * u_out * rout
        st[7][r, o] = 0.5 * b[2] - 0.5 * b[4] + b[5] - sixth * u_out * rout
    c = slice(1, -1)  # the walls without the corners
    n = [p[-1, c] for p in s]
    st[4][-1, c] = n[2]
    st[8][-1, c] = 0.5 * (-n[1] + n[3] + 2 * n[6])
    st[7][-1, c] = 0.5 * (n[1] - n[3] + 2 * n[5])
    q = [p[0, c] for p in s]
    st[2][0, c] = q[4]
    st[6][0, c] = 0.5 * (q[1] - q[3] + 2 * q[8])
    st[5][0, c] = 0.5 * (-q[1] + q[3] + 2 * q[7])
    corners = (  # (row, column, density, {direction: source or None = d})
        (0, i, (0, 3, 4, 7), rin, {1: 3, 2: 4, 5: 7, 6: None, 8: None}),
        (-1, i, (0, 2, 3, 6), rin, {1: 3, 4: 2, 8: 6, 5: None, 7: None}),
        (0, o, (0, 1, 4, 8), rout, {3: 1, 2: 4, 6: 8, 5: None, 7: None}),
        (-1, o, (0, 1, 2, 5), rout, {3: 1, 4: 2, 7: 5, 6: None, 8: None}))
    for y, x, (j0, j1, j2, j3), rho, rule in corners:
        v = [p[y, x] for p in s]
        d = 0.5 * (-v[j0] - 2 * v[j1] - 2 * v[j2] - 2 * v[j3] + rho)
        for j, src in rule.items():
            st[j][y, x] = d if src is None else v[src]
    return st


def _velocity_bcs(s, outlet):
    """The Zou-He velocity inlet on the whole column x = 0 and the
    zero-gradient or the velocity outlet on x = nx - 1 of
    ``pipe_cell.cuh::apply_velocity_bcs``, each formula reading only the
    pulled planes ``s``."""
    st = [p.clone() for p in s]
    uw = _c(U_W)
    two3, sixth = _c(2.0 / 3.0), _c(1.0 / 6.0)
    a = [p[:, 0] for p in s]
    rho_w = (1.0 / (1.0 - uw)) * (a[0] + a[2] + a[4]
                                  + 2.0 * (a[3] + a[6] + a[7]))
    st[1][:, 0] = a[3] + two3 * rho_w * uw
    st[5][:, 0] = a[7] - 0.5 * (a[2] - a[4]) + sixth * rho_w * uw
    st[8][:, 0] = a[6] + 0.5 * (a[2] - a[4]) + sixth * rho_w * uw
    if outlet == "velocity":
        b = [p[:, -1] for p in s]
        rho_e = (1.0 / (1.0 + uw)) * (b[0] + b[2] + b[4]
                                      + 2.0 * (b[1] + b[5] + b[8]))
        st[3][:, -1] = b[1] - two3 * rho_e * uw
        st[6][:, -1] = b[5] + 0.5 * (b[2] - b[4]) - sixth * rho_e * uw
        st[7][:, -1] = b[8] - 0.5 * (b[2] - b[4]) - sixth * rho_e * uw
    else:  # what the upstream cell (y, nx - 2) pulled
        for j in (3, 6, 7):
            st[j][:, -1] = s[j][:, -2]
    return st


def _collide(st, incomp, zero, products):
    """``pipe_cell.cuh::collide``, in the products form or the division
    form: He-Luo moments and equilibrium with ``incomp``, the velocity
    zeroed where ``zero`` (or nowhere, None)."""
    rho = st[0]
    for j in range(1, 9):
        rho = rho + st[j]
    jx = st[1] - st[3] + st[5] - st[6] - st[7] + st[8]
    jy = st[2] - st[4] + st[5] + st[6] - st[7] - st[8]
    if incomp:
        u, v = jx, jy
    else:
        inv = 1.0 / rho
        u, v = jx * inv, jy * inv
    if zero is not None:
        u = torch.where(zero, 0.0, u)
        v = torch.where(zero, 0.0, v)
    omega = _c(OMEGA)
    A = 1.0 - omega
    usq = (u * u + v * v) * 1.5 if products else (u * u + v * v) / _c(TWO_CS2)
    cu = [None, u, v, -u, -v, u + v, -u + v, -u - v, u - v]
    lin, sq = [None] * 9, [None] * 9
    for j in (1, 2, 5, 6):
        if products:
            lin[j] = cu[j] * 3.0
            sq[j] = (cu[j] * cu[j]) * 4.5
        else:
            lin[j] = cu[j] / _c(CS2)
            sq[j] = (cu[j] * cu[j]) / _c(TWO_CS4)
        lin[OPP[j]], sq[OPP[j]] = -lin[j], sq[j]
    out = []
    for j in range(9):
        w = _c(W[j])
        base = rho if incomp else 1.0
        # c_0 = 0: its lin and sq are exact zeros
        inner = base - usq if j == 0 else base + lin[j] + sq[j] - usq
        feq = w * inner if incomp else w * rho * inner
        out.append(st[j] * A + omega * feq)
    return torch.stack(out)


def emulate(f, n, physics, mask, products):
    """``n`` steps of the flow update of ``physics`` (a key of PHYSICS) on
    float32 ``f [9, ny, nx]``."""
    solid = None if mask is None else mask.bool()
    incomp = physics == "incompressible"
    outlet = PHYSICS[physics]
    for _ in range(n):
        s = _pull(f)
        st = _bcs(s, incomp) if outlet is None else _velocity_bcs(s, outlet)
        if solid is not None:
            st = [torch.where(solid, st[OPP[j]], st[j]) for j in range(9)]
        # the pressure-driven compressible step keeps the velocity in the
        # obstacle
        zero = None if physics == "compressible" else solid
        f = _collide(st, incomp, zero, products)
    return f


def _state(obstacle, plug=False):
    """A float32 state near equilibrium with speeds up to ~0.08 (so the
    quadratic terms are far above rounding), or with ``plug`` the velocity
    inlet's own start, the plug flow u = U_W (the model's, PipeFlowVelocity
    Inlet._init_state), each with 1% noise; and a disk."""
    rng = np.random.RandomState(23)
    y, x = np.mgrid[0:NY, 0:NX] / np.array([NY, NX])[:, None, None]
    rho = 1.0 + 0.02 * np.cos(2 * np.pi * (3 * x + 2 * y) + rng.rand() * 6)
    u = 0.05 + 0.03 * np.sin(2 * np.pi * (2 * x - y) + rng.rand() * 6)
    v = 0.04 * np.cos(2 * np.pi * (x + 4 * y) + rng.rand() * 6)
    if plug:
        rho, u, v = np.ones_like(x), np.full_like(x, U_W), np.zeros_like(x)
    cx = np.array(CX, np.float64)[:, None, None]
    cy = np.array(CY, np.float64)[:, None, None]
    w = np.array([float(a) for a in W])[:, None, None]
    cu = cx * u + cy * v
    feq = w * rho * (1 + 3 * cu + 4.5 * cu**2 - 1.5 * (u * u + v * v))
    f = feq * (1 + 0.01 * rng.randn(9, NY, NX))
    mask = None
    if obstacle:
        yy, xx = np.mgrid[0:NY, 0:NX]
        mask = torch.tensor(((xx - 90) ** 2 + (yy - 120) ** 2 <= 30 ** 2)
                            .astype(np.int32))
    return torch.tensor(f, dtype=torch.float32), mask


# physics -> the velocity inlet's outlet, None for the pressure-driven flow
PHYSICS = {"compressible": None, "incompressible": None,
           "inlet-zero_gradient": "zero_gradient",
           "inlet-velocity_outlet": "velocity"}
# physics -> the states it starts from: the velocity inlet's plug flow
# ("plug") and the pressure-driven flow's state ("flow"). The velocity
# outlet, which is linearly unstable (DIVERGENCES.md #21), takes the flow
# state's mismatched outlet speeds to a blow-up within 12 steps (the
# float32 plain step 2.7e-4 from the float64 one after 9), so it starts
# from the plug flow only.
STARTS = {"compressible": ("flow",), "incompressible": ("flow",),
          "inlet-zero_gradient": ("plug", "flow"),
          "inlet-velocity_outlet": ("plug",)}
CASES = [(physics, start, obstacle, n) for physics in PHYSICS
         for start in STARTS[physics] for obstacle in (False, True)
         for n in (1, 9)]
IDS = [f"{p}{'-flowstart' if PHYSICS[p] and s == 'flow' else ''}-"
       f"{'obstacle' if o else 'open'}-{n}step" for p, s, o, n in CASES]


def _plain(f, n, physics, mask):
    outlet = PHYSICS[physics]
    if outlet is None:
        return pipe_run_reference(f, n, OMEGA, RIN, ROUT,
                                  incompressible=physics == "incompressible",
                                  mask=mask)
    for _ in range(n):
        f = velocity_step_reference(f, OMEGA, U_W, U_W, outlet=outlet,
                                    incompressible=False, mask=mask)
    return f


@pytest.mark.parametrize("physics,start,obstacle,n", CASES, ids=IDS)
def test_products_form_matches_plain_step(physics, start, obstacle, n):
    f, mask = _state(obstacle, plug=start == "plug")
    want = _plain(f, n, physics, mask)
    got = emulate(f, n, physics, mask, products=True)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= TOL
    # the division form is the plain step's arithmetic, bit for bit
    assert torch.equal(emulate(f, n, physics, mask, products=False), want)


@pytest.mark.parametrize("physics,start,obstacle,n", CASES, ids=IDS)
def test_products_form_error_no_larger_than_division_form(physics, start,
                                                          obstacle, n):
    f, mask = _state(obstacle, plug=start == "plug")
    exact = _plain(f.double(), n, physics, mask)
    err = {form: emulate(f, n, physics, mask, products=form).double() - exact
           for form in (True, False)}
    rms = {form: float(e.pow(2).mean().sqrt()) for form, e in err.items()}
    top = {form: float(e.abs().max()) for form, e in err.items()}
    assert 0 < rms[True] <= 1.02 * rms[False]
    # the largest: the velocity inlet's zero-gradient outlet from the flow
    # state reads 1.11 times the division form's after 9 steps
    assert 0 < top[True] <= (1.0 if PHYSICS[physics] is None else 1.2) * (
        top[False])
