"""The row sweep's flow update in its products form, emulated on the CPU.

K2's and K9's flow sweep (``lb2d_tpu_torch/csrc/temporal_sweep.cuh``,
``collide<.., kPaired, kProducts>`` in ``pipe_cell.cuh``) multiplies by 3,
4.5 and 1.5 where the plain step divides by float32's cs2, 2 cs2 cs2 and
2 cs2. The kernels run only on the card; here the update is written out in
float32 torch, one operation per kernel operation, without the FMAs nvcc
may contract: the stream, the Zou-He pressure inlet and outlet, the walls
and corners, bounce-back inside an obstacle, the moments in direction
order, the equilibrium (quadratic, or He-Luo with the velocity zeroed in
the obstacle) with opposite directions paired, and BGK. Nothing of the
package computes it.

The products form is held to the plain step (``ops/fused.py``) within the
card tests' 1e-6 after 1 and 9 steps, on a 254x382 state with and without
an obstacle, for both equilibria. Against a float64 plain step from the
same float32 state, its largest error must be no larger than that of the
same emulation in the division form, which in turn equals the plain
float32 step bit for bit (so the emulation is the plain step's arithmetic).
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.ops.fused import pipe_run_reference

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


def _collide(st, incomp, solid, products):
    """``pipe_cell.cuh::collide`` with kPaired, in the products form
    (kProducts) or the division form."""
    rho = st[0]
    for j in range(1, 9):
        rho = rho + st[j]
    jx = st[1] - st[3] + st[5] - st[6] - st[7] + st[8]
    jy = st[2] - st[4] + st[5] + st[6] - st[7] - st[8]
    if incomp:
        u, v = jx, jy
        if solid is not None:
            u = torch.where(solid, 0.0, u)
            v = torch.where(solid, 0.0, v)
    else:
        inv = 1.0 / rho
        u, v = jx * inv, jy * inv
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


def emulate(f, n, incomp, mask, products):
    """``n`` steps of the sweep's flow update on float32 ``f [9, ny, nx]``."""
    solid = None if mask is None else mask.bool()
    for _ in range(n):
        st = _bcs(_pull(f), incomp)
        if solid is not None:
            st = [torch.where(solid, st[OPP[j]], st[j]) for j in range(9)]
        f = _collide(st, incomp, solid if incomp else None, products)
    return f


def _state(obstacle):
    """A float32 state near equilibrium with speeds up to ~0.08 (so the
    quadratic terms are far above rounding), and a disk."""
    rng = np.random.RandomState(23)
    y, x = np.mgrid[0:NY, 0:NX] / np.array([NY, NX])[:, None, None]
    rho = 1.0 + 0.02 * np.cos(2 * np.pi * (3 * x + 2 * y) + rng.rand() * 6)
    u = 0.05 + 0.03 * np.sin(2 * np.pi * (2 * x - y) + rng.rand() * 6)
    v = 0.04 * np.cos(2 * np.pi * (x + 4 * y) + rng.rand() * 6)
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


CASES = [(incomp, obstacle, n) for incomp in (False, True)
         for obstacle in (False, True) for n in (1, 9)]
IDS = [f"{'incompressible' if i else 'compressible'}-"
       f"{'obstacle' if o else 'open'}-{n}step" for i, o, n in CASES]


def _plain(f, n, incomp, mask):
    return pipe_run_reference(f, n, OMEGA, RIN, ROUT, incompressible=incomp,
                              mask=mask)


@pytest.mark.parametrize("incomp,obstacle,n", CASES, ids=IDS)
def test_products_form_matches_plain_step(incomp, obstacle, n):
    f, mask = _state(obstacle)
    want = _plain(f, n, incomp, mask)
    got = emulate(f, n, incomp, mask, products=True)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= TOL
    # the division form is the plain step's arithmetic, bit for bit
    assert torch.equal(emulate(f, n, incomp, mask, products=False), want)


@pytest.mark.parametrize("incomp,obstacle,n", CASES, ids=IDS)
def test_products_form_error_no_larger_than_division_form(incomp, obstacle,
                                                          n):
    f, mask = _state(obstacle)
    exact = _plain(f.double(), n, incomp, mask)
    err = {form: float((emulate(f, n, incomp, mask, products=form).double()
                        - exact).abs().max()) for form in (True, False)}
    assert 0 < err[True] <= err[False]
