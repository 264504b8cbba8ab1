"""K8's tiled plan on the CPU: its index math, and a plain emulation of it.

The CUDA kernels of the plan (``lb2d_tpu_torch/csrc/spectral_dft.cu``,
``lb2d_fft_pass``) run only on the card. What they compute from the
plan's numbers is written out here in plain torch, used by these tests
only: the Stockham stages of each line DFT with the twiddle table, the
rows and column groups each pass reads and writes, the screen, and the
pack of the two gradient planes by Hermitian symmetry. Every buffer starts
as NaN, so a value the plan never writes cannot reach the result.

* each line DFT (the tiled stages, or the whole-line kernel's radices
  for 127 points) against ``torch.fft`` on lines of 8192, 4096, 1024, 250,
  127 and 50 points, a few columns each, forward and inverse, to 1e-6 of
  the scale;
* the column passes of a tile (``ny <= 1024``) and of the four-step split
  (``ny = n1 n2``) against ``torch.fft`` along the columns, forward and
  inverse through the screen pass's two halves;
* the whole solve against JAX's ``jnp.fft`` screened solve at 256x384 and
  128x256 and against the plain solve on a four-step grid, to 1e-5 of
  max |g|;
* the plan's shapes: the half spectrum's pitch and column tiles, the
  four-step split, thread counts and shared memory, the twiddle table,
  and which grids take the whole-line kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lb2d_tpu.models.waves import _ScreenedVelocity as JaxScreenedVelocity
from lb2d_tpu_torch.ops.spectral import (
    COLUMN_ONE,
    COLUMNS,
    COLUMNS_SCREEN,
    ROW_PACK,
    ROW_REAL,
    fft_radices,
    four_step_split,
    pass_radices,
    screened_gradients_reference,
    solve_launches,
    solve_plan,
    stage_table,
    twiddle_table,
)

torch.set_num_threads(1)

_SMEM_MAX = 232448  # bytes of shared memory an H100 block can use


def _table(n):
    t = twiddle_table(n).astype(np.float64)
    return torch.complex(torch.from_numpy(t[:, 0]), torch.from_numpy(t[:, 1]))


def _stage(x, R, Ns, table, tw_stride, inverse):
    """One Stockham stage of radix R over the last axis of x, as
    ``pass_stage`` indexes it: butterfly j takes x[j + r n / R] times
    table[r jm (n / (Ns R)) tw_stride] (jm = j mod Ns; the conjugate for
    the inverse) and puts output k at (j - jm) R + jm + k Ns."""
    n = x.shape[-1]
    m = n // R
    j = torch.arange(m)
    jm = j % Ns
    sign = 1.0 if inverse else -1.0
    r = torch.arange(R)
    w = table[(r[:, None] * jm[None, :] * (n // (Ns * R)) * tw_stride)
              % len(table)]
    if inverse:
        w = w.conj()
    v = torch.stack([x[..., j + q * m] for q in range(R)], dim=-2) * w
    k = torch.arange(R)
    dft = torch.exp(sign * 2j * np.pi * (k[:, None] * r[None, :] % R) / R)
    out = torch.einsum("kr,...rj->...kj", dft.to(v.dtype), v)
    y = torch.full_like(x, complex("nan"))
    dst = ((j - jm) * R + jm)[None, :] + k[:, None] * Ns
    y[..., dst.reshape(-1)] = out.reshape(*out.shape[:-2], -1)
    return y


def _line_dft(x, radices, table, tw_stride=1, inverse=False):
    """The n-point DFT of the last axis through the stages of ``radices``
    (unnormalized, as the kernels compute it)."""
    Ns = 1
    for R in radices:
        x = _stage(x, R, Ns, table, tw_stride, inverse)
        Ns *= R
    return x


def _nan_plane(ny, pitch):
    return torch.full((ny, pitch), complex("nan"), dtype=torch.complex128)


def _rows_real(p, rho, table):
    """Rows 2q and 2q + 1 as one complex line q (a zero row past an odd
    ny), separated by Hermitian symmetry: X_a[k] = (Z[k] + conj Z[-k]) / 2,
    X_b[k] = -i (Z[k] - conj Z[-k]) / 2."""
    ny, n, hx = rho.shape[0], p.n, p.out_len
    assert p.total == (ny + 1) // 2
    pad = torch.zeros((2 * p.total, n), dtype=torch.float64)
    pad[:ny] = rho
    Z = _line_dft(torch.complex(pad[0::2], pad[1::2]), p.radices, table)
    k = torch.arange(hx)
    Zk, Zm = Z[:, k], Z[:, (n - k) % n].conj()
    H = _nan_plane(2 * p.total, p.out_pitch)
    H[0::2, :hx] = (Zk + Zm) / 2
    H[1::2, :hx] = -0.5j * (Zk - Zm)
    return H[:ny]


def _rows_pack(p, a, b, table, scale):
    """The pack read forwards (values 0 .. hx - 1 of each row of a and b)
    into Z over the whole row, then the inverse."""
    n, hx = p.n, p.in_len
    Z = torch.full((a.shape[0], n), complex("nan"), dtype=torch.complex128)
    A, B = a[:, :hx], b[:, :hx]
    Z[:, :hx] = A + 1j * B
    e = torch.arange(1, n - hx + 1)
    Z[:, n - e] = A[:, e].conj() + 1j * B[:, e].conj()
    z = _line_dft(Z, p.radices, table, inverse=True) * scale
    return z.real, z.imag


def _rows_of(p, g, n, which):
    e = torch.arange(n)
    if which == "in":
        return g * p.in_gmul + e * p.in_stride
    return g * p.out_gmul + e * p.out_stride


def _cols(p, planes, table):
    """A COLUMNS pass over every column group (the tiles only split the
    columns among blocks; each column is its own line)."""
    outs = [_nan_plane(*q.shape) for q in planes]
    for q_in, q_out in zip(planes, outs):
        for g in range(p.groups):
            x = q_in[_rows_of(p, g, p.n, "in")].t()
            y = _line_dft(x, p.radices, table, p.tw_stride, p.inverse)
            if p.tw_group:
                w = table[g * torch.arange(p.n)]
                y = y * (w.conj() if p.inverse else w)
            q_out[_rows_of(p, g, p.n, "out")] = y.t()
    return outs


def _cols_screen(p, plane, table, mid):
    """A COLUMNS_SCREEN pass: the forward DFT of group g, ``mid(X, ky)``
    giving the two spectra, their inverse DFTs, the group twiddle."""
    a, b = _nan_plane(*plane.shape), _nan_plane(*plane.shape)
    for g in range(p.groups):
        X = _line_dft(plane[_rows_of(p, g, p.n, "in")].t(), p.radices, table,
                      p.tw_stride)
        ky = g + p.n1 * torch.arange(p.n)
        for out, spec in zip((a, b), mid(X, ky)):
            y = _line_dft(spec, p.radices, table, p.tw_stride, inverse=True)
            if p.tw_group:
                y = y * table[g * torch.arange(p.n)].conj()
            out[_rows_of(p, g, p.n, "out")] = y.t()
    return a, b


def _freq(k, n):
    return torch.where(k <= (n - 1) // 2, k, k - n).to(torch.float64)


def _screen(ny, nx, lam2, pitch):
    """The screen and gradient multipliers as the kernel forms them."""
    kx = torch.arange(pitch)
    fkx = _freq(kx, nx)
    gx = torch.where((nx % 2 == 0) & (kx == nx // 2), 0.0, fkx)

    def mid(X, ky):
        fky = _freq(ky, ny)
        gy = torch.where((ny % 2 == 0) & (ky == ny // 2), 0.0, fky)
        s = 1.0 / (lam2 * (fkx[:, None] ** 2 + fky[None, :] ** 2) + 1.0)
        C = X * s
        return (1j * 2 * np.pi * gx[:, None] * C,
                1j * 2 * np.pi * gy[None, :] * C)
    return mid


def _run_plan(plan, rho, mid, scale):
    """The plan's passes in order over named buffers, as
    ``screened_gradients_passes`` wires them."""
    tx, ty = _table(plan.nx), _table(plan.ny)
    bufs = {"rho": rho}
    for p in plan.passes:
        table = tx if p.table == "x" else ty
        src = [bufs[b] for b in p.src]
        if p.kind == ROW_REAL:
            outs = (_rows_real(p, src[0], table),)
        elif p.kind == ROW_PACK:
            outs = _rows_pack(p, *src, table, scale)
        elif p.kind == COLUMNS:
            outs = _cols(p, src, table)
        else:
            outs = _cols_screen(p, src[0], table, mid)
        bufs.update(zip(p.dst, outs))
    return torch.stack([bufs["xg"], bufs["yg"]])


def emulate_solve(rho, lam2, out_scale=1.0):
    """K8's tiled solve of a float ``rho[ny, nx]``, emulated in float64."""
    ny, nx = rho.shape
    plan = solve_plan(ny, nx)
    return _run_plan(plan, torch.as_tensor(rho, dtype=torch.float64),
                     _screen(ny, nx, float(np.float32(lam2)), plan.pitch),
                     out_scale / (ny * nx))


LINES = [8192, 4096, 1024, 250, 127, 50]


@pytest.mark.parametrize("n", LINES)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_line_dft_matches_torch_fft(n, inverse):
    """The stages of a row pass (or, at 127 points, of the whole-line
    kernel) on a few lines."""
    rs = np.random.RandomState(n)
    x = torch.from_numpy(rs.rand(3, n) + 1j * rs.rand(3, n))
    radices = pass_radices(n)
    if n == 127:
        assert radices is None
        radices = fft_radices(n)
    got = _line_dft(x, radices, _table(n), inverse=inverse)
    want = (torch.fft.ifft(x) * n if inverse else torch.fft.fft(x))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("ny", [8192, 4096, 1024, 250, 50])
def test_column_passes_match_torch_fft(ny):
    """The column passes of a plan on a few columns, forward (what the
    screen pass sees as X at ky) and back (the two planes after the last
    column pass: the inverse of X, and of i X)."""
    plan = solve_plan(ny, 16)
    cols = [p for p in plan.passes if p.kind in (COLUMNS, COLUMNS_SCREEN)]
    assert plan.path == ("tile" if ny <= COLUMN_ONE else "four-step")
    assert len(cols) == (1 if ny <= COLUMN_ONE else 3)
    rs = np.random.RandomState(ny)
    H = torch.from_numpy(rs.rand(ny, plan.pitch)
                         + 1j * rs.rand(ny, plan.pitch))
    seen = {}

    def mid(X, ky):
        seen.update({int(k): X[:, i] for i, k in enumerate(ky)})
        return X, 1j * X

    a, b = _run_plan_columns(plan, H, mid)
    spectrum = torch.stack([seen[k] for k in range(ny)], dim=1)
    want = torch.fft.fft(H, dim=0).t()
    scale = float(want.abs().max())
    assert float((spectrum - want).abs().max()) <= 1e-6 * scale
    assert float((a - ny * H).abs().max()) <= 1e-6 * ny * float(H.abs().max())
    assert float((b - 1j * ny * H).abs().max()) <= 1e-6 * ny * float(
        H.abs().max())


def _run_plan_columns(plan, H, mid):
    ty = _table(plan.ny)
    bufs = {"H": H}
    for p in plan.passes:
        if p.kind == COLUMNS:
            outs = _cols(p, [bufs[b] for b in p.src], ty)
        elif p.kind == COLUMNS_SCREEN:
            outs = _cols_screen(p, bufs[p.src[0]], ty, mid)
        else:
            continue
        bufs.update(zip(p.dst, outs))
    last = [p for p in plan.passes if p.kind != ROW_PACK][-1]
    return bufs[last.dst[0]], bufs[last.dst[1]]


@pytest.mark.parametrize("shape", [(256, 384), (128, 256)],
                         ids=["256x384", "128x256"])
def test_emulated_solve_matches_jax_fft(shape):
    ny, nx = shape
    rho = np.random.RandomState(1).rand(ny, nx).astype(np.float32)
    vel = JaxScreenedVelocity(ny, nx, lam=0.7, delta_x=1.0 / nx, vc=1.3,
                              ulb=0.01, method="fft")
    u, v = vel(jnp.asarray(rho))
    want = np.stack([np.asarray(u), np.asarray(v)])
    got = emulate_solve(rho, vel._lam2, vel.scale).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(2048, 48), (48, 50), (50, 7),
                                   (45, 64)],
                         ids=["2048x48", "48x50", "50x7", "45x64"])
def test_emulated_solve_matches_plain_solve(shape):
    """A four-step grid, mixed radices, an odd row, an odd row count (the
    forward x pass's last line carries one real row)."""
    ny, nx = shape
    rho = np.random.RandomState(2).rand(ny, nx).astype(np.float32)
    got = emulate_solve(rho, 16.0, -0.5).numpy()
    want = screened_gradients_reference(torch.from_numpy(rho), 16.0,
                                        out_scale=-0.5).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(8192, 8192), (4096, 4096), (1024, 1024),
                                   (512, 512), (48, 48), (50, 50),
                                   (256, 384), (2048, 48), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_shapes(shape):
    """Pitch and tiles, the split, threads and shared memory as the
    kernel's own checks (lb2d_fft_pass) require them."""
    ny, nx = shape
    plan = solve_plan(ny, nx)
    hx = nx // 2 + 1
    assert plan.hx == hx and plan.pitch >= hx and plan.pitch % 32 == 0
    assert solve_launches(ny, nx) == len(plan.passes) == (
        3 if ny <= COLUMN_ONE else 5)
    assert plan.n1 * plan.n2 == ny
    for p in plan.passes:
        assert int(np.prod(p.radices)) == p.n
        assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
        held = p.lines
        for r in p.radices:
            assert p.threads * -(-16 // r) >= held * p.n // r
        points = held * p.n  # values a block holds in shared memory
        assert (points + points // 16 + 1) * 8 <= _SMEM_MAX
        if p.kind in (COLUMNS, COLUMNS_SCREEN):
            assert p.total == p.in_pitch == p.out_pitch == plan.pitch
            assert p.total % p.lines == 0
            assert p.lines * 8 >= 64       # whole row segments of 64 B+
            assert p.groups * p.n == ny
            rows = sorted(g * p.in_gmul + e * p.in_stride
                          for g in range(p.groups) for e in range(p.n))
            assert rows == list(range(ny))
            rows = sorted(g * p.out_gmul + e * p.out_stride
                          for g in range(p.groups) for e in range(p.n))
            assert rows == list(range(ny))
    if ny == 8192:
        assert (plan.n1, plan.n2) == (64, 128)
        assert [p.radices for p in plan.passes] == [
            (2, 16, 16, 16), (4, 16), (8, 16), (4, 16), (2, 16, 16, 16)]
        assert [p.planes for p in plan.passes[1:4]] == [1, 2, 2]


@pytest.mark.parametrize("shape", [(127, 250), (8191, 16), (16, 8191),
                                   (16, 20000), (11 * 16, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_whole_line_grids(shape):
    """A prime factor above 7, or a row longer than one block holds: the
    whole-line kernel's four launches."""
    assert solve_plan(*shape) is None
    assert solve_launches(*shape) == 4


def test_radices_split_and_table():
    assert pass_radices(8192) == [2, 16, 16, 16]
    assert pass_radices(1024) == [4, 16, 16]
    assert pass_radices(4096) == [16, 16, 16]
    assert pass_radices(250) == [2, 5, 5, 5]
    assert pass_radices(48) == [16, 3]
    assert pass_radices(1) == []
    assert pass_radices(127) is None and pass_radices(22) is None
    assert four_step_split(8192) == (64, 128)
    assert four_step_split(4096) == (64, 64)
    assert four_step_split(2 * 3 * 5 * 7 * 16) == (56, 60)
    assert four_step_split(1031 * 2) is None
    for n in (8192, 1000, 7):
        t = twiddle_table(n).astype(np.float64)
        exact = np.exp(-2j * np.pi * np.arange(n) / n)
        assert t.dtype == np.float64 and t.shape == (n, 2)
        assert np.abs(t[:, 0] + 1j * t[:, 1] - exact).max() <= 6e-8
        assert t[0, 0] == 1.0 and t[0, 1] == 0.0


@pytest.mark.parametrize("n", [8192, 1024, 128, 16, 2])
def test_stage_table_rows_are_the_twiddle_table_entries(n):
    """Each radix-16 stage's rows W_(16 Ns)^(q jm), q = 1, 2, 4, 8, are the
    entries q jm n / (16 Ns) of the pass's table of W_n, bit for bit."""
    radices = pass_radices(n)
    st, full = stage_table(n, radices), twiddle_table(n)
    at, Ns = 0, 1
    for r in radices:
        if r == 16:
            jm = np.arange(Ns)
            for q in (1, 2, 4, 8):
                np.testing.assert_array_equal(
                    st[at:at + Ns], full[q * jm * (n // (16 * Ns)) % n])
                at += Ns
        Ns *= r
    assert len(st) == max(at, 1)
    assert stage_table(48, pass_radices(48)) is None
