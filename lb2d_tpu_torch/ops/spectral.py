"""The screened-gradient spectral solve: K8 and its plain versions
(counterpart of ``lb2d_tpu.ops.dft_pallas``).

The solve takes a real field ``rho[ny, nx]`` to the two gradients of its
screened potential, ``(xg, yg) = ifft2(i 2 pi (gx, gy) s fft2(rho))`` with
the screen ``s = 1 / (lam2 (kx^2 + ky^2) + 1)`` on the integer frequency
grids ``k = fftfreq(n) n`` and the gradient multipliers ``g`` the same
grids with their Nyquist bins zeroed (``lb2d_tpu/models/waves.py:218-235``).
Both gradient spectra are Hermitian, so one complex inverse carries both:
``ifft2(A + i B) = xg + i yg`` (``waves.py:285-321``).

* :func:`spectral_grids`, :func:`screened_gradients_reference` (the plain
  solve on ``torch.fft``, exactly the JAX model's ``method="fft"`` path)
  and :func:`dft_axis0_reference` (``torch.fft.fft`` along dim 0).
* :func:`screened_gradients` and :func:`dft_axis0`: the K8 wrappers
  (``csrc/spectral_dft.cu``, a hand-written batched FFT; no cuFFT). The
  solve writes ``out_scale (xg, yg)`` as one ``[2, ny, nx]`` tensor, the
  multicomponent engine's external-force hand-off
  (``dft_pallas.py:517-521``). Where every line factors into 2, 3, 5 and 7
  (:func:`solve_plan`) it runs the tiled plan: the rows of ``rho`` to the
  half spectrum along x, the column tiles (one launch when ``ny <=
  COLUMN_ONE``, else a four-step split ``ny = n1 n2`` in three) forward
  along y, screened, and inverse along y as the two gradient spectra, and
  the rows again, packed as ``A + i B`` by Hermitian symmetry, inverse
  along x: three or five launches (:func:`solve_launches`). Other grids
  keep the whole-line kernel's four launches: forward along y, forward
  along x in place, the screen prologue with the inverse along x, the
  inverse along y. Any ``ny``, ``nx`` >= 1. :func:`dft_axis0` is one
  launch of the whole-line kernel.

The kernels run only on CUDA tensors; on CPU tensors each wrapper runs the
plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches`` (:func:`solve_launches` per solve for
:func:`screened_gradients`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .fused import _launch

__all__ = ["spectral_grids", "screened_gradients_reference",
           "dft_axis0_reference", "screened_gradients",
           "screened_gradients_passes", "dft_axis0", "fft_radices",
           "pass_radices", "four_step_split", "solve_plan",
           "solve_launches", "twiddle_table", "stage_table", "FftPass",
           "SolvePlan"]

# Lb2dFftParams.in_kind / out_kind (csrc/spectral_dft.cu)
_REAL, _PLANAR, _INTERLEAVED, _SCREEN = 0, 1, 2, 3
_SMEM_MAX = 232448      # bytes of shared memory a block can use on an H100
_LINE_POINTS = 4096     # points per block the whole-line kernel aims at
_MAX_RADICES = 32
# Lb2dFftPass.kind (csrc/spectral_dft.cu): the tiled plan's four kernels
ROW_REAL, ROW_PACK, COLUMNS, COLUMNS_SCREEN = 0, 1, 2, 3
_VALUES = 16            # values a thread of the tiled passes holds
_MAX_POINTS = 16384     # points per block: 1024 threads of _VALUES
_ROW_POINTS = 4096      # points per block the row passes aim at
_SMS = 132              # the H100's multiprocessors
COLUMN_ONE = 1024       # columns up to this long: one launch per tile
COLUMN_TILE = 8         # columns per tile then (64 B row segments)
_PITCH = 32             # the half-spectrum rows' pitch: a multiple of this


def spectral_grids(ny: int, nx: int, device=None):
    """``(fx, fy, gx, gy)``: float32 ``fftfreq(n) n`` along x and y, and the
    gradient multipliers, the same with the Nyquist bin of an even ``n``
    zeroed (``lb2d_tpu/models/waves.py:218-235``)."""
    freqs = [np.fft.fftfreq(n) * n for n in (nx, ny)]
    grads = [f.copy() for f in freqs]
    for g, n in zip(grads, (nx, ny)):
        if n % 2 == 0:
            g[n // 2] = 0.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (*freqs, *grads))


def screened_gradients_reference(rho: torch.Tensor, lam2: float,
                                 out_scale: float | None = None):
    """The plain screened-gradient solve of a real ``rho[ny, nx]`` in
    complex64 ``torch.fft``, in the operations of JAX's ``method="fft"``
    path (``waves.py:311-315``): ``(xg, yg)``, or with ``out_scale=s`` one
    ``[2, ny, nx]`` tensor ``s (xg, yg)``. ``lam2`` is rounded to float32,
    as JAX holds it."""
    ny, nx = rho.shape
    fx, fy, gx, gy = spectral_grids(ny, nx, rho.device)
    lam2 = float(np.float32(lam2))
    rescale = 1.0 / (lam2 * (fx[None, :] * fx[None, :]
                             + fy[:, None] * fy[:, None]) + 1.0)
    ax = (2.0 * np.pi) * gx[None, :]
    ay = (2.0 * np.pi) * gy[:, None]
    chat = torch.fft.fft2(rho.to(torch.complex64)) * rescale
    g = torch.fft.ifft2(chat * (1j * ax) + 1j * (chat * (1j * ay)))
    xg, yg = g.real.contiguous(), g.imag.contiguous()
    if out_scale is None:
        return xg, yg
    s = float(np.float32(out_scale))
    return torch.stack((s * xg, s * yg))


def dft_axis0_reference(xr: torch.Tensor, xi: torch.Tensor | None = None,
                        inverse: bool = False, out_rows: int | None = None):
    """``torch.fft.fft`` (``ifft`` when ``inverse``) along dim 0 of ``xr +
    i xi`` (real input when ``xi`` is None), first ``out_rows`` rows:
    ``(yr, yi)``, what ``make_axis0_dft`` computes
    (``dft_pallas.py:146-191``)."""
    z = (xr.to(torch.complex64) if xi is None else torch.complex(xr, xi))
    y = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=0)
    y = y[:xr.shape[0] if out_rows is None else int(out_rows)]
    return y.real.contiguous(), y.imag.contiguous()


# -- the kernel ---------------------------------------------------------------

def fft_radices(n: int) -> list[int]:
    """The Stockham stages of an ``n``-point line: radices 8, 4, 2, 3, 5, 7,
    then each prime factor left as a stage of its own."""
    out = []
    for r in (8, 4, 2, 3, 5, 7):
        while n % r == 0:
            out.append(r)
            n //= r
    p = 11
    while n > 1 and p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 2
    if n > 1:
        out.append(n)
    return out


def pass_radices(n: int) -> list[int] | None:
    """The stages of a tiled pass over ``n``-point lines, each a register
    butterfly: the power of two's leftover radix (8, 4 or 2; the first
    stage needs no twiddles), then radix 16 for the rest of it, then 3, 5
    and 7. None when ``n`` has any other prime factor: such lengths take
    the whole-line kernel."""
    out = []
    while n % 16 == 0:
        out.append(16)
        n //= 16
    for r in (8, 4, 2):
        if n % r == 0:
            out.insert(0, r)
            n //= r
            break
    for r in (3, 5, 7):
        while n % r == 0:
            out.append(r)
            n //= r
    return out if n == 1 else None


def four_step_split(n: int) -> tuple[int, int] | None:
    """``(n1, n2)``, ``n = n1 n2``: n1 the largest divisor of ``n`` not above
    its square root, so both factors are as close as they can be; None
    when no split leaves both in 2..512 (one block's column tile)."""
    n1 = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
    n2 = n // n1
    return (n1, n2) if n1 >= 2 and n2 <= 512 else None


@dataclasses.dataclass(frozen=True)
class FftPass:
    """One launch of K8's tiled plan, ``Lb2dFftPass`` of
    ``csrc/spectral_dft.cu``. ``n``-point DFTs (``radices`` from
    :func:`pass_radices`, twiddles from the table of W_N of dimension
    ``table``, every ``tw_stride``-th entry) over

    * rows (``ROW_REAL``, ``ROW_PACK``): ``lines`` of the ``total`` lines
      per block, ``in_len`` values read and ``out_len`` written per row,
      rows ``in_pitch`` / ``out_pitch`` elements apart (``ROW_REAL``'s
      line q carries the real rows 2q and 2q + 1 of ``ny``);
    * column tiles (``COLUMNS``, ``COLUMNS_SCREEN``): ``lines`` adjacent
      columns of the half-spectrum planes (``total`` columns, the pitch),
      element ``e`` of group ``g`` (``groups`` of them; the launch's
      blocks are tiles x groups x ``planes``) read from row ``g in_gmul +
      e in_stride`` and written to row ``g out_gmul + e out_stride``,
      times W_N^(-+ g e) when ``tw_group``; ``COLUMNS_SCREEN``'s spectrum
      index along y is ``g + n1 e``, and its plane z is gradient z (each
      of the two blocks of a tile transforms the tile forward itself).

    ``src`` and ``dst`` name the buffers read and written: ``rho``, the
    half-spectrum planes ``H``, ``T``, ``U``, ``V`` (``[ny, pitch]``
    complex) and the output planes ``xg``, ``yg``."""
    name: str
    kind: int
    inverse: bool
    n: int
    radices: tuple
    table: str
    tw_stride: int
    lines: int
    total: int
    threads: int
    src: tuple
    dst: tuple
    tw_group: bool = False
    groups: int = 1
    planes: int = 1
    n1: int = 1
    in_pitch: int = 0
    out_pitch: int = 0
    in_len: int = 0
    out_len: int = 0
    in_gmul: int = 0
    in_stride: int = 1
    out_gmul: int = 0
    out_stride: int = 1


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """K8's tiled plan of one ``ny x nx`` solve: ``path`` ``"tile"`` (each
    column tile transformed whole by one block, ``ny <= COLUMN_ONE``) or
    ``"four-step"`` (``ny = n1 n2``), its ``passes`` in launch order, the
    half spectrum's ``hx`` columns kept at a row ``pitch``."""
    ny: int
    nx: int
    hx: int
    pitch: int
    n1: int
    n2: int
    path: str
    passes: tuple

    def bytes_moved(self, p: FftPass) -> int:
        """The bytes pass ``p`` must move, each value it reads and writes
        once: ``rho`` and the output planes 4 B a cell, the half-spectrum
        planes 8 B a cell of their ``hx`` columns (not the pitch)."""
        cells, half = self.ny * self.nx, 8 * self.ny * self.hx
        size = {"rho": 4 * cells, "xg": 4 * cells, "yg": 4 * cells}
        return sum(size.get(b, half) for b in p.src + p.dst)

    @property
    def buffers(self) -> tuple[str, ...]:
        """The half-spectrum planes the passes use."""
        names = {b for p in self.passes for b in p.src + p.dst}
        return tuple(sorted(names - {"rho", "xg", "yg"}))


def _threads(points: int) -> int:
    """Threads of a block that holds ``points`` values, ``_VALUES`` each."""
    return min(1024, max(32, -(-points // (_VALUES * 32)) * 32))


@functools.lru_cache(maxsize=None)
def solve_plan(ny: int, nx: int) -> SolvePlan | None:
    """The tiled plan of a ``ny x nx`` solve, or None where the grid takes
    the whole-line kernel: a line with a prime factor above 7, a row
    longer than ``_MAX_POINTS`` or a column that splits into no two
    factors of at most 512.

    Five launches at most (``"four-step"``; three for ``"tile"``): rows
    of real ``rho`` to the half spectrum along x (``hx = nx // 2 + 1``
    columns; two rows per complex DFT, ``2q + i (2q + 1)``, separated by
    Hermitian symmetry); the columns, forward along y, the screen and gradient
    multipliers, and the inverse along y of the two gradient spectra; the
    rows again, the two planes packed as ``A + i B`` over the whole x
    spectrum by Hermitian symmetry, inverse along x into ``out_scale
    (xg, yg)``."""
    rx, ry = pass_radices(nx), pass_radices(ny)
    if rx is None or ry is None or nx > _MAX_POINTS:
        return None
    hx = nx // 2 + 1
    pitch = -(-hx // _PITCH) * _PITCH
    def rows(lines):  # a row pass over `lines` lines of nx points
        per_block = max(1, min(_ROW_POINTS // nx, -(-lines // _SMS)))
        return dict(n=nx, radices=tuple(rx), table="x", tw_stride=1,
                    lines=per_block, total=lines,
                    threads=_threads(per_block * nx))

    # two real rows 2q, 2q + 1 per complex line q
    passes = [FftPass("forward x", ROW_REAL, False, in_pitch=nx,
                      out_pitch=pitch, in_len=nx, out_len=hx, src=("rho",),
                      dst=("H",), **rows(-(-ny // 2)))]
    col = dict(table="y", total=pitch, in_pitch=pitch, out_pitch=pitch)
    if ny <= COLUMN_ONE:
        path, n1, n2, tx = "tile", 1, ny, COLUMN_TILE
        passes.append(FftPass(
            "columns: forward y, screen, inverse y", COLUMNS_SCREEN, False,
            n=ny, radices=tuple(ry), tw_stride=1, lines=tx,
            threads=_threads(tx * ny), planes=2, src=("H",),
            dst=("T", "U"), **col))
        planes = ("T", "U")
    else:
        split = four_step_split(ny)
        if split is None:
            return None
        path, (n1, n2) = "four-step", split
        tx = 32 if n2 <= 256 else 16
        r1, r2 = tuple(pass_radices(n1)), tuple(pass_radices(n2))
        passes += [
            # n1-point DFTs over rows j2 + n2 j1, times W^(-j2 k1), to rows
            # k1 n2 + j2
            FftPass("columns: forward y (n1)", COLUMNS, False, n=n1,
                    radices=r1, tw_stride=n2, tw_group=True, lines=tx,
                    threads=_threads(tx * n1), groups=n2, in_gmul=1,
                    in_stride=n2, out_gmul=1, out_stride=n2, src=("H",),
                    dst=("T",), **col),
            # n2-point DFTs over rows k1 n2 + j2 (ky = k1 + n1 k2), the
            # screen, the inverse n2-point DFT of each gradient spectrum,
            # times W^(j2 k1), to rows j2 n1 + k1
            FftPass("columns: forward y (n2), screen, inverse y (n2)",
                    COLUMNS_SCREEN, False, n=n2, radices=r2, tw_stride=n1,
                    tw_group=True, lines=tx, threads=_threads(tx * n2),
                    groups=n1, planes=2, n1=n1, in_gmul=n2, in_stride=1,
                    out_gmul=1, out_stride=n1, src=("T",), dst=("H", "U"),
                    **col),
            # inverse n1-point DFTs over rows j2 n1 + k1 of each plane, to
            # rows j2 + n2 j1
            FftPass("columns: inverse y (n1)", COLUMNS, True, n=n1,
                    radices=r1, tw_stride=n2, lines=tx,
                    threads=_threads(tx * n1), groups=n2, planes=2,
                    in_gmul=n1, in_stride=1, out_gmul=1, out_stride=n2,
                    src=("H", "U"), dst=("T", "V"), **col),
        ]
        planes = ("T", "V")
    passes.append(FftPass("pack + inverse x", ROW_PACK, True, in_pitch=pitch,
                          out_pitch=nx, in_len=hx, out_len=nx, src=planes,
                          dst=("xg", "yg"), **rows(ny)))
    return SolvePlan(ny, nx, hx, pitch, n1, n2, path, tuple(passes))


def solve_launches(ny: int, nx: int) -> int:
    """K8 launches per screened-gradient solve of a ``ny x nx`` grid: the
    tiled plan's passes, or the whole-line kernel's four."""
    plan = solve_plan(ny, nx)
    return 4 if plan is None else len(plan.passes)


def twiddle_table(n: int) -> np.ndarray:
    """W_n^m = exp(-2 pi i m / n), m = 0 .. n - 1, as float32 ``[n, 2]``
    (re, im): each entry the float32 rounding of the float64 value from
    the exact integer phase. The tiled passes read it (the inverse its
    conjugate); a pass of length n / s reads every s-th entry."""
    ang = 2.0 * np.pi * (np.arange(n, dtype=np.float64) / n)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def stage_table(n: int, radices) -> np.ndarray | None:
    """The stage table of a tiled pass whose ``radices`` are a leftover
    radix (or none) and then 16s, else None: for each radix-16 stage in
    order, with Ns the product of the radices before it, the four rows
    W_(16 Ns)^(q jm), q = 1, 2, 4, 8, of jm = 0 .. Ns - 1 (float32 ``[K,
    2]``, float64 values from the exact integer phase), so that a stage's
    neighbouring butterflies read neighbouring entries. One dummy entry
    where there is no radix-16 stage."""
    if any(r != 16 for r in radices[1:]) or (radices and
                                              radices[0] not in (2, 4, 8, 16)):
        return None
    rows, Ns = [np.zeros((1, 2))], 1
    for r in radices:
        if r == 16:
            jm = np.arange(Ns, dtype=np.float64)
            for q in (1, 2, 4, 8):
                ang = 2.0 * np.pi * (q * jm / (16 * Ns))
                rows.append(np.stack([np.cos(ang), -np.sin(ang)], axis=1))
        Ns *= r
    table = np.concatenate(rows[1:] or rows)
    return table.astype(np.float32)


_TABLES: dict = {}


def _table(n: int, device, radices=None) -> torch.Tensor | None:
    """Twiddle table of W_n on ``device``, or with ``radices`` the stage
    table of that pass (None where it has none), built once."""
    key = (n, str(device), radices)
    if key not in _TABLES:
        t = twiddle_table(n) if radices is None else stage_table(n, radices)
        _TABLES[key] = None if t is None else torch.from_numpy(t).to(device)
    return _TABLES[key]


@functools.lru_cache(maxsize=None)
def _pass_params(ny: int, nx: int) -> tuple:
    """The ctypes structs of the passes of ``solve_plan(ny, nx)``, built
    once per grid (their ``lam2`` and ``out_scale`` set at each launch)."""
    out = []
    for p in solve_plan(ny, nx).passes:
        prm = _build.FftPass()
        for name in ("kind", "n", "tw_stride", "lines", "total", "threads",
                     "groups", "planes", "n1", "in_pitch", "out_pitch",
                     "in_len", "out_len", "in_gmul", "in_stride", "out_gmul",
                     "out_stride"):
            setattr(prm, name, getattr(p, name))
        prm.inverse, prm.tw_group = int(p.inverse), int(p.tw_group)
        prm.num_radices = len(p.radices)
        prm.radices[:len(p.radices)] = p.radices
        prm.ny, prm.nx = ny, nx
        out.append(prm)
    return tuple(out)


def _lines(in0, in1, out0, out1, *, n, lines, in_kind, in_elem, in_line,
           out_kind, out_elem, out_line, out_rows=None, inverse=False,
           out_scale=1.0, ny=0, hy=0, lam2=0.0):
    """One K8 launch: ``lines`` DFTs of ``n`` points (see
    ``Lb2dFftParams``); the inverse's 1 / n is folded into the output
    scale."""
    radices = fft_radices(n)
    if len(radices) > _MAX_RADICES:
        raise ValueError(f"{n} points need {len(radices)} radix stages, the "
                         f"kernel takes {_MAX_RADICES}")
    scratch = None
    if 16 * n > _SMEM_MAX:   # two buffers of one line exceed shared memory
        per_block = 1
        scratch = torch.empty((lines, 2 * n, 2), dtype=torch.float32,
                              device=in0.device)
    else:
        per_block = max(1, min(lines, _LINE_POINTS // n,
                               _SMEM_MAX // (16 * n)))
    threads = min(1024, max(64, -(-per_block * n // 4 // 32) * 32))
    prm = _build.FftParams()
    prm.in_elem, prm.in_line = in_elem, in_line
    prm.out_elem, prm.out_line = out_elem, out_line
    prm.n, prm.lines = n, lines
    prm.out_rows = n if out_rows is None else out_rows
    prm.lines_per_block, prm.threads = per_block, threads
    prm.in_kind, prm.out_kind, prm.inverse = in_kind, out_kind, int(inverse)
    prm.out_scale = out_scale / n if inverse else out_scale
    prm.ny, prm.hy, prm.lam2 = ny, hy, lam2
    prm.num_radices = len(radices)
    prm.radices[:len(radices)] = radices
    _launch("lb2d_fft_lines", in0, in1, out0, out1, scratch,
            _table(n, in0.device), prm)


def _check_plane(t, name, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or min(t.shape) < 1:
        raise ValueError(f"{name} must be [rows, cols], got "
                         f"{tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {t.device}")


def screened_gradients(rho: torch.Tensor, lam2: float,
                       out: torch.Tensor | None = None,
                       out_scale: float | None = None):
    """The screened-gradient solve of ``rho[ny, nx]`` (float32): ``(xg,
    yg)``, or with ``out_scale=s`` one ``[2, ny, nx]`` tensor ``s (xg,
    yg)``. ``out`` (``[2, ny, nx]`` float32, contiguous) receives the
    planes in place; the multicomponent engine passes its ext plane pair.

    On CUDA tensors this runs K8 (``solve_launches(ny, nx)`` launches, each
    counted in ``screened_gradients.launches``); on CPU tensors
    :func:`screened_gradients_reference`.
    """
    _check_plane(rho, "rho")
    ny, nx = rho.shape
    if out is None:
        out = torch.empty((2, ny, nx), dtype=torch.float32, device=rho.device)
    elif (tuple(out.shape) != (2, ny, nx) or out.dtype != torch.float32
          or out.device != rho.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 [2, {ny}, {nx}] on "
                         f"{rho.device}")
    scale = 1.0 if out_scale is None else float(np.float32(out_scale))
    if rho.device.type == "cpu":
        out.copy_(screened_gradients_reference(rho, lam2, out_scale=scale))
    else:
        for _, launch in screened_gradients_passes(rho, lam2, out, scale):
            launch()
            screened_gradients.launches += 1
    if out_scale is None:
        return out[0], out[1]
    return out


def screened_gradients_passes(rho: torch.Tensor, lam2: float,
                              out: torch.Tensor, out_scale: float = 1.0):
    """K8's launches of one solve of a CUDA ``rho[ny, nx]`` into ``out[2,
    ny, nx]``, as ``(name, launch)`` pairs run in order: the tiled plan's
    passes (:func:`solve_plan`) or, where there is none, the whole-line
    kernel's four; their spectrum buffers are allocated here. This is
    :func:`screened_gradients`' body; called alone (to time each pass) it
    counts nothing."""
    ny, nx = rho.shape
    lam2 = float(np.float32(lam2))
    plan = solve_plan(ny, nx)
    if plan is None:
        return _whole_line_passes(rho, lam2, out, out_scale)
    # the half-spectrum planes in one allocation; pointers to every plane
    buf = torch.empty((len(plan.buffers), ny, plan.pitch, 2),
                      dtype=torch.float32, device=rho.device)
    ptr = {name: buf.data_ptr() + i * buf.stride(0) * 4
           for i, name in enumerate(plan.buffers)}
    ptr.update(rho=rho.data_ptr(), xg=out[0].data_ptr(),
               yg=out[1].data_ptr(), none=None)
    tables = {"x": _table(nx, rho.device).data_ptr(),
              "y": _table(ny, rho.device).data_ptr()}
    # the inverse's 1 / (ny nx) and out_scale in the last pass's store
    scale = float(np.float32(out_scale / (ny * nx)))
    fn = _build.load_library().lb2d_fft_pass
    stream = torch.cuda.current_stream(rho.device).cuda_stream

    def launch(p, prm, planes):  # planes: held, so they outlive the call
        prm.lam2, prm.out_scale = lam2, scale
        names = (*p.src, *("none",) * (2 - len(p.src)),
                 *p.dst, *("none",) * (2 - len(p.dst)))
        st = _table(p.n, rho.device, p.radices)
        err = fn(*(ptr[b] for b in names), tables[p.table],
                 None if st is None else st.data_ptr(), prm, stream)
        if err != 0:
            raise RuntimeError(f"lb2d_fft_pass kernel launch failed ({p.name}"
                               f"): CUDA error {err}")

    return [(p.name, functools.partial(launch, p, prm, buf))
            for p, prm in zip(plan.passes, _pass_params(ny, nx))]


def _whole_line_passes(rho, lam2, out, out_scale):
    """The four launches of the whole-line kernel (``Lb2dFftParams``): the
    grids with no tiled plan."""
    ny, nx = rho.shape
    hy = ny // 2 + 1
    X = torch.empty((hy, nx, 2), dtype=torch.float32, device=rho.device)
    W = torch.empty((ny, nx, 2), dtype=torch.float32, device=rho.device)
    return [
        # forward along y: the columns of rho, real, ky = 0 .. ny / 2
        ("forward y", lambda: _lines(
            rho, None, X, None, n=ny, lines=nx, in_kind=_REAL, in_elem=nx,
            in_line=1, out_kind=_INTERLEAVED, out_elem=nx, out_line=1,
            out_rows=hy)),
        # forward along x: the hy rows of X, in place
        ("forward x", lambda: _lines(
            X, None, X, None, n=nx, lines=hy, in_kind=_INTERLEAVED,
            in_elem=1, in_line=nx, out_kind=_INTERLEAVED, out_elem=1,
            out_line=nx)),
        # screen + multipliers + mirror + pack, inverse along x: rows ky
        ("screen + inverse x", lambda: _lines(
            X, None, W, None, n=nx, lines=ny, in_kind=_SCREEN, in_elem=1,
            in_line=nx, out_kind=_INTERLEAVED, out_elem=1, out_line=nx,
            inverse=True, ny=ny, hy=hy, lam2=lam2)),
        # inverse along y: the columns of W -> scale (xg, yg)
        ("inverse y", lambda: _lines(
            W, None, out[0], out[1], n=ny, lines=nx, in_kind=_INTERLEAVED,
            in_elem=nx, in_line=1, out_kind=_PLANAR, out_elem=nx,
            out_line=1, inverse=True, out_scale=out_scale)),
    ]


screened_gradients.launches = 0


def dft_axis0(xr: torch.Tensor, xi: torch.Tensor | None = None,
              inverse: bool = False, out_rows: int | None = None):
    """The DFT along dim 0 of ``xr + i xi`` (``[n, W]`` float32; real input
    when ``xi`` is None), inverse with 1 / n when ``inverse``, first
    ``out_rows`` rows: ``(yr, yi)``, K8's 1-D pass.

    On CUDA tensors this launches K8 once (counted in
    ``dft_axis0.launches``); on CPU tensors :func:`dft_axis0_reference`.
    """
    _check_plane(xr, "xr")
    if xi is not None:
        _check_plane(xi, "xi", xr.shape)
        if xi.device != xr.device:
            raise ValueError("xi must be on xr's device")
    n, W = xr.shape
    rows = n if out_rows is None else int(out_rows)
    if not 1 <= rows <= n:
        raise ValueError(f"out_rows must be in 1..{n}, got {out_rows}")
    if xr.device.type == "cpu":
        return dft_axis0_reference(xr, xi, inverse, rows)
    yr = torch.empty((rows, W), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _lines(xr, xi, yr, yi, n=n, lines=W,
           in_kind=_REAL if xi is None else _PLANAR, in_elem=W, in_line=1,
           out_kind=_PLANAR, out_elem=W, out_line=1, out_rows=rows,
           inverse=inverse)
    dft_axis0.launches += 1
    return yr, yi


dft_axis0.launches = 0
