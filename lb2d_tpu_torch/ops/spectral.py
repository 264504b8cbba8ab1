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
  solve is four launches: forward along y (real input, half spectrum),
  forward along x in place, the screen prologue (screen, gradient
  multipliers, Hermitian mirror, A + i B pack) with the inverse along x,
  and the inverse along y writing ``out_scale (xg, yg)`` as one ``[2, ny,
  nx]`` tensor, the multicomponent engine's external-force hand-off
  (``dft_pallas.py:517-521``). Any ``ny``, ``nx`` >= 1: the lines are
  factored into radices 8, 4, 2, 3, 5, 7 and whatever primes are left.

The kernels run only on CUDA tensors; on CPU tensors each wrapper runs the
plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches`` (four per solve for :func:`screened_gradients`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .fused import _launch

__all__ = ["SOLVE_LAUNCHES", "spectral_grids",
           "screened_gradients_reference", "dft_axis0_reference",
           "screened_gradients", "screened_gradients_passes", "dft_axis0",
           "fft_radices"]

# Lb2dFftParams.in_kind / out_kind (csrc/spectral_dft.cu)
_REAL, _PLANAR, _INTERLEAVED, _SCREEN = 0, 1, 2, 3
_SMEM_MAX = 232448      # bytes of shared memory a block can use on an H100
_LINE_POINTS = 4096     # points per block the block shape aims at
_MAX_RADICES = 32
SOLVE_LAUNCHES = 4      # K8 launches per screened-gradient solve


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
    _launch("lb2d_fft_lines", in0, in1, out0, out1, scratch, prm)


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

    On CUDA tensors this runs K8 (four launches, each counted in
    ``screened_gradients.launches``); on CPU tensors
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
    """K8's four launches of one solve of a CUDA ``rho[ny, nx]`` into
    ``out[2, ny, nx]``, as ``(name, launch)`` pairs run in order; their
    half-spectrum and full-spectrum buffers are allocated here. This is
    :func:`screened_gradients`' body; called alone (to time each pass) it
    counts nothing."""
    ny, nx = rho.shape
    hy = ny // 2 + 1
    X = torch.empty((hy, nx, 2), dtype=torch.float32, device=rho.device)
    W = torch.empty((ny, nx, 2), dtype=torch.float32, device=rho.device)
    lam2 = float(np.float32(lam2))
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
