"""Counter-based Philox4x32-10 normals: the noise of the stochastic kernels.

Counterpart of the TPU's on-core PRNG (``pltpu.prng_random_bits`` plus
Box-Muller, ``lb2d_tpu/ops/fused.py:273-302``; probed by
``benchmarks/tpu_tests.py:_kernel_normals``). The TPU kernels reseed per
(sweep, chunk, stage), so their realization depends on how the kernel is
cut. Here every cell's normal at global step ``step`` is a pure function of
(seed, step, cell)::

    bits = philox4x32_10(counter=(cell, step mod 2^32, step >> 32, 0),
                         key=(seed mod 2^32, (seed >> 32) mod 2^32))
    eta  = box_muller(bits[0], bits[1])        # cell = y * nx + x

so a K-step kernel that recomputes a neighbour's halo cells, a one-launch
run and the plain step give the same trajectory. ``csrc/philox.cuh`` is the
CUDA counterpart and gives the same bits; the float normals differ from
these by the card's ``logf``/``cosf`` rounding (a few ulp).

torch has no unsigned 32-bit arithmetic that wraps, so the plain version
keeps each 32-bit word in an int64 tensor and forms the 32x32 -> 64-bit
products from 16-bit halves, never overflowing int64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.tracing import traced_launch
from . import _build

__all__ = ["philox4x32_10", "box_muller", "normals_reference", "normals",
           "population_normals_reference", "population_normals_at",
           "philox_bits", "philox_key", "normals_per_cell",
           "NormalsSplit", "normals_split", "normals_thread_cells"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10


def philox_key(seed: int) -> tuple[int, int]:
    """The two 32-bit key words of a seed (any Python int, taken mod 2^64)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def _counter_step(step: int) -> tuple[int, int]:
    step = int(step)
    if not 0 <= step < 1 << 64:
        raise ValueError(f"step must be in [0, 2^64), got {step}")
    return step & _MASK32, step >> 32


def _mulhilo(a: torch.Tensor, m: int):
    """``(a * m) >> 32`` and ``(a * m) mod 2^32`` for words ``a`` in
    [0, 2^32) held in int64, from 16-bit halves (every partial < 2^34)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    t = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    return a_hi * m_hi + (mid >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key) -> torch.Tensor:
    """Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's
    ``philox4x32_10``).

    ``counter`` is four words (int64 tensors or ints, broadcastable, each in
    [0, 2^32)), ``key`` two Python ints. Returns the four output words as an
    int64 tensor ``[4, ...]``.
    """
    device = next((c.device for c in counter if isinstance(c, torch.Tensor)),
                  None)
    words = [torch.as_tensor(c, dtype=torch.int64, device=device)
             for c in counter]
    c0, c1, c2, c3 = torch.broadcast_tensors(*words)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(_ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3])


def box_muller(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """One standard normal per pair of 32-bit words: the cos branch of the
    JAX kernels' Box-Muller (``lb2d_tpu/ops/fused.py:273-292``): the top 24
    bits of each word, ``u1`` offset by half a step so that it lies in
    (0, 1] and ``log`` never sees 0."""
    scale = 1.0 / (1 << 24)
    u1 = (b1 >> 8).to(torch.float32) * scale + 0.5 * scale  # exact in f32
    u2 = (b2 >> 8).to(torch.float32) * scale
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=u2.device)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(two_pi * u2)


def normals_reference(seed: int, step: int, ny: int, nx: int,
                      device=None) -> torch.Tensor:
    """The float32 ``[ny, nx]`` standard normals of global step ``step``,
    in plain torch integer ops (the plain version of :func:`normals`)."""
    cell = torch.arange(ny * nx, dtype=torch.int64, device=device)
    s_lo, s_hi = _counter_step(step)
    bits = philox4x32_10((cell, s_lo, s_hi, 0), philox_key(seed))
    return box_muller(bits[0], bits[1]).reshape(ny, nx)


def population_normals_reference(seed: int, step: int, P: int, ny: int,
                                 nx: int, device=None) -> torch.Tensor:
    """The float32 ``[P, ny, nx]`` standard normals of populations ``0 ..
    P-1`` at global step ``step``: the noise of the multifield Expansion.

    One Philox call serves two populations, as the JAX kernel pairs its
    draws (``lb2d_tpu/ops/fused.py:1616-1650``)::

        bits  = philox4x32_10((cell, step lo, step hi, p >> 1), key)
        eta_p = box_muller(bits[2 (p % 2)], bits[2 (p % 2) + 1])

    so population 0 equals :func:`normals_reference`. ``csrc/philox.cuh``
    draws the same bits on the card (``multifield_cell.cuh``).
    """
    cell = torch.arange(ny * nx, dtype=torch.int64, device=device)
    return population_normals_at(seed, step, P, cell).reshape(P, ny, nx)


def population_normals_at(seed: int, step: int, P: int,
                          cell: torch.Tensor) -> torch.Tensor:
    """:func:`population_normals_reference` at the global cell indices
    ``cell`` (an int64 tensor ``[n]``): ``[P, n]``."""
    s_lo, s_hi = _counter_step(step)
    key = philox_key(seed)
    out = []
    for a in range((P + 1) // 2):
        bits = philox4x32_10((cell, s_lo, s_hi, a), key)
        out.append(box_muller(bits[0], bits[1]))
        if 2 * a + 1 < P:
            out.append(box_muller(bits[2], bits[3]))
    return torch.stack(out)


@traced_launch
def normals(seed: int, step: int, shape, device) -> torch.Tensor:
    """The standard normals ``[ny, nx]`` that the noisy kernels draw at
    global step ``step`` with key ``seed``.

    On a CUDA device this launches ``csrc/normals.cu`` (P1), counted in
    ``normals.launches``; on the CPU it runs :func:`normals_reference`.
    """
    ny, nx = (int(n) for n in shape)
    device = torch.device(device)
    if device.type == "cpu":
        return normals_reference(seed, step, ny, nx)
    out = torch.empty((ny, nx), dtype=torch.float32, device=device)
    if out.numel():
        _call_philox("lb2d_normals", out, ny * nx, seed, step)
        normals.launches += 1
    return out


normals.launches = 0


@traced_launch
def normals_per_cell(seed: int, step: int, shape, device) -> torch.Tensor:
    """:func:`normals` from P1's first one-cell-a-thread loop
    (``lb2d_normals_per_cell``), which :func:`normals` never launches: the
    tests hold P1 to it bit for bit. Counted in
    ``normals_per_cell.launches`` on CUDA; on the CPU it runs
    :func:`normals_reference`."""
    ny, nx = (int(n) for n in shape)
    device = torch.device(device)
    if device.type == "cpu":
        return normals_reference(seed, step, ny, nx)
    out = torch.empty((ny, nx), dtype=torch.float32, device=device)
    if out.numel():
        _call_philox("lb2d_normals_per_cell", out, ny * nx, seed, step)
        normals_per_cell.launches += 1
    return out


normals_per_cell.launches = 0

NORMALS_BLOCK = 256      # threads of a P1 block
NORMALS_MAX_BLOCKS = 65536


class NormalsSplit(NamedTuple):
    head: int     # cells before out's first 16-byte boundary, one a thread
    quads: int    # whole quads of 4 cells after them, one a thread
    ragged: int   # head and the cells after the last quad
    threads: int  # threads launched (a grid-stride loop covers the rest)


def normals_split(n: int, address: int) -> NormalsSplit:
    """How P1 (``csrc/normals.cu``: ``lb2d_normals``) cuts ``n`` cells of
    an ``out`` at byte ``address`` (4-byte aligned) into threads."""
    head = min(n, (16 - address % 16) % 16 // 4)
    quads = (n - head) // 4
    ragged = n - 4 * quads
    blocks = min(-(-max(quads, ragged) // NORMALS_BLOCK), NORMALS_MAX_BLOCKS)
    return NormalsSplit(head, quads, ragged, blocks * NORMALS_BLOCK)


def normals_thread_cells(split: NormalsSplit, n: int, g: int) -> list[int]:
    """The cells that thread ``g`` of P1 writes: its quads (``head + 4 q``
    and the three after it, for ``q = g, g + threads, ..``, each one 16-byte
    store), then one ragged cell if ``g < ragged``."""
    cells = []
    for q in range(g, split.quads, split.threads):
        cells += range(split.head + 4 * q, split.head + 4 * q + 4)
    if g < split.ragged:
        body = split.head + 4 * split.quads
        cells.append(g if g < split.head else body + g - split.head)
    return cells


@traced_launch
def philox_bits(seed: int, step: int, n: int, device) -> torch.Tensor:
    """The four Philox words of cells ``0 .. n-1`` at step ``step``, int64
    ``[4, n]``: the integer part of :func:`normals`, for holding the CUDA
    generator to the plain one bit for bit. Counted in
    ``philox_bits.launches`` on CUDA."""
    device = torch.device(device)
    if device.type == "cpu":
        s_lo, s_hi = _counter_step(step)
        return philox4x32_10((torch.arange(n, dtype=torch.int64), s_lo, s_hi,
                              0), philox_key(seed))
    out = torch.empty((4, n), dtype=torch.int32, device=device)
    if n:
        _call_philox("lb2d_philox_bits", out, n, seed, step)
        philox_bits.launches += 1
    return out.to(torch.int64) & _MASK32


philox_bits.launches = 0


def _call_philox(entry, out, n, seed, step):
    k0, k1 = philox_key(seed)
    _counter_step(step)  # range check
    fn = getattr(_build.load_library(), entry)
    err = fn(out.data_ptr(), n, k0, k1, int(step),
             torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
