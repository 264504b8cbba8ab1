"""K5's cone plan and P1's split of cells into threads, on the CPU.

The kernels (``csrc/multifield_step.cu``: ``band_cone_kernel``,
``csrc/normals.cu``: ``normals_kernel``) run only on the card. Their plans
are mirrored in Python (:mod:`lb2d_tpu_torch.ops.band_plan`,
:func:`lb2d_tpu_torch.ops.random.normals_split`); here those numbers are
checked for every case the wrappers take, and K5's schedule is emulated
with them in plain torch: each block's levels, only the cone of cells that
reaches its strip of outputs, every level computed by the plain
per-cell Expansion update (:func:`expansion_step_reference` on the level
below, cropped) with the noise of each cell's global index. The emulation
must equal :func:`expansion_band_reference` bit for bit, noise on, as the
kernel must on the card (``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

from lb2d_tpu_torch.core import D2Q9
from lb2d_tpu_torch.ops import band_plan
from lb2d_tpu_torch.ops.fused import (
    MAX_MULTIFIELD_FIELDS,
    band_max_k,
    expansion_band_reference,
    expansion_step_reference,
)
from lb2d_tpu_torch.ops.random import (
    normals,
    normals_per_cell,
    normals_split,
    normals_thread_cells,
    population_normals_at,
)
from lb2d_tpu_torch.ops.sweep import SMEM_PER_BLOCK

NXS = [1, 7, 37, 382, 1024, 8192]


def _old_band_max_k(F):
    """The first K5's limit (32 x 32, 24^2, 16^2 tiles by F)."""
    return 8 if F <= 5 else 4


@pytest.mark.parametrize("nx", NXS)
@pytest.mark.parametrize("F", range(1, MAX_MULTIFIELD_FIELDS + 1))
def test_band_plan_fits_and_writes_every_output_once(F, nx):
    """For every K the wrapper takes and bands of 4K and 4K + 5 rows: the
    strips cover the columns with the widest strip that fits, the levels
    are the cone of the 2K x W outputs, level 1's pulls stay inside the
    band, the buffers fit, and each output cell has exactly one thread."""
    assert band_max_k(F) >= _old_band_max_k(F)
    for k in range(1, band_max_k(F) + 1):
        p = band_plan.plan(F, k, nx)
        assert p is not None
        w = p.width
        assert 1 <= w <= -(-nx // band_plan.BLOCKS)
        assert p.strips == -(-nx // w) and (p.strips - 1) * w < nx
        widest = -(-nx // band_plan.BLOCKS)
        if w < widest:  # one column more would not fit
            assert (band_plan.threads(k, w + 1) > band_plan.THREADS
                    or band_plan.smem_bytes(F, k, w + 1) > SMEM_PER_BLOCK)
        cells = [band_plan.level_rows(k, s) * band_plan.level_cols(k, s, w)
                 for s in range(1, k + 1)]
        assert p.threads == -(-cells[0] // 32) * 32 <= band_plan.THREADS
        assert max(cells) == cells[0]
        buffers = 9 * F * 4 * sum(cells[s - 1] for s in (1, 2) if s < k)
        assert p.smem == buffers <= SMEM_PER_BLOCK
        for rows in (4 * k, 4 * k + 5):
            out0 = (rows - 2 * k) // 2
            for s in range(1, k + 1):
                h = k - s  # steps left after level s: the cone's halo
                lo, hi = out0 - h, out0 + 2 * k + h
                assert band_plan.level_rows(k, s) == hi - lo
                assert band_plan.level_cols(k, s, w) == w + 2 * h
            # level 1 pulls band rows [out0 - k, out0 + 3k): no band wrap
            assert 0 <= out0 - k and out0 + 3 * k <= rows
        # the last level: thread t of block b writes output (r, b w + c)
        C = band_plan.level_cols(k, k, w)
        t = np.arange(p.threads)
        r, c = t // C, t % C
        writes = np.zeros(2 * k * nx, np.int64)
        for b in range(p.strips):
            x = b * w + c
            ok = (t < 2 * k * C) & (x < nx)
            np.add.at(writes, r[ok] * nx + x[ok], 1)
        assert (writes == 1).all()


def test_band_plan_fills_the_card_at_the_main_paths_band():
    """The 1024^2 Expansion's band (F = 3, K = 4): at least 128 blocks,
    one cell a thread at each level (14 x 14 at level 1)."""
    p = band_plan.plan(3, 4, 1024)
    assert p.strips >= 128
    assert p.width == 8 and p.threads == 224
    assert band_plan.level_rows(4, 1) == band_plan.level_cols(4, 1, 8) == 14
    assert p.smem == 9 * 3 * 4 * (14 * 14 + 12 * 12)


def _expansion(F, ny, nx):
    """A random band state (densities in [0, 0.3], many below the 0.01
    cutoff, the nutrient in [0, 1]) and Expansion constants with noise on
    every population but the second."""
    rs = np.random.RandomState(F + nx)
    P = F - 1
    rho = 0.3 * rs.rand(F, ny, nx) ** 2
    rho[-1] = rs.rand(ny, nx)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    f = torch.tensor(w * rho * (1.0 + 0.01 * rs.randn(9, F, ny, nx)),
                     dtype=torch.float32)
    args = ((1.9 + 0.09 * rs.rand(P)).astype(np.float32), np.float32(1.95),
            (1e-4 * (1 + rs.rand(P))).astype(np.float32),
            np.where(np.arange(P) == 1, 0.0,
                     0.02 * (1 + rs.rand(P))).astype(np.float32),
            0.01, 0.0021, -0.0013)
    return f, args


def _emulate_band(band, k, args, *, seed, step0, row0, ny):
    """K5's blocks as the kernel runs them: block b's level s is the cone
    region of halo k - s, computed from the level below (level 0: the band)
    by the plain per-cell update, each cell with its global noise."""
    F, rows, nx = band.shape[1], band.shape[2], band.shape[3]
    p = band_plan.plan(F, k, nx)
    w, out0 = p.width, (rows - 2 * k) // 2
    out = torch.full((9, F, 2 * k, nx), float("nan"))
    for b in range(p.strips):
        xs = b * w
        cols = torch.arange(xs - k, xs + w + k) % nx
        prev = band[:, :, out0 - k:out0 + 3 * k][..., cols]
        for s in range(1, k + 1):
            h = k - s
            R, C = band_plan.level_rows(k, s), band_plan.level_cols(k, s, w)
            assert prev.shape[2:] == (R + 2, C + 2) and R * C <= p.threads
            gy = (row0 + torch.arange(out0 - h - 1, out0 + 2 * k + h + 1)) % ny
            gx = torch.arange(xs - h - 1, xs + w + h + 1) % nx
            cells = (gy[:, None] * nx + gx[None, :]).reshape(-1)
            eta = population_normals_at(seed, step0 + s - 1, F - 1,
                                        cells).reshape(F - 1, R + 2, C + 2)
            prev = expansion_step_reference(prev, *args, seed=seed,
                                            step=step0 + s - 1,
                                            eta=eta)[:, :, 1:-1, 1:-1]
        keep = min(w, nx - xs)  # the ragged strip writes no column >= nx
        out[..., xs:xs + keep] = prev[..., :keep]
    return out


BAND_CASES = [(2, 1), (3, 2), (3, 4), (5, 3), (MAX_MULTIFIELD_FIELDS, 2)]


@pytest.mark.parametrize("nx", [7, 37, 259])
@pytest.mark.parametrize("extra", [0, 5], ids=["R=4K", "R=4K+5"])
@pytest.mark.parametrize("F,k", BAND_CASES,
                         ids=[f"F={F}-K={k}" for F, k in BAND_CASES])
def test_emulated_cone_equals_the_plain_band_step(F, k, extra, nx):
    """The cone schedule, every level from the plain per-cell update, equals
    K plain steps of the whole band bit for bit, noise on (the step just
    below 2^32, so the K steps cross into the counter's high word; 259
    columns make a ragged last strip of one column)."""
    rows, ny = 4 * k + extra, 97
    band, args = _expansion(F, rows, nx)
    kw = dict(seed=2**40 + 7, step0=2**32 - 2, row0=ny - rows // 2, ny=ny)
    got = _emulate_band(band, k, args, **kw)
    want = expansion_band_reference(band, k, *args, **kw)
    assert torch.equal(got, want)


NORMALS_NS = [1, 3, 4, 5, 254 * 382, 2049 * 7]


@pytest.mark.parametrize("n", NORMALS_NS)
def test_normals_split_covers_each_cell_once(n):
    """P1's threads write every cell once, at each alignment of ``out``
    (its byte address mod 16), the quads with 16-byte stores; also with
    fewer threads than quads (the grid-stride loop past 65,536 blocks)."""
    for offset in (0, 4, 8, 12):
        address = 4096 + offset
        split = normals_split(n, address)
        assert split.head == min(n, (16 - offset) % 16 // 4)
        assert split.head + 4 * split.quads + (split.ragged - split.head) == n
        assert 0 <= split.ragged - split.head <= 3
        for threads in (split.threads, 64):
            cut = split._replace(threads=threads)
            seen = np.zeros(n, np.int64)
            for g in range(max(threads, split.ragged)):
                cells = normals_thread_cells(cut, n, g)
                np.add.at(seen, cells, 1)
                quads = cells[:len(cells) // 4 * 4]
                for i in quads[::4]:  # each quad's store is 16-byte aligned
                    assert (address + 4 * i) % 16 == 0
            assert (seen == 1).all()


def test_normals_per_cell_is_the_plain_version_on_the_cpu():
    """The kept one-cell-a-thread entry runs the plain normals on the CPU,
    as :func:`normals` does."""
    for shape in ((1, 1), (3, 5)):
        assert torch.equal(normals_per_cell(12345, 2**32 + 1, shape, "cpu"),
                           normals(12345, 2**32 + 1, shape, "cpu"))
