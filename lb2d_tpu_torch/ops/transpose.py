"""P2: the transpose of a float32 matrix (counterpart of
``benchmarks/probe_transpose.py``).

:func:`transpose` ports ``make_tr`` (``benchmarks/probe_transpose.py:28``,
its ``pl.pallas_call`` at ``:32``), a TPU probe that moves ``[128, n]``
row tiles of ``A [W, n]`` through VMEM into ``[n, 128]`` column tiles of
``A^T``. On Hopper (``csrc/transpose.cu``) a block moves one 32 x 32 tile
through shared memory, padded to 33 columns, with coalesced reads and
writes. It lies on no model path: it prices a transpose for a sharded or
row-pass-only screened solve (K8's column passes, ``PERF.md``).

On CUDA tensors :func:`transpose` launches the kernel, counted in
``transpose.launches``; on CPU tensors it runs the plain version,
:func:`transpose_reference` (``x.t().contiguous()``), which is also the
library call the kernel is timed against.
"""

from __future__ import annotations

import torch

from ..utils.tracing import traced_launch
from .fused import _launch

__all__ = ["transpose", "transpose_reference"]


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` ``[n, W]`` of ``x [W, n]`` as a new contiguous tensor."""
    return x.t().contiguous()


@traced_launch
def transpose(x: torch.Tensor, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """``x [W, n]`` (float32, contiguous) transposed into ``out [n, W]``
    (allocated when None) and returned. Exact: equal bit for bit to
    :func:`transpose_reference`."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 matrix, got "
                         f"{x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if out is None:
        out = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != (cols, rows) or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 [{cols}, {rows}] on "
                         f"{x.device}")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must be a distinct tensor")
    if x.device.type == "cpu":
        return out.copy_(transpose_reference(x))
    with torch.cuda.device(x.device):
        _launch("lb2d_transpose", x, out, rows, cols)
    transpose.launches += 1
    return out


transpose.launches = 0
