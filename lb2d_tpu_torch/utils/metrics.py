"""Runtime self-checks and throughput metrics (counterpart of
``lb2d_tpu.utils.metrics``).

* :func:`mach_number` / :class:`MachWatchdog`: the ``check_max_ulb``
  stability watchdog (``porous_media/single_component.py:221-225``,
  ``screened_poisson_waves.py:347-351``).
* :func:`conservation_report`: the ``check_fields`` dump of per-field sums
  (``single_component.py:753-766``, ``multi.py:805-818``).
* :class:`MLUPSMeter`: wall-clock million lattice updates per second.

Reductions run on the tensors' device; only scalars come back to the host.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..core import D2Q9
from .checkpoint import tree_leaves
from .tracing import span, traced

__all__ = ["mach_number", "MachWatchdog", "accumulated_sum",
           "conservation_report", "MLUPSMeter"]


@traced("lb2d.readout.mach_number")
def mach_number(u, v, lattice=D2Q9) -> float:
    """max |u| / cs over the grid (device reduction, scalar readback)."""
    speed = torch.sqrt(torch.max(u * u + v * v))
    with span("lb2d.wait.mach_number"):
        return float(speed) / lattice.cs


class MachWatchdog:
    """Warn when flow speed exceeds ``tolerance * cs``
    (``single_component.py:221-225`` prints at 0.1 by default)."""

    def __init__(self, tolerance: float = 0.1, lattice=D2Q9):
        self.tolerance = tolerance
        self.lattice = lattice

    def check(self, u, v) -> float:
        ma = mach_number(u, v, self.lattice)
        if ma > self.tolerance:
            warnings.warn(
                f"Max Mach number {ma:.4f} exceeds tolerance "
                f"{self.tolerance}: simulation may be inaccurate/unstable",
                stacklevel=2)
        return ma


def accumulated_sum(x: torch.Tensor, accumulate: str = "f32") -> float:
    """Global sum of a tensor with selectable accumulation.

    ``"f32"``: one sum on the device (float32 accumulation loses digits
    over tens of millions of cells). ``"f64"``: the last axis is summed on
    the device in 128-element windows (when its length is a multiple of 128
    above 128, else whole rows) and the partials in float64 on the host:
    float64-grade totals for fields of homogeneous magnitude, where the
    reference is float64 (``single_component.cl:1-7``)."""
    if accumulate == "f64":
        nx = x.shape[-1]
        if nx % 128 == 0 and nx > 128:
            x = x.reshape(*x.shape[:-1], nx // 128, 128)
        parts = x.sum(dim=-1).detach()
        with span("lb2d.wait.accumulated_sum"):
            parts = parts.cpu().numpy().astype(np.float64)
        return float(parts.sum())
    total = x.sum()
    with span("lb2d.wait.accumulated_sum"):
        return float(total)


@traced("lb2d.readout.conservation_report")
def conservation_report(f, rho=None, feq=None,
                        accumulate: str = "f32") -> dict:
    """Sums of f (per direction collapsed), rho, feq: the ``check_fields``
    conservation dump, as host floats (``accumulate`` as in
    :func:`accumulated_sum`)."""
    out = {"sum_f": accumulated_sum(f, accumulate)}
    if rho is not None:
        out["sum_rho"] = accumulated_sum(rho, accumulate)
    if feq is not None:
        out["sum_feq"] = accumulated_sum(feq, accumulate)
    return out


@traced("lb2d.wait.synchronize")
def synchronize(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` (a
    tensor, or dicts, lists and tuples of them) has finished its work."""
    for device in {t.device for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class MLUPSMeter:
    """Throughput of a run function over a state."""

    def __init__(self, num_cells: int):
        self.num_cells = num_cells

    def measure(self, run_fn, state, num_steps: int):
        """``run_fn(state, n) -> state``; one warm step first, then
        ``num_steps`` on the host clock between two device synchronisations.
        Returns (state, mlups)."""
        state = run_fn(state, 1)
        synchronize(state)
        t0 = time.perf_counter()
        state = run_fn(state, num_steps)
        synchronize(state)
        dt = time.perf_counter() - t0
        return state, self.num_cells * num_steps / dt / 1e6
