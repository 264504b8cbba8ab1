"""Profiling helpers (counterpart of ``lb2d_tpu.utils.profiling``): a
``torch.profiler`` trace and step timing."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from .metrics import synchronize

__all__ = ["trace", "time_steps"]


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` (host and, where
    there is a card, device activity) and write a Chrome trace,
    ``<logdir>/trace.json`` (default: ``lb2d_trace`` in the temporary
    directory); yields ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "lb2d_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_steps(model, num_steps: int = 100, repeats: int = 3):
    """Wall-clock a model's ``run`` and return per-step milliseconds and
    MLUPS for each repeat (after one warm step), each timed between two
    device synchronisations."""
    model.run(1)
    synchronize(model.state)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        model.run(num_steps)
        synchronize(model.state)
        dt = time.perf_counter() - t0
        out.append({
            "ms_per_step": dt * 1000 / num_steps,
            "mlups": model.num_cells * num_steps / dt / 1e6,
        })
    return out
