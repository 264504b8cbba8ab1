"""The traced run: ``torch.profiler`` over the measured window, its device
activity read back from the exported trace, and the spans the benchmark
records around its own calls into the port (``lbbench.window``,
``lbbench.run``, ``lbbench.readout``). Per-layer metrics read a
:class:`Context`.

The trace is written under a directory made with ``tempfile.mkdtemp`` (in
``TMPDIR``) and deleted once read.
"""

import contextlib
import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass, field

import torch

WINDOW, RUN, READOUT = "lbbench.window", "lbbench.run", "lbbench.readout"
_LAUNCH = re.compile(r"Launch(Cooperative)?Kernel")


class Tracer:
    """``torch.profiler`` with CPU and CUDA activity while enabled; spans
    as ``record_function`` ranges. Disabled, it records nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        if enabled:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def finish(self) -> "Trace":
        """Stop the profiler and read its trace."""
        self.prof.stop()
        tmp = tempfile.mkdtemp(prefix="lbbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return Trace(events)


class Trace:
    """The device's kernels and copies, the host's kernel launches and the
    benchmark's spans, as ``(name, start, end)`` in microseconds of the
    trace's clock."""

    def __init__(self, events):
        self.kernels, self.copies, self.spans = [], [], {}
        self.launches = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e.get("ts", 0.0))
            t1 = t0 + float(e.get("dur", 0.0))
            if cat == "kernel":
                self.kernels.append((name, t0, t1))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                self.copies.append((name, t0, t1))
            elif cat in ("cuda_runtime", "cuda_driver") and _LAUNCH.search(name):
                self.launches.append(t0)
            elif cat == "user_annotation":
                self.spans.setdefault(name, []).append((t0, t1))
        self.kernels.sort(key=lambda k: k[1])
        self.copies.sort(key=lambda k: k[1])
        self.launches.sort()
        win = self.spans.get(WINDOW, [])
        self.window = win[0] if win else None

    def inside(self, items):
        """The events of ``items`` that start inside the window."""
        if self.window is None:
            return []
        lo, hi = self.window
        return [e for e in items if lo <= e[1] <= hi]

    def busy_intervals(self):
        """The union of kernel and copy intervals inside the window, as
        sorted disjoint ``(start, end)``."""
        lo, hi = self.window
        spans = sorted((max(t0, lo), min(t1, hi))
                       for _, t0, t1 in self.inside(self.kernels + self.copies))
        merged = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged


@dataclass
class Context:
    """What a per-layer metric reads: the trace, the cell and the counts of
    the traced window."""
    trace: Trace
    config: str
    mix: dict
    cells: int
    ny: int
    nx: int
    intervals: int
    steps: int
    work: dict = field(default_factory=dict)       # family -> _counts.Work
    families: dict = field(default_factory=dict)   # name -> module

    @property
    def window_s(self) -> float:
        lo, hi = self.trace.window
        return (hi - lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.trace.busy_intervals()) * 1e-6

    def step_kernel(self, name: str) -> bool:
        """Whether a kernel belongs to a family of ``lbbench/kernels``."""
        return any(re.search(m.PATTERN, name) for m in self.families.values())

    def family_seconds(self, family: str) -> float:
        pattern = re.compile(self.families[family].PATTERN)
        return sum(t1 - t0 for name, t0, t1 in self.trace.inside(
            self.trace.kernels) if pattern.search(name)) * 1e-6


def breakdown(ctx: Context) -> dict:
    """The ten device operations that took most time in the window, and
    the ten longest idle gaps by the benchmark's span that the host was in
    when the device went idle."""
    tr = ctx.trace
    per_op = {}
    for name, t0, t1 in tr.inside(tr.kernels + tr.copies):
        short = re.sub(r"^void |\(anonymous namespace\)::", "", name)
        short = re.sub(r"\(.*$", "", short)[:120]
        per_op[short] = per_op.get(short, 0.0) + (t1 - t0) * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    busy = tr.busy_intervals()
    lo, hi = tr.window
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((t0, t1, name) for name in (RUN, READOUT)
                  for t0, t1 in tr.spans.get(name, []))

    def doing(t):
        for t0, t1, name in host:
            if t0 <= t <= t1:
                return name.split(".", 1)[1]
        return "between spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[doing(g0), (g1 - g0) * 1e-6] for g0, g1 in longest]}
