"""One run of one cell: build, warm up, measure, check, print.

A run builds (or loads) the port's kernels through the configuration's
model (``lb2d_tpu_torch.ops._build``, whose library lives in the
checkout's ``lb2d_tpu_torch/_build/``), makes the initial state on the
card from ``--seed``, runs one interval of the cell's own shapes as the
warm-up, then intervals for ``--seconds``: each ``run(M)`` and the
monitoring readout, every ``snapshot_every``-th a snapshot. It checks what
the window produced against the plain reference (``lbbench/check.py``)
and prints one JSON line. With ``--trace 1`` the window runs under
``torch.profiler`` and the line holds the per-layer metrics instead of
the end-to-end ones.
"""

import argparse
import gc
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lbbench import check
from lbbench.trace import READOUT, RUN, WINDOW, Context, Tracer, breakdown

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "lbbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lb2d_tpu"})
_T_IMPORT = time.monotonic()


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_mix(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def load_limits(workload: str) -> dict:
    return load_json(BENCH / "limits" / f"{workload}.json")


def load_config(name: str):
    return importlib.import_module(f"lbbench.configs.{name}")


def load_reference(name: str):
    return importlib.import_module(f"lbbench.reference.{name}")


def load_metric(name: str):
    """The reader ``lbbench/metrics/<name>.py`` (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "lbbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def families() -> dict:
    """Every kernel family of ``lbbench/kernels`` by name."""
    return {p.stem: importlib.import_module(f"lbbench.kernels.{p.stem}")
            for p in sorted((BENCH / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}


def per_layer_metrics(workload: str, bench: dict) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif workload in e2e[m["moves"]].get("workloads", [workload]):
            out.append(m)
    return out


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this module
    was imported where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules() -> list:
    """The JAX modules and the JAX package loaded in this process, compared
    by whole top-level name (``lb2d_tpu_torch`` is not ``lb2d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _refuse_forbidden():
    leaked = forbidden_modules()
    if leaked:
        raise ForbiddenImport(leaked)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_interval(seed: int, mix: dict) -> int:
    """The window's interval whose readouts are checked, drawn from the
    seed among the mix's ``check_intervals``."""
    choices = mix["check_intervals"]
    return choices[random.Random(seed).randrange(len(choices))]


def run_cell(workload, seed, seconds, trace=False, device="cuda",
             mix_override=None, fault=None, bench=None, readings=None,
             limits=None):
    """Run ``workload`` once; return ``(result, checks_text)``: the result
    line's dict and the lines that give each number compared beside its
    limit. ``readings``, a dict, receives every number, compared or not.
    ``fault(cell)`` breaks the timed path after the cell is built (the
    tests' and ``lbbench/faults.py``'s); ``limits`` replaces the cell's
    ``lbbench/limits/<workload>.json``. Raises :class:`ForbiddenImport`
    where JAX or the JAX package is loaded once the window has closed or
    once the check and the readers have run."""
    bench = bench or benchmark()
    spec = cell_spec(workload, bench)
    cfg = load_config(spec["config"])
    ref = load_reference(spec["config"])
    mix = dict(load_mix(spec["traffic"]), **(mix_override or {}))
    limits = load_limits(workload) if limits is None else limits
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    cell = cfg.Cell(mix, seed, device)
    if fault is not None:
        fault(cell)
    M, every = cell.steps_per_interval, int(mix["snapshot_every"])
    j = check_interval(seed, mix)
    snaps, snap_j = cell.snapshot_buffers(), cell.snapshot_buffers()
    held_j = getattr(cell, "held_buffers", dict)()
    warm = torch.empty_like(cell.state())
    pre = torch.empty_like(warm)

    # warm-up: one interval of the cell's own shapes, snapshot included
    cell.run()
    cell.monitor()
    cell.snapshot(snaps)
    warm.copy_(cell.state())
    _sync(device)

    tracer = Tracer(trace)
    setup_s = process_age()
    times, monitors = [], []
    mon_j = None
    i = 0
    with tracer.span(WINDOW):
        t_start = time.perf_counter()
        while i <= j or time.perf_counter() - t_start < seconds:
            if i == j:
                pre.copy_(cell.state())
            t0 = time.perf_counter()
            with tracer.span(RUN):
                cell.run()
            with tracer.span(READOUT):
                mon = cell.monitor()
                if i % every == 0:
                    cell.snapshot(snap_j if i == j else snaps)
            times.append(time.perf_counter() - t0)
            monitors.append(mon)
            if i == j:
                mon_j = mon
                if held_j:
                    cell.held(held_j)
            i += 1
        _sync(device)
        t_end = time.perf_counter()
    window = t_end - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    _refuse_forbidden()
    traced = tracer.finish() if trace else None

    info = dict(config=spec["config"], mix=mix, cells=cell.cells,
                ny=cell.ny, nx=cell.nx, work=cfg.work(mix))
    inputs = cell.inputs
    cell.close()
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    out = {"warm": warm, "pre": pre, "snap": snap_j, "mon": mon_j,
           "held": held_j}
    values = check.readings(ref, mix, inputs, out, device)
    del out, warm, pre, held_j
    if readings is not None:
        readings.update(values)
    failed = sum(not np.all(np.isfinite(m)) for m in monitors)
    correct, checks = check.verdict(values, limits)
    correct = correct and failed == 0

    intervals = len(times)
    result = {"correct": bool(correct), "attempted": intervals,
              "failed": int(failed)}
    if not trace:
        result["metrics"] = {
            "mlups": {"value": info["cells"] * M * intervals / window / 1e6,
                      "unit": "MLUPS"},
            "interval_p95_ms": {
                "value": float(np.percentile(times, 95)) * 1e3, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        ctx = Context(trace=traced, intervals=intervals, steps=intervals * M,
                      families=families(), **info)
        metrics = {}
        for m in per_layer_metrics(workload, bench):
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        result["breakdown"] = breakdown(ctx)
    result["checks"] = checks
    lines = [f"intervals in the window: {intervals} (p95 over all of them), "
             f"interval checked: {j}, steps per interval: {M}"]
    lines += [f"reading {name} (not compared): {v!r}"
              for name, v in sorted(values.items()) if name not in checks]
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    _refuse_forbidden()
    return result, lines


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the process that measured: "
                         + ", ".join(names))
        self.names = names


def power_limit_w(index: int):
    """The card's power limit in watts from ``nvidia-smi`` (roofline shares
    are stated against the 700 W data sheet), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device, peak) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak),
                "power_limit_w": power_limit_w(device.index or 0)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards_missing(spec) -> str | None:
    """Why the cell cannot run here (no CUDA device, or fewer than it
    asks for), or None."""
    if not torch.cuda.is_available():
        return ("no CUDA device: torch.cuda.is_available() is False; the "
                "benchmark runs only on the card")
    if torch.cuda.device_count() < spec["chips"]:
        return (f"{spec['name']} needs {spec['chips']} CUDA devices, "
                f"{torch.cuda.device_count()} found")
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = benchmark()
    spec = cell_spec(args.workload, bench)
    missing = cards_missing(spec)
    if missing:
        print(missing, file=sys.stderr)
        return 2
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds,
                                 trace=bool(args.trace), device="cuda",
                                 bench=bench)
        # last: nothing that ran after the window (the check, the readers,
        # a module they import) may have loaded JAX or the JAX package
        _refuse_forbidden()
    except ForbiddenImport as e:
        print(f"forbidden modules: {', '.join(e.names)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    for line in lines:
        print(line, file=sys.stderr)
    return 0
