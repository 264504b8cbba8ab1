"""Check the port's spans (``lb2d_tpu_torch.utils.tracing``) on the card,
in the benchmark's cells (``lbbench/``), and time what a span costs.

    python3 tools/trace_spans.py waits <workload> [<workload> ...]
    python3 tools/trace_spans.py clock <seed> <seconds> <workload> [...]
    python3 tools/trace_spans.py cost

``waits``: builds each cell as the benchmark does, runs one interval (the
cell's ``run(M)``, its monitoring readout and a snapshot) to warm up, then
one under ``torch.cuda.set_sync_debug_mode("warn")`` and ``torch.profiler``
together. Prints, per cell, every place the sync debug mode reported (the
innermost frame of the port and the frame that called into the port, or
the benchmark's own frame), and classifies each blocking call of the CUDA
runtime in the trace (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaMemcpy``, ``cudaEventSynchronize``) by the innermost span around it:
``lb2d.wait.*`` (the port's wait spans), another ``lb2d.*`` span (a wait
of the port's that no wait span holds: a fault), or the benchmark's own
spans only (the benchmark's waits).

``clock``: one traced run of each cell through the benchmark
(``harness.run_cell(..., trace=True)``), its trace kept, and two checks
of one clock: every ``lb2d.run`` span lies inside a ``lbbench.run`` span;
every kernel launched inside an ``lb2d.launch.*`` span (the CUDA
runtime's launch, matched to its kernel by the trace's correlation id)
starts on the device after the span starts. Prints the run's metrics.

``cost``: microseconds per call of a function whose body is a ``span``, of
a ``traced`` function and of a plain one, with no profiler running and with
one recording, on this host.

Prints one JSON line per cell (``cost``: one line).
"""

import bisect
import contextlib
import json
import re
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lbbench import harness, trace as lbtrace  # noqa: E402

BLOCKING = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaEventSynchronize"}
LAUNCH = re.compile(r"Launch(Cooperative)?Kernel")


def emit(record):
    print(json.dumps(record), flush=True)


def _frame(fs):
    return f"{Path(fs.filename).name}:{fs.lineno} {fs.name}"


def _site(stack):
    """The innermost frame in the port and the frame that called into it;
    else the innermost frame of the benchmark."""
    port = [i for i, fs in enumerate(stack) if "lb2d_tpu_torch" in fs.filename]
    if port:
        inner, outer = port[-1], port[0]
        caller = stack[outer - 1] if outer > 0 else stack[outer]
        return f"{_frame(stack[inner])} <- {_frame(caller)}"
    bench = [fs for fs in stack if "lbbench" in fs.filename]
    return f"benchmark {_frame(bench[-1])}" if bench else _frame(stack[-1])


def _cell(workload):
    spec = harness.cell_spec(workload)
    cfg = harness.load_config(spec["config"])
    mix = harness.load_mix(spec["traffic"])
    return cfg.Cell(mix, 2**31 + 19, torch.device("cuda"))


def _interval(cell, snaps):
    with torch.profiler.record_function(lbtrace.RUN):
        cell.run()
    with torch.profiler.record_function(lbtrace.READOUT):
        cell.monitor()
        cell.snapshot(snaps)


def _innermost(t, spans):
    around = [s for s in spans if s[1] <= t <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


def waits(workload):
    cell = _cell(workload)
    snaps = cell.snapshot_buffers()
    _interval(cell, snaps)
    torch.cuda.synchronize()
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            site = _site(traceback.extract_stack()[:-1])
            sites[site] = sites.get(site, 0) + 1

    tracer = lbtrace.Tracer(True)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _interval(cell, snaps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    with _kept_events() as events:
        tracer.finish()
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    kinds = {"lb2d.wait": 0, "lb2d other": 0, "benchmark only": 0}
    unheld = []
    for e in events:
        if e.get("cat") != "cuda_runtime" or e["name"] not in BLOCKING:
            continue
        inner = _innermost(e["ts"], spans) or ""
        lb2d = [s for s in spans if s[0].startswith("lb2d.")
                and s[1] <= e["ts"] <= s[2]]
        if inner.startswith("lb2d.wait."):
            kinds["lb2d.wait"] += 1
        elif lb2d:
            kinds["lb2d other"] += 1
            unheld.append(f"{e['name']} in {inner}")
        else:
            kinds["benchmark only"] += 1
    wait_names = sorted({s[0] for s in spans if s[0].startswith("lb2d.wait.")})
    emit({"mode": "waits", "workload": workload, "sync_debug_sites": sites,
          "blocking_calls": kinds, "not_in_a_wait_span": unheld,
          "wait_spans": wait_names, "card": _card()})
    cell.close()


@contextlib.contextmanager
def _kept_events():
    """The complete events of every trace the benchmark reads while this
    is open (``lbbench.trace.Trace`` keeps only its own digest)."""
    kept = []

    class Keep(lbtrace.Trace):
        def __init__(self, events):
            super().__init__(events)
            kept.extend(e for e in events if e.get("ph") == "X")

    real, lbtrace.Trace = lbtrace.Trace, Keep
    try:
        yield kept
    finally:
        lbtrace.Trace = real


def _around(t, intervals):
    """The last of the sorted, non-overlapping ``intervals`` that starts at
    or before ``t``, if it ends at or after ``t``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return intervals[i] if i >= 0 and intervals[i][1] >= t else None


def clock(workload, seed, seconds):
    with _kept_events() as kept:
        result, _ = harness.run_cell(workload, seed, seconds, trace=True)
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in kept
             if e.get("cat") == "user_annotation"]
    bench_runs = sorted(s[1:] for s in spans if s[0] == lbtrace.RUN)
    runs = [s[1:] for s in spans if s[0] == "lb2d.run"]
    runs_outside = sum(_around(r[0], bench_runs) is None
                       or _around(r[0], bench_runs)[1] < r[1] for r in runs)
    kernel_start = {e["args"]["correlation"]: e["ts"] for e in kept
                    if e.get("cat") == "kernel"
                    and "correlation" in e.get("args", {})}
    launch_spans = sorted(s[1:] for s in spans
                          if s[0].startswith("lb2d.launch."))
    window = next(s[1:] for s in spans if s[0] == lbtrace.WINDOW)
    lead, early, tail, tenths = [], [], [], [[] for _ in range(10)]
    for e in kept:
        if (e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or not LAUNCH.search(e["name"])):
            continue
        around = _around(e["ts"], launch_spans)
        corr = e.get("args", {}).get("correlation")
        if around is None or corr not in kernel_start:
            continue
        # the kernel's start after its launch call's start: a few us at
        # least on an idle card; the span's end after the call's end: the
        # host's return through the wrapper
        gap = kernel_start[corr] - e["ts"]
        lead.append(gap)
        tail.append(around[1] - (e["ts"] + e["dur"]))
        if kernel_start[corr] <= around[0]:
            early.append(around[0] - kernel_start[corr])
        k = int(10 * (e["ts"] - window[0]) / (window[1] - window[0]))
        tenths[min(max(k, 0), 9)].append(gap)
    emit({"mode": "clock", "workload": workload, "seed": seed,
          "lb2d_run_spans": len(runs), "lb2d_run_outside_lbbench_run":
          runs_outside, "launches_checked": len(lead),
          "kernel_started_before_its_launch_span": len(early),
          "span_start_minus_kernel_start_us": _quantiles(early),
          "kernel_start_minus_launch_call_us": _quantiles(lead),
          "least_by_tenth_of_window_us": [min(t) if t else None
                                          for t in tenths],
          "span_end_minus_launch_call_end_us": _quantiles(tail),
          "correct": result["correct"], "metrics": result["metrics"],
          "device": result["device"], "breakdown": result["breakdown"]})


def _quantiles(values):
    """The least, the 1st, 10th and 50th percentiles and the largest."""
    if not values:
        return None
    v = sorted(values)
    return [v[min(int(q * len(v)), len(v) - 1)]
            for q in (0, 0.01, 0.1, 0.5)] + [v[-1]]


def cost():
    from lb2d_tpu_torch.utils import tracing

    @tracing.traced("lb2d.cost")
    def traced_call():
        return None

    def plain_call():
        return None

    def per_call(fn, n):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def with_span():
        with tracing.span("lb2d.cost"):
            pass

    out = {"mode": "cost", "card": _card()}
    for label, n in (("off", 200_000), ("on", 20_000)):
        prof = None
        if label == "on":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        rounds = {name: sorted(per_call(fn, n) for _ in range(5))[2]
                  for name, fn in (("span_us", with_span),
                                   ("traced_call_us", traced_call),
                                   ("plain_call_us", plain_call),
                                   ("recording_check_us", tracing.recording))}
        if prof is not None:
            prof.stop()
        out[label] = rounds
    emit(out)


def _card():
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": harness.power_limit_w(0),
            "torch": torch.__version__}


def main(argv):
    mode = argv[0]
    if mode == "waits":
        for w in argv[1:]:
            waits(w)
    elif mode == "clock":
        seed, seconds = int(argv[1]), float(argv[2])
        for w in argv[3:]:
            clock(w, seed, seconds)
    elif mode == "cost":
        cost()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
