"""CPU tests of the readers of the port's spans (``launch_host_us``,
``run_wait_ms``, ``idle_launch_pct``, ``idle_readout_pct``) on a made-up
trace with known answers, on a trace without the port's spans (a program
that records none: each reads nothing), and on a traced run of each cell
at its CPU size (``tests/tiny/<workload>.json``)."""

import functools

import pytest

from lbbench import harness, spans
from lbbench.tests import _tiny
from lbbench.trace import READOUT, RUN, WINDOW, Context, Trace

SPAN_METRICS = ("launch_host_us", "run_wait_ms", "idle_launch_pct",
                "idle_readout_pct")
# the span metrics that a CPU run reads: there no kernel runs and the
# eager path calls no wrapper, so the wrapper spans and the idle shares
# are the card's alone
CPU_READS = ("run_wait_ms",)
# the cells each span metric lists: a cell may join a list, none leaves it
LISTED = ("pipe_flow.open_4096", "porous_two_fluid.8192",
          "pipe_flow.poiseuille_32x256", "pipe_flow.cylinder_n125")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}

pytestmark = pytest.mark.filterwarnings("ignore:Max Mach number")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _trace(port_spans=True):
    """A 1000 us window of two intervals (at 0 and 500). Each: two wrapper
    spans of 10 us (5-15, 20-30), each around one launch; a 20 us wait
    (40-60) inside ``lb2d.run`` (1-99); two kernels, 12-120 and 120-250;
    the field readout 260-300 with a wait nested in it (270-280), outside
    ``lb2d.run``; a copy to the host 300-310. The device idles 0-12,
    250-300 and from 310 to the next interval's first kernel. Outside the
    window: a wrapper span and its launch at -50."""
    ev = [_span(WINDOW, 0, 1000)]
    if port_spans:
        ev += [_span("lb2d.launch.temporal_pipe_step", -50, 10)]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", -45, 1)]
    for t in (0, 500):
        ev += [_span(RUN, t, 100), _span(READOUT, t + 100, 300)]
        if port_spans:
            ev += [_span("lb2d.run", t + 1, 98),
                   _span("lb2d.launch.temporal_pipe_step", t + 5, 10),
                   _span("lb2d.launch.temporal_pipe_step", t + 20, 10),
                   _span("lb2d.wait.synchronize", t + 40, 20),
                   _span("lb2d.readout.field.u", t + 260, 40),
                   _span("lb2d.wait.c_consts", t + 270, 10)]
        ev += [_x("cuda_runtime", "cudaLaunchKernel", t + 10, 1),
               _x("cuda_runtime", "cudaLaunchKernel", t + 25, 1),
               _x("kernel", "void temporal_step_kernel<0>(float*)", t + 12,
                  108),
               _x("kernel", "void temporal_step_kernel<0>(float*)", t + 120,
                  130),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t + 300,
                  10)]
    return Trace(ev)


def _ctx(trace):
    return Context(trace=trace, config="pipe_flow", mix={}, cells=100 * 100,
                   ny=100, nx=100, intervals=2, steps=8)


def _read(ctx):
    return {m: harness.load_metric(m).read(ctx) for m in SPAN_METRICS}


def test_span_readers_on_a_made_up_trace():
    read = _read(_ctx(_trace()))
    assert read["launch_host_us"] == pytest.approx(40 / 4)
    assert read["run_wait_ms"] == pytest.approx(20e-3)
    assert read["idle_launch_pct"] == pytest.approx(100 * 2 * 7 / 1000)
    assert read["idle_readout_pct"] == pytest.approx(100 * 2 * 40 / 1000)


def test_span_readers_read_nothing_without_the_ports_spans():
    assert _read(_ctx(_trace(port_spans=False))) == dict.fromkeys(
        SPAN_METRICS)


def test_span_readers_read_nothing_without_a_window():
    assert _read(_ctx(Trace([_span("lb2d.run", 0, 10)]))) == dict.fromkeys(
        SPAN_METRICS)


def test_interval_measures():
    a = spans.union([(5, 8), (0, 2), (1, 3), (7, 9)])
    assert a == [(0, 3), (5, 9)]
    assert spans.intersect(a, [(2, 6), (8, 20)]) == [(2, 3), (5, 6), (8, 9)]
    assert spans.length(a) == 7
    assert spans.count_inside([0, 3, 4, 6, 9, 10], a) == 4
    tr = _trace()
    assert spans.idle(tr) == [(0, 12), (250, 300), (310, 512), (750, 800),
                              (810, 1000)]
    assert spans.named(tr, "lb2d.wait.") == [(40, 60), (270, 280),
                                             (540, 560), (770, 780)]


@functools.cache
def _traced_metrics(workload):
    """The per-layer metrics of one traced CPU run of ``workload``."""
    result, _ = _tiny.run(workload, trace=True, seconds=0.05)
    return result["metrics"]


def test_span_metrics_are_in_the_benchmark():
    """Each span metric lists only cells of the benchmark, still lists
    every cell of ``LISTED``, and is reported by each cell it lists in a
    traced CPU run where a CPU run reads it."""
    for name in SPAN_METRICS:
        m = PER_LAYER[name]
        assert m["source"] == "program_span"
        assert set(m["workloads"]) <= set(CELLS), name
        assert set(LISTED) <= set(m["workloads"]), name
    for name in CPU_READS:
        for workload in PER_LAYER[name]["workloads"]:
            assert name in _traced_metrics(workload), (name, workload)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_cell_reads_the_ports_spans(workload):
    """On the CPU no kernel runs and the eager path calls no wrapper: the
    run and readout spans are there, the wrapper spans and the idle shares
    are not. ``run_wait_ms`` comes only from a cell on its list."""
    metrics = _traced_metrics(workload)
    for name in SPAN_METRICS:
        if name in CPU_READS and workload in PER_LAYER[name]["workloads"]:
            assert metrics[name]["value"] >= 0
        else:
            assert name not in metrics
