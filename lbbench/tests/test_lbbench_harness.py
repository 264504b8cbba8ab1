"""CPU tests of the benchmark: every cell resolves to its files by name,
``BENCHMARK.json`` keeps to its contract, the work counts, the readers on
a made-up trace, the reference against the port's eager path, a run's last
line, a run without a card, and the check against broken timed paths and
the bfloat16 control. Each cell runs at its CPU size,
``tests/tiny/<workload>.json``."""

import json
import math
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from lbbench import check, faults, harness, peaks
from lbbench.kernels import _counts
from lbbench.tests import _tiny
from lbbench.trace import READOUT, RUN, WINDOW, Context, Trace

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# each cell with each fault of its configuration that breaks the reference
REFERENCE_FAULTS = [(w["name"], name) for w in BENCH["workloads"]
                    for name, f in faults.FAULTS.items()
                    if f["config"] == w["config"] and "reference" in f]

pytestmark = pytest.mark.filterwarnings("ignore:Max Mach number")


# -- files by name -----------------------------------------------------------

@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    tiny = _tiny.path(workload)
    assert tiny.is_file(), f"{workload} has no CPU size: add {tiny}"
    spec = harness.cell_spec(workload)
    cfg = harness.load_config(spec["config"])
    ref = harness.load_reference(spec["config"])
    mix = harness.load_mix(spec["traffic"])
    for key in ("steps_per_interval", "snapshot_every", "monitor",
                "check_intervals", "source", "seed_use"):
        assert key in mix, key
    for name in ("Cell", "inputs", "work", "SOURCE", "ASSUMED"):
        assert hasattr(cfg, name), name
    for name in ("initial_state", "advance", "monitor", "snapshot",
                 "SNAPSHOT_GROUPS"):
        assert hasattr(ref, name), name
    limits = harness.load_limits(workload)
    assert {"f_warm", "rho_win", "mon_win"} <= set(limits)
    held = getattr(ref, "HELD_GROUPS", {})
    assert set(limits) <= {"f_warm", "mon_win", *ref.SNAPSHOT_GROUPS, *held}
    assert not held or hasattr(ref, "held")
    assert all(0 < v < 1 for v in limits.values())
    for name, fault in faults.FAULTS.items():
        if fault["config"] == spec["config"]:
            assert fault["fails"] and set(fault["fails"]) <= set(limits), name
    metrics = harness.per_layer_metrics(workload, BENCH)
    assert metrics
    fams = harness.families()
    for m in metrics:
        assert callable(harness.load_metric(m["name"]).read)
        if m["name"].startswith("roofline_pct."):
            name = m["name"].split(".", 1)[1]
            re.compile(fams[name].PATTERN)
            assert name in cfg.work(mix)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lbbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lbbench/")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        layers.add(m["layer"])
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + list(e2e) + [m["name"] for m in BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in CELLS:  # every cell reports setup_s, another e2e and a layer
        assert harness.per_layer_metrics(w, BENCH)


# -- work counts -------------------------------------------------------------

def _work(workload):
    spec = harness.cell_spec(workload)
    return harness.load_config(spec["config"]).work(
        harness.load_mix(spec["traffic"]))


def _ctx(workload, steps, intervals, trace=None):
    spec = harness.cell_spec(workload)
    ny, nx = _GRIDS[workload]
    return Context(trace=trace, config=spec["config"], mix={}, cells=ny * nx,
                   ny=ny, nx=nx, intervals=intervals, steps=steps,
                   work=_work(workload), families=harness.families())


_GRIDS = {"pipe_flow.open_4096": (4096, 4096),
          "pipe_flow.cylinder_n125": (1251, 3751),
          "pipe_flow.poiseuille_32x256": (32, 256),
          "porous_two_fluid.8192": (8192, 8192)}


def _least(ctx, family):
    """(operations, bytes) of the window's steps of ``family``."""
    w = ctx.work[family]
    per = ctx.intervals if w.per == "interval" else ctx.steps
    return w.ops * ctx.cells * ctx.steps, w.bytes * ctx.cells * per


def test_work_counts_on_known_shapes():
    assert _counts.FLOW_OPS == 94 and _counts.MC_OPS == 360
    cells = 4096 * 4096
    ops, nbytes = _least(_ctx("pipe_flow.open_4096", 256, 1), "k2")
    assert ops == 94 * cells * 256 and nbytes == 72 * cells
    _, nbytes = _least(_ctx("pipe_flow.cylinder_n125", 256, 1), "k2")
    assert nbytes == 73 * 1251 * 3751
    assert _least(_ctx("pipe_flow.poiseuille_32x256", 1000, 1), "k3") == (
        94 * 8192 * 1000, 72 * 8192)
    cells = 8192 * 8192
    ctx = _ctx("porous_two_fluid.8192", 10, 1)
    ops, nbytes = _least(ctx, "k6")
    assert ops == 360 * cells * 10 and nbytes == 144 * cells * 10
    ops, nbytes = _least(_ctx("porous_two_fluid.8192", 1, 1), "k8")
    assert nbytes == 12 * cells
    assert ops == pytest.approx((51 / 9) * cells * 26 + 4 * cells)
    # a configuration gives no work for another's families
    assert set(_work("pipe_flow.open_4096")) == {"k2", "k3"}
    assert set(_work("porous_two_fluid.8192")) == {"k6", "k8"}
    # 8192^2 K8: bytes bound; 4096^2 flow: operations bound
    assert peaks.least_seconds(ops, nbytes) == nbytes / peaks.HBM_BYTES
    flow = _least(_ctx("pipe_flow.open_4096", 256, 1), "k2")
    assert peaks.least_seconds(*flow) == flow[0] / peaks.FP32_FLOPS


# -- the readers on a made-up trace -------------------------------------------

def _made_up_trace():
    """Two intervals of 2 steps: each two K2 launches (100 us each) issued
    inside ``run``, a readout kernel and a copy to the host issued inside
    ``readout``; the device idle between."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 1000}]
    for k, t in enumerate((0, 500)):
        ev += [{"ph": "X", "cat": "user_annotation", "name": RUN, "ts": t,
                "dur": 20},
               {"ph": "X", "cat": "user_annotation", "name": READOUT,
                "ts": t + 20, "dur": 300}]
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": t + 5 + 5 * i, "dur": 2} for i in range(2)]
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": t + 25, "dur": 2}]
        ev += [{"ph": "X", "cat": "kernel",
                "name": "void temporal_step_kernel<0>(float*)",
                "ts": t + 10 + 100 * i, "dur": 100} for i in range(2)]
        ev += [{"ph": "X", "cat": "kernel", "name": "reduce_kernel",
                "ts": t + 210, "dur": 10},
               {"ph": "X", "cat": "gpu_memcpy",
                "name": "Memcpy DtoH (Device -> Pinned)", "ts": t + 230,
                "dur": 20}]
    return Trace(ev)


def test_readers_on_a_made_up_trace():
    ctx = _ctx("pipe_flow.open_4096", 4, 2, trace=_made_up_trace())
    ctx.ny = ctx.nx = 100
    ctx.cells = 100 * 100
    read = {m: harness.load_metric(m).read(ctx) for m in (
        "device_idle_pct", "launches_per_step", "enqueue_us_per_launch",
        "readout_ms", "roofline_pct.k2", "roofline_pct.k3",
        "roofline_pct.k6")}
    assert ctx.window_s == pytest.approx(1e-3)
    assert ctx.busy_s == pytest.approx(2 * 230e-6)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 0.46))
    assert read["launches_per_step"] == pytest.approx(6 / 4)
    assert read["enqueue_us_per_launch"] == pytest.approx(40 / 4)
    assert read["readout_ms"] == pytest.approx(0.040)
    least = max(94 * 1e4 * 4 / 67e12, 72 * 1e4 * 2 / 3.35e12)
    assert read["roofline_pct.k2"] == pytest.approx(100 * least / 400e-6)
    assert read["roofline_pct.k3"] is None   # no K3 kernel ran
    assert read["roofline_pct.k6"] is None   # no work of K6's in this cell


# -- the reference against the port's eager path -------------------------------

@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_ports_eager_path(workload):
    spec = harness.cell_spec(workload)
    cfg = harness.load_config(spec["config"])
    ref = harness.load_reference(spec["config"])
    mix = _tiny.mix(workload)
    cell = cfg.Cell(mix, 5, torch.device("cpu"))
    f0 = ref.initial_state(mix, cell.inputs, torch.float64, "cpu")
    assert check.rel_gap(cell.state(), f0) < 1e-6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            cell.run()
    f = ref.advance(f0, mix, 3 * cell.steps_per_interval)
    assert check.rel_gap(cell.state(), f) < 2e-6
    got = cell.snapshot_buffers()
    cell.snapshot(got)
    want = ref.snapshot(f, mix)
    assert check.rel_gap_many([(got[k], want[k]) for k in got]) < 2e-6


def test_reference_units_match_the_port():
    from lb2d_tpu_torch.models import PipeFlow, PipeFlowCylinder

    ref = harness.load_reference("pipe_flow")
    for workload in ("pipe_flow.open_4096", "pipe_flow.poiseuille_32x256",
                     "pipe_flow.cylinder_n125"):
        mix = harness.load_mix(harness.cell_spec(workload)["traffic"])
        u = ref.units(mix)
        kw = dict(mix["physical"], device="cpu", init_state=False)
        if mix["model"] == "PipeFlowCylinder":
            sim = PipeFlowCylinder(cylinder_center=mix["cylinder"]["center"],
                                   cylinder_radius=mix["cylinder"]["radius"],
                                   **kw)
            assert np.array_equal(u["mask"], sim.obstacle_mask.numpy())
        else:
            sim = PipeFlow(**kw)
        assert (u["ny"], u["nx"]) == (sim.ny, sim.nx)
        assert u["omega"] == pytest.approx(sim.omega, rel=1e-12)
        assert u["rho_in"] == pytest.approx(sim.inlet_rho, rel=1e-12)
    sizes = {w: ref.units(harness.load_mix(harness.cell_spec(w)["traffic"]))
             for w in ("pipe_flow.open_4096", "pipe_flow.poiseuille_32x256",
                       "pipe_flow.cylinder_n125")}
    assert [(s["ny"], s["nx"]) for s in sizes.values()] == [
        (4096, 4096), (32, 256), (1251, 3751)]


# -- a run's last line, and a run without a card --------------------------------

@pytest.mark.parametrize("workload", CELLS)
def test_run_line_keys_and_correct(workload):
    result, lines = _tiny.run(workload, seconds=0.05)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"mlups", "interval_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert lines[-1].startswith("check ")
    json.dumps(result, allow_nan=False)


def test_traced_run_line():
    result, _ = _tiny.run("porous_two_fluid.8192", trace=True, seconds=0.05)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_main_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_main_prints_no_result_once_a_reader_loads_jax(monkeypatch, capsys):
    """A per-layer reader (or anything else that runs after the window)
    that loads JAX or the JAX package leaves the run without a result."""
    import types

    class Reader:
        @staticmethod
        def read(ctx):
            monkeypatch.setitem(sys.modules, "jax",
                                types.ModuleType("jax"))
            return 1.0

    run_cell = harness.run_cell
    workload = "pipe_flow.poiseuille_32x256"
    monkeypatch.setattr(harness, "cards_missing", lambda spec: None)
    monkeypatch.setattr(harness, "load_metric", lambda name: Reader)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: run_cell(
        *a, **dict(k, device="cpu", mix_override=_tiny.size(workload),
                   limits=_tiny.limits(workload))))
    rc = harness.main(["--workload", workload, "--seed", "1", "--seconds",
                       "0.05", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


# -- the check against broken timed paths and the control ------------------------

def _held_by_plain_solve(zero=False):
    """Config 5's held force planes on the CPU, where the eager step holds
    none: each interval's last step's force by the port's plain density and
    solve (what K8 computes on the card), or zeros (K8 writing nothing)."""
    from lb2d_tpu_torch.ops.fused_mc import mc_density_reference
    from lb2d_tpu_torch.ops.spectral import screened_gradients_reference

    def fault(cell):
        sim, planes = cell.sim, {}
        M = cell.steps_per_interval

        def run():
            sim.run(M - 1)
            (_, _, _, src, lam2, amp), = sim.config().screened
            rho = mc_density_reference(sim.f, sim.config(), sim.lattice)
            g = screened_gradients_reference(rho[src], lam2, out_scale=amp)
            planes.update(fx=g[0], fy=g[1])
            sim.run(1)

        cell.run = run
        cell.held_buffers = lambda: {k: torch.empty((cell.ny, cell.nx))
                                     for k in ("fx", "fy")}
        cell.held = lambda out: [out[k].copy_(0 if zero else planes[k])
                                 for k in out]

    return fault


@pytest.mark.parametrize("zero", [False, True])
def test_the_held_force_planes_are_checked(zero):
    result, _ = _tiny.run("porous_two_fluid.8192", card_only=True,
                          fault=_held_by_plain_solve(zero))
    assert "force_win" in result["checks"]
    if zero:
        assert not result["correct"]
        assert _tiny.failing(result["checks"]) == ["force_win"]
        assert result["checks"]["force_win"]["value"] == 1.0
    else:
        assert result["correct"], result["checks"]


def test_a_run_without_its_held_planes_is_not_correct():
    """On the card every number of the limits has to be read: a cell that
    gives no held planes fails ``force_win`` as missing."""
    result, _ = _tiny.run("porous_two_fluid.8192", card_only=True)
    assert not result["correct"]
    assert _tiny.failing(result["checks"]) == ["force_win"]


def _unchanged(cell):
    cell.run = lambda: None


def _half_left_out(cell):
    """Each interval advances only the first half of the rows."""
    run = cell.run

    def half():
        f = cell.state()
        keep = f[..., f.shape[-2] // 2:, :].clone()
        run()
        cell.state()[..., f.shape[-2] // 2:, :] = keep

    cell.run = half


def _snapshot_altered(cell):
    snap = cell.snapshot

    def altered(out):
        snap(out)
        first = next(iter(out.values()))
        first[0, 0] += 1e-2 * float(first.abs().max())

    cell.snapshot = altered


def _monitor_altered(cell):
    mon = cell.monitor
    cell.monitor = lambda: mon() * 2


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _snapshot_altered, _monitor_altered])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    result, _ = _tiny.run(workload, fault=fault)
    assert not result["correct"]
    assert _tiny.failing(result["checks"])


@pytest.mark.parametrize(("workload", "fault"), REFERENCE_FAULTS,
                         ids=[f"{f}-{w}" for w, f in REFERENCE_FAULTS])
def test_a_fault_in_the_flow_velocity_terms_is_not_correct(workload, fault):
    """Each fault of the cell's configuration that breaks the reference
    (``lbbench/faults/<config>.py``; for ``pipe_flow`` the equilibrium's
    velocity terms), read on the card at the cell's own size, fails one of
    its ``fails`` numbers at the tiny size too; the float32 reference
    without it passes."""
    spec = harness.cell_spec(workload)
    cfg = harness.load_config(spec["config"])
    ref = harness.load_reference(spec["config"])
    mix = _tiny.mix(workload)
    inputs = cfg.inputs(mix, _tiny.SEED, torch.device("cpu"))
    j = harness.check_interval(_tiny.SEED, mix)
    with faults.FAULTS[fault]["reference"](ref):
        out = check.control_outputs(ref, mix, inputs, j, "cpu",
                                    dtype=torch.float32)
    values = check.readings(ref, mix, inputs, out, "cpu")
    correct, checks = check.verdict(values, harness.load_limits(workload))
    assert not correct
    assert set(faults.FAULTS[fault]["fails"]) & set(_tiny.failing(checks))
    sound = check.readings(ref, mix, inputs, check.control_outputs(
        ref, mix, inputs, j, "cpu", dtype=torch.float32), "cpu")
    assert check.verdict(sound, harness.load_limits(workload))[0], sound


@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_is_not_correct(workload):
    spec = harness.cell_spec(workload)
    cfg = harness.load_config(spec["config"])
    ref = harness.load_reference(spec["config"])
    mix = _tiny.mix(workload)
    inputs = cfg.inputs(mix, _tiny.SEED, torch.device("cpu"))
    j = harness.check_interval(_tiny.SEED, mix)
    out = check.control_outputs(ref, mix, inputs, j, "cpu")
    values = check.readings(ref, mix, inputs, out, "cpu")
    correct, checks = check.verdict(values, harness.load_limits(workload))
    assert not correct
    assert _tiny.failing(checks)
    assert all(math.isfinite(v) for v in values.values())
