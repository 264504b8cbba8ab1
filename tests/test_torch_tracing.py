"""The port's spans (``lb2d_tpu_torch.utils.tracing``): nothing recorded
and no ``record_function`` call while no profiler records; under
``torch.profiler`` the run loop, the readouts and the waits with their
nesting; the wrappers' spans on the card.

The tests marked ``cuda`` skip without a CUDA device. The file imports no
JAX: on the card run it with ``python -m pytest --noconftest
tests/test_torch_tracing.py``.
"""

import json
import os
import re
import shutil
from pathlib import Path

import pytest
import torch

from lb2d_tpu_torch.models import (Fluid, PipeFlow, PipeFlowVelocityInlet,
                                   SimulationRunner)
from lb2d_tpu_torch.ops import (fused, fused_coupled, fused_halo, fused_mc,
                                moments, spectral, transpose)
from lb2d_tpu_torch.ops import random as ops_random
from lb2d_tpu_torch.utils import MachWatchdog, conservation_report, trace
from lb2d_tpu_torch.utils import tracing

PORT = Path(tracing.__file__).resolve().parent.parent
WRAPPER_MODULES = (fused, fused_coupled, fused_halo, fused_mc, moments,
                   ops_random, spectral, transpose)
# the calls that block the host on the card in the CUDA runtime's trace
BLOCKING = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaEventSynchronize"}
LAUNCH = re.compile(r"Launch(Cooperative)?Kernel")

pytestmark = pytest.mark.filterwarnings("ignore:Max Mach number",
                                        "ignore:CUDA is not available")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pipe(device="cpu", n=15):
    return PipeFlow(N=n, pipe_length=1.0, diameter=1.0, rho=1.0,
                    viscosity=1.0, pressure_grad=-10.0, device=device)


def _runner(device="cpu", n=24, stale_force=None):
    """BASELINE config 5 (porous two-fluid Shan-Chen with the
    screened-Poisson force) on an ``n x n`` grid."""
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=True, stale_force=stale_force,
                           device=device)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1 / 6, epsilon=0.8, nu_fluid=1 / 6,
                            K=10.0, Fe=0.1))
    sim.complete_setup()
    g = torch.Generator().manual_seed(0)
    base = 0.5 + 0.05 * torch.rand((n, n), generator=g)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    return sim


def _events(logdir):
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    shutil.rmtree(logdir, ignore_errors=True)
    return [e for e in events if e.get("ph") == "X"]


def _spans(events, prefix="lb2d."):
    """The port's spans as ``(name, start, end)``, by start."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parent(span, spans):
    """The innermost other span that contains ``span``."""
    around = [s for s in spans if s is not span and _inside(span, s)]
    return min(around, key=lambda s: s[2] - s[1]) if around else None


def _traced(fn):
    with trace() as logdir:
        fn()
    return _events(logdir)


# -- no profiler: nothing recorded, no record_function --------------------------

def test_no_profiler_gives_the_shared_noop():
    assert not tracing.recording()
    assert tracing.span("lb2d.a") is tracing.span("lb2d.b")
    with tracing.span("lb2d.a") as entered:
        assert entered is None


def test_no_profiler_makes_no_record_function_call(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sim = _pipe()
    sim.run(3)
    MachWatchdog().check(sim.device_field("u"), sim.device_field("v"))
    sim.get_fields()
    sim.block_until_ready()
    runner = _runner(stale_force=2)
    runner.run(3)
    conservation_report(runner.f, rho=runner.rho, accumulate="f64")
    runner.get_fields()


def test_record_function_lives_only_in_the_tracing_module():
    users = sorted(p.relative_to(PORT).as_posix()
                   for p in PORT.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["utils/tracing.py"]


# -- under torch.profiler on the CPU ---------------------------------------------

def test_pipe_flow_run_and_field_readout_spans():
    sim = _pipe()

    def interval():
        sim.run(3)
        MachWatchdog().check(sim.device_field("u"), sim.device_field("v"))

    spans = _spans(_traced(interval))
    names = [s[0] for s in spans]
    assert names[0] == "lb2d.run"
    run = spans[0]
    field_u = spans[names.index("lb2d.readout.field.u")]
    assert field_u[1] >= run[2]   # the readout follows the run
    waits = [s for s in spans if s[0].startswith("lb2d.wait.")]
    # the plain moments read the cached lattice columns: no wait of theirs
    assert {s[0] for s in waits} == {"lb2d.wait.mach_number"}
    for w in waits:
        parent = _parent(w, spans)[0]
        assert parent.startswith("lb2d.readout."), (w, parent)
    assert not any(_parent(w, spans) == field_u for w in waits)
    mach = spans[names.index("lb2d.readout.mach_number")]
    assert _parent(spans[names.index("lb2d.wait.mach_number")],
                   spans) == mach
    assert names.count("lb2d.readout.field.v") == 1


def test_runner_run_hydro_and_wait_nesting():
    sim = _runner(stale_force=2)

    def interval():
        sim.run(4)
        conservation_report(sim.f, rho=sim.rho)

    spans = _spans(_traced(interval))
    names = [s[0] for s in spans]
    run = spans[names.index("lb2d.run")]
    hydro = spans[names.index("lb2d.hydro")]
    assert _parent(hydro, spans) == run
    # the cached lattice columns: the refresh copies nothing and waits for
    # nothing
    assert not any(s[0].startswith("lb2d.wait.")
                   and _parent(s, spans) == hydro for s in spans)
    assert "lb2d.wait.columns" not in names
    solves = [s for s in spans if s[0] == "lb2d.solve"]
    assert len(solves) == 2   # one per two-step sweep
    assert all(_parent(s, spans) == run for s in solves)
    report = spans[names.index("lb2d.readout.conservation_report")]
    sums = [s for s in spans if s[0] == "lb2d.wait.accumulated_sum"]
    assert len(sums) == 2 and all(_parent(s, spans) == report for s in sums)
    # the eager step calls no kernel wrapper
    assert not any(n.startswith("lb2d.launch.") for n in names)


def test_get_fields_and_synchronize_spans():
    sim = _pipe()

    def read():
        sim.get_fields()
        sim.block_until_ready()

    spans = _spans(_traced(read))
    fields = [s for s in spans if s[0] == "lb2d.readout.get_fields"]
    assert len(fields) == 1
    hosts = [s for s in spans if s[0] == "lb2d.wait.to_host_xy"]
    assert len(hosts) == 5 and all(_parent(h, spans) == fields[0]
                                   for h in hosts)
    assert [s[0] for s in spans].count("lb2d.wait.synchronize") == 1


def test_the_lattice_models_set_up_wait_has_its_span():
    """``LatticePipeFlow.update_dimensionless_nums`` reads the largest speed
    on the host once, at set-up, inside ``lb2d.wait.dimensionless_nums``."""
    spans = _spans(_traced(lambda: PipeFlowVelocityInlet(lx=20, ly=20,
                                                         device="cpu")))
    waits = [s for s in spans if s[0] == "lb2d.wait.dimensionless_nums"]
    assert len(waits) == 1
    assert _parent(waits[0], spans) is None   # set-up, outside any run


def test_wrapper_on_cpu_tensors_opens_no_launch_span():
    sim = _runner()
    cfg = sim.config()
    rho = torch.empty((2, 24, 24))
    before = fused_mc.mc_density.launches
    spans = _spans(_traced(
        lambda: fused_mc.mc_density(sim.f, rho, cfg, sim.lattice)))
    assert spans == [] and fused_mc.mc_density.launches == before


def _wrappers():
    return [(m.__name__.rsplit(".", 1)[1], name, fn)
            for m in WRAPPER_MODULES
            for name, fn in vars(m).items()
            if callable(fn) and hasattr(fn, "launches")
            and fn.__module__ == m.__name__]


def test_every_counted_wrapper_carries_a_launch_span():
    wrappers = _wrappers()
    assert len(wrappers) == 23
    launch_code = tracing.traced_launch(lambda f: f).__code__
    for module, name, fn in wrappers:
        assert fn.__code__ is launch_code, (module, name)
        assert fn.__wrapped__.__name__ == name
    for fn in (fused_coupled._coupled_cell_step,
               fused_coupled._coupled_cell_step_halo):
        assert fn.__code__ is launch_code


def test_launch_span_finds_the_device_argument():
    seen = []

    @tracing.traced_launch
    def by_tensor(f_in, k):
        seen.append(tracing._device_type(f_in))

    @tracing.traced_launch
    def by_device(seed, step, shape, device):
        seen.append(tracing._device_type(device))

    class Halo:
        f = torch.zeros(1)

    by_tensor(torch.zeros(1), 2)
    by_device(0, 0, (1, 1), device="cpu")
    assert seen == ["cpu", "cpu"]
    assert tracing._device_type(Halo()) == "cpu"
    assert tracing._device_type("cuda:0") == "cuda"
    spans = _spans(_traced(lambda: (by_tensor(torch.zeros(1), 2),
                                    by_device(0, 0, (1, 1), "cpu"))))
    assert spans == []


def test_default_trace_directories_are_fresh():
    with trace() as first:
        pass
    with trace() as second:
        pass
    try:
        assert first != second
        assert os.path.basename(first).startswith("lb2d_trace_")
        for d in (first, second):
            assert os.path.isfile(os.path.join(d, "trace.json"))
    finally:
        shutil.rmtree(first, ignore_errors=True)
        shutil.rmtree(second, ignore_errors=True)


# -- on the card -----------------------------------------------------------------

def _launches_by_span(events):
    """The kernel launches of the CUDA runtime inside each wrapper span:
    ``{wrapper: (spans, launches)}``."""
    spans = _spans(events, "lb2d.launch.")
    launches = sorted(e["ts"] for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and LAUNCH.search(e["name"]))
    out = {}
    for name, t0, t1 in spans:
        n_spans, n_launches = out.get(name, (0, 0))
        out[name] = (n_spans + 1,
                     n_launches + sum(t0 <= t <= t1 for t in launches))
    return out


@pytest.mark.cuda
def test_every_wrapper_call_opens_one_launch_span(cuda):
    flow = _pipe(cuda, n=63)
    flow_k2 = PipeFlow(N=63, pipe_length=1.0, diameter=1.0, rho=1.0,
                       viscosity=1.0, pressure_grad=-10.0, device=cuda,
                       backend="temporal")
    flow_k1 = PipeFlow(N=63, pipe_length=1.0, diameter=1.0, rho=1.0,
                       viscosity=1.0, pressure_grad=-10.0, device=cuda,
                       backend="kernel")
    runner = _runner(cuda, n=64)
    x = torch.rand((48, 80), device=cuda)
    for warm in (flow.run, flow_k2.run, flow_k1.run, runner.run):
        warm(1)
    torch.cuda.synchronize()
    counters = {n: fn for _, n, fn in _wrappers()}
    before = {n: fn.launches for n, fn in counters.items()}

    def calls():
        flow.run(100)            # K3: one launch
        flow_k2.run(10)          # K2 three times: 4, 4 and 2 steps
        flow_k1.run(2)           # K1 twice
        flow_k2.device_field("u")  # the moments kernel
        runner.run(3)            # K6 density, K8, K6 step per step
        ops_random.normals(1, 0, (64, 64), cuda)
        transpose.transpose(x)
        spectral.dft_axis0(x)
        torch.cuda.synchronize()

    got = _launches_by_span(_traced(calls))
    delta = {n: counters[n].launches - before[n] for n in counters}
    calls_made = {"resident_pipe_run": 1, "temporal_pipe_step": 3,
                  "pipe_step": 2, "flow_moments": 1, "mc_density": 3,
                  "mc_step": 3,
                  "screened_gradients": 3, "normals": 1, "transpose": 1,
                  "dft_axis0": 1}
    assert {n.split(".", 2)[2]: c[0] for n, c in got.items()} == calls_made
    for n, (_, launches) in got.items():
        assert launches == delta[n.split(".", 2)[2]], n
    assert {n for n, d in delta.items() if d} == set(calls_made)


def _blocking_outside_waits(events, window):
    waits = _spans(events, "lb2d.wait.")
    lo, hi = window
    return [(e["name"], e["ts"]) for e in events
            if e.get("cat") == "cuda_runtime" and e["name"] in BLOCKING
            and lo <= e["ts"] <= hi
            and not any(w[1] <= e["ts"] and e["ts"] + e["dur"] <= w[2]
                        for w in waits)]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["pipe_flow", "runner"])
def test_every_blocking_call_is_inside_a_wait_span(cuda, model):
    if model == "pipe_flow":
        sim = _pipe(cuda, n=255)
        assert (sim.ny, sim.nx) == (256, 256)
        watchdog = MachWatchdog()

        def readout():
            watchdog.check(sim.device_field("u"), sim.device_field("v"))
    else:
        sim = _runner(cuda, n=256)

        def readout():
            conservation_report(sim.f, rho=sim.rho)
    for _ in range(2):
        sim.run(10)
        readout()
    torch.cuda.synchronize()

    def interval():
        with torch.profiler.record_function("test.window"):
            sim.run(10)
            readout()

    events = _traced(interval)
    window = next(e for e in events if e.get("name") == "test.window")
    blocking = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["name"] in BLOCKING]
    assert blocking, "the interval blocked nowhere"
    assert _blocking_outside_waits(
        events, (window["ts"], window["ts"] + window["dur"])) == []


@pytest.mark.cuda
def test_field_readout_on_the_card_launches_once_and_waits_nowhere(cuda):
    sim = _pipe(cuda, n=63)
    sim.run(10)
    sim.device_field("u")
    torch.cuda.synchronize()
    before = moments.flow_moments.launches

    def readout():
        for name in ("u", "v", "rho"):
            sim.device_field(name)
        sim.get_fields()

    spans = _spans(_traced(readout))
    names = [s[0] for s in spans]
    assert moments.flow_moments.launches == before + 4
    waits = [s for s in spans if s[0].startswith("lb2d.wait.")]
    assert not any((_parent(w, spans) or ("",))[0].startswith(
        "lb2d.readout.field.") for w in waits)
    launches = [s for s in spans if s[0] == "lb2d.launch.flow_moments"]
    assert len(launches) == 4
    for name in ("u", "v", "rho"):
        field = spans[names.index(f"lb2d.readout.field.{name}")]
        assert sum(_parent(s, spans) == field for s in launches) == 1
    fields = spans[names.index("lb2d.readout.get_fields")]
    assert sum(_parent(s, spans) == fields for s in launches) == 1


@pytest.mark.cuda
def test_the_lattice_models_set_up_blocks_inside_its_wait_span(cuda):
    PipeFlowVelocityInlet(lx=40, ly=40, device=cuda)   # the library built
    torch.cuda.synchronize()
    events = _traced(lambda: PipeFlowVelocityInlet(lx=40, ly=40,
                                                   device=cuda))
    wait = next(s for s in _spans(events)
                if s[0] == "lb2d.wait.dimensionless_nums")
    assert any(e.get("cat") == "cuda_runtime" and e["name"] in BLOCKING
               and wait[1] <= e["ts"] <= wait[2] for e in events)
