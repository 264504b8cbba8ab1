"""Time K2, K4, K5, K6, K7, K9 and P1 per launch on the card, at the shapes of
PERF.md's kernel table, and print one JSON line.

    cd <checkout> && python3 <path>/tools/time_tile_kernels.py [label] [mode]

imports ``lb2d_tpu_torch`` from the working directory, so one copy of this
script times any checkout of the port: run two checkouts in turns (A, B, B,
A) in one command on one card to compare them. Each kernel: 100 launches
between two CUDA events, five times; the median is printed, in ms per
launch and ms per step. K2 and K4 run at the steps per launch of the
checkout's own models (``TEMPORAL_K``, ``DIFFUSION_TEMPORAL_K``,
``NOISY_TEMPORAL_K``, ``FISHER_TEMPORAL_K``, ``EXPANSION_TEMPORAL_K``), so
that each checkout's main path is timed as it runs: K2 flow 4096^2, K2
velocity inlet 401^2, K2 diffusion and noisy Fisher 2048^2, K4 fisher
2048^2 with F = 2 and K4 expansion 1024^2 with F = 3, K5 on a band of 4K
rows of that Expansion; where the checkout has K9, K9 at the shards of
the ``k9`` mode below at the checkout's ``HALO_TEMPORAL_K``, and K9's
multifield physics on the first shard of each multifield model cut 2 x 2,
at the model's K; K6 ``mc_density`` and
``mc_step`` on the 8192^2 porous two-fluid Shan-Chen runner of BASELINE
config 5 with its hooks (the Shan-Chen interaction and the screened
force's ext planes) and K7 per physics at the coupled models' shapes
(``chip_smoke.py``'s: 1024^2, the surfactant waves 512^2) and at 2048^2,
on the models' states (K7's velocity planes those of the state's
density), ms per launch at every K from 1 to its limit by CUDA-graph
replay and by events around host launches, the screened families'
one-step kernel and K6's density pass. Modes
after the label: ``k7``, K7 alone, so that many pairs of runs fit in one
call; ``coupled``, the coupled main paths of ``chip_smoke.py`` as MLUPS of
``run(n, timed=True)`` (median of three after a warm run; the five
models, the two ``stale_velocity=8`` runs and ``ShardedCoupled`` on four
shards of one card), which any checkout of the port runs; ``kshard``,
``ShardedCoupled`` rocket yeast and forces only at 1024^2 on 4 x 1 and
2 x 2 shards of one card at K = 4, 6 and 8 in turns (``k_steps``; MLUPS
of five ``run(64, timed=True)`` per K and round, two rounds in opposite
orders); ``k8``, K8
alone: one screened-gradient solve (config 5's screen and
amplitude) of a random field at 8192^2, 1024^2 and 512^2 (20 solves
between the events at 8192^2); ``paths``, the main paths that run K8, as
MLUPS of ``run(n, timed=True)`` after a warm run (host clock, median of
three): BASELINE config 5 at 8192^2 (``run(20)``, exact and
``stale_force=8``) and the screened coupled models at ``chip_smoke.py``'s
sizes (``run(256)``); ``sweep``, K2 and K4 alone, then the main paths that
run them, as MLUPS the same way: ``PipeFlow`` 4096^2 and
``PipeFlowVelocityInlet`` 401^2 ``run(1000)``, ``AdvectionDiffusion`` and
the stochastic Fisher wave 2048^2 ``run(2000)``,
``FisherExpansion`` 2048^2 ``run(1000)`` and ``Expansion`` 1024^2
``run(2048)``; ``ksweep``, K2's and K4's ms per step at every K up to
the checkout's limit, at the same shapes (copies of the checkout whose
constants were changed, ``kCols`` and the like, timed in turns this way
compare designs); ``k9``, K9's flow, diffusion and noisy Fisher physics at
the sharded main paths' shards (flow: the first 2048 x 8192 shard of a
random 8192^2 state, the 4 x 1 cut; diffusion and noisy Fisher: the first
1024^2 shard of the 2048^2 models' states, the 2 x 2 cut) at the
checkout's ``HALO_TEMPORAL_K`` and per step at every K from 1 to 8, K2,
K4 and K5 as in the default mode as the control, and the MLUPS
of ``ShardedPipeFlow`` 8192^2 on 4 x 1 shards of one card beside the
unsharded ``PipeFlow`` (``run(100, timed=True)``, median of three after a
warm run); ``graph``, the kernels' own device time where a launch is
short enough for the host's launch rate to show in the events' time: K9 at
its 2 x 2 shards (and the velocity inlet's 100 x 401 shard), K7 per
physics at the coupled models' shapes and K7h at the shards the sharded
coupled models run, at the K of their main paths, each by CUDA-graph
replay (20 launches captured in one
graph, the graph replayed 20 times between two events, five times) beside
the same launches timed by events; ``k3``, K3 per physics at its main
path's shape (ms per 1000-step launch, CUDA events, median of three runs
of five launches): ``PipeFlow`` 32 x 256, ``NoisyAdvectedFisherWave``
256^2, ``ReactionAdvectionDiffusion`` 512^2 and ``PipeFlowVelocityInlet``
401^2 on the models' states; then the size sweep, each physics at 32 x
256, 128^2, 256^2, 362^2, 401^2, 512^2, 724^2 and 16 x 4096 through the model's
``run(1000, timed=True)`` with ``backend="resident"`` (K3) and
``"temporal"`` (K2 at the model's K), as ms per 1000 steps (median of
three after a warm ``run(100)``; the diffusion models make only square
grids, so at 32 x 256 and 16 x 4096 the two wrappers run the same 1000
steps between CUDA events); and the control:
K1 at 4096^2, K2, K4 and K5 as in the default mode, and K9 ``flow`` at the
2048 x 8192 shard; ``inlet``, the velocity inlet, whichever loop the
checkout runs for it (32 x 32 tiles, or the row sweep): K2 at 401^2, 2048^2
and 4096^2 and K9 at the 100 x 401 shard (the 401^2 inlet cut 4 x 1), at K
= 3, 4, 6 and 8, each by CUDA-graph replay (20 launches a graph) and by
events around host launches; ``PipeFlowVelocityInlet`` 401^2
``run(1000, timed=True)`` through ``backend="auto"`` at each K, one model
whose K (the checkout's constant, set between runs) takes 3, 4, 6, 8 in
turn, six rounds in rotating order after a warm run at each (MLUPS, every
run); K2 at K = 3 and 4 on the grids from 512^2 to 1448^2 where the two
loops cross over, by graph replay (in both loops where the checkout has
both, ``VELOCITY_TILE_MAX_CELLS`` set for the run); and the control: K2
flow 4096^2 and 2048^2, diffusion and noisy Fisher 2048^2 at the models' K
and K9 flow at its 2048 x 8192 shard, by events and graph replay;
``k5p1``, K5 on the band of 4K rows of the 1024^2 ``Expansion`` at its K
and P1 (``normals``) for a 2048^2 field, the shapes of ``chip_smoke.py``'s
rows, each by CUDA-graph replay (as ``graph``) beside CUDA events around
host launches, and P1's first one-cell-a-thread loop where the checkout
keeps it (``normals_per_cell``); ``k2flow``, K2 flow alone on the states of
the benchmark's two K2 cells (``lbbench/traffic/open_4096.json``: 4096^2,
standing density waves; ``cylinder_n125.json``: 3751 x 1251 with the
disk, the program's noisy start), each built by ``lbbench``'s
``pipe_flow.Cell`` from seed 1, at the checkout's ``TEMPORAL_K``, by CUDA
events around host launches and by CUDA-graph replay, three rounds in
turns.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from lb2d_tpu_torch.models import (  # noqa: E402
    AdvectionDiffusion,
    Expansion,
    FisherExpansion,
    PipeFlow,
    ReactionAdvectionDiffusionStochastic,
)
from lb2d_tpu_torch.ops.fused import (  # noqa: E402
    temporal_diffusion_step,
    temporal_multifield_step,
    temporal_pipe_step,
)

FLOW = dict(N=4095, diameter=1.0, rho=1.0, viscosity=0.1,
            pressure_grad=-0.01, pipe_length=1.0)
ADVECTION = dict(N=341, z=0.1, D=0.005, vx=1.0, vy=0.0, vc=1.0, Lx=0.61,
                 Ly=0.61)
STOCHASTIC = dict(N=341, z=0.1, Lx=0.61, Ly=0.61, g=1.0, vx=1.0, vy=1.0,
                  vc=1.0, Dg=0.05)
FISHER = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 1.0],
              D_standard=1.0, D_list=[1.0, 1.0], N=1023,
              initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1])
EXPANSION = dict(Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
                 D_standard=1.0, D_list=[1.0, 1.2], N=511, Nb=10.0, Dc=1.0)


def _median_ms(launch, reps=100, rounds=5):
    launch()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[rounds // 2]


def _ping_pong(state, step):
    bufs = [state.clone(), torch.empty_like(state)]

    def launch():
        step(bufs[0], bufs[1])
        bufs.reverse()
    return launch


def main():
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": torch.cuda.get_device_name(0)}
    if sys.argv[2:] == ["k8"]:
        out.update(_k8_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["paths"]:
        out.update(_path_mlups())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["k7"]:
        for n in (1024, 2048):
            out.update(_k7_times(n))
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["coupled"]:
        out.update(_coupled_mlups())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["kshard"]:
        out.update(_sharded_coupled_k())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["ksweep"]:
        out.update(_k_sweeps())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["k9"]:
        out.update(_k9_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["graph"]:
        out.update(_graph_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["k3"]:
        out.update(_k3_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["k5p1"]:
        out.update(_k5_p1_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["k2flow"]:
        out.update(_k2_flow_times())
        print(json.dumps(out), flush=True)
        return
    if sys.argv[2:] == ["inlet"]:
        out.update(_inlet_times())
        print(json.dumps(out), flush=True)
        return
    out.update(_k2_k4_times())
    if sys.argv[2:] == ["sweep"]:
        out.update(_sweep_mlups())
        print(json.dumps(out), flush=True)
        return
    try:
        from lb2d_tpu_torch.ops.fused_halo import (
            HALO_TEMPORAL_K,
            temporal_halo_step,
        )
    except ImportError:  # a checkout from before K9
        HALO_TEMPORAL_K = None
    if HALO_TEMPORAL_K is not None:
        for physics, (cut, kw) in _k9_shards().items():
            k = HALO_TEMPORAL_K[physics]
            halo = cut(k)
            outb = torch.empty_like(halo.f)
            out[f"K9 {physics} {halo.f.shape[1]}x{halo.f.shape[2]} shard"] = (
                _entry(_median_ms(lambda: temporal_halo_step(
                    halo, outb, k, physics, **kw)), k))
            del halo, outb
        out.update(_k9_multifield_times())
    out.update(_k6_k7_times())
    print(json.dumps(out), flush=True)


K3_SWEEP = ((32, 256), (128, 128), (256, 256), (362, 362), (401, 401),
            (512, 512), (724, 724), (16, 4096))
K3_STEPS = 1000
POISEUILLE = dict(diameter=1.5, rho=10.0, viscosity=5.0,
                  pressure_grad=-100.0)  # chip_smoke.py's 32 x 256
REACTION = dict(g=5.0, z=0.1, D=0.01, vx=1.0, vy=0.5, vc=1.0)
NOISY_WAVE = dict(z=0.1, D=1.0, g=50.0, Nc=10.0)


def _k3_model(physics, ny, nx, backend):
    """The model of ``physics`` on an ``ny x nx`` grid (None where the
    model makes no such grid)."""
    from lb2d_tpu_torch.models import (
        NoisyAdvectedFisherWave,
        PipeFlowVelocityInlet,
        ReactionAdvectionDiffusion,
    )

    if physics == "flow":
        N = ny - 1
        return PipeFlow(device="cuda", backend=backend, N=N,
                        pipe_length=1.5 * (nx - 1.5) / N, **POISEUILLE)
    if physics == "velocity_inlet":
        return PipeFlowVelocityInlet(device="cuda", backend=backend,
                                     lx=nx - 1, ly=ny - 1)
    if ny != nx:
        return None
    cls, cfg = ((ReactionAdvectionDiffusion, REACTION)
                if physics == "diffusion"
                else (NoisyAdvectedFisherWave, NOISY_WAVE))
    return cls(device="cuda", backend=backend, N=ny - 2, Lx=0.101, Ly=0.101,
               **cfg)


def _k3_launch(physics, sim):
    """One 1000-step K3 launch on a copy of ``sim``'s state."""
    from lb2d_tpu_torch.ops.fused import (
        resident_diffusion_run,
        resident_pipe_run,
        resident_velocity_run,
    )

    from lb2d_tpu_torch.ops import fused

    f = sim.state.clone()
    # the exchange buffer at the plan's size; a parent's K3 takes a second
    # state
    scratch = getattr(fused, "resident_scratch", torch.empty_like)(f)
    if physics == "flow":
        kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
                  outlet_rho=sim.outlet_rho, incompressible=False)
        return lambda: resident_pipe_run(f, scratch, K3_STEPS, **kw)
    if physics == "velocity_inlet":
        kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e,
                  outlet=sim.outlet, incompressible=False)
        return lambda: resident_velocity_run(f, scratch, K3_STEPS, **kw)
    kw = sim.step_kwargs()
    return lambda: resident_diffusion_run(f, scratch, K3_STEPS, **kw)


def _k3_times():
    """K3 at the main paths' shapes, the size sweep of K3 against K2
    through the models, and the control (K1, K2, K4, K5, K9 flow)."""
    from lb2d_tpu_torch.ops import fused
    from lb2d_tpu_torch.ops.fused import (
        pipe_step,
        resident_diffusion_run,
        temporal_diffusion_step,
    )

    out = {}
    main = {"flow": (32, 256), "noisy_fisher": (256, 256),
            "diffusion": (512, 512), "velocity_inlet": (401, 401)}
    for physics, (ny, nx) in main.items():
        sim = _k3_model(physics, ny, nx, "auto")
        out[f"K3 {physics} {ny}x{nx} ms per launch of {K3_STEPS}"] = (
            _median_ms(_k3_launch(physics, sim), reps=5, rounds=3))
        del sim

    def run_ms(sim):
        sim.run(100)  # warm
        runs = []
        for _ in range(3):
            sim.run(K3_STEPS, timed=True)
            runs.append(sim.ny * sim.nx * K3_STEPS
                        / (sim.last_mlups * 1e6) * 1e3)
        return sorted(runs)[1]

    ks = _models_k()
    sweep = {}
    for physics in main:
        for ny, nx in K3_SWEEP:
            row = {}
            for backend in ("resident", "temporal"):
                try:
                    sim = _k3_model(physics, ny, nx, backend)
                    if sim is not None:
                        row[backend] = run_ms(sim)
                        del sim
                except ValueError as err:  # a grid this checkout's K3
                    row[backend] = str(err)  # cannot hold
            if not row:  # the diffusion family at 32 x 256: the wrappers
                g = torch.Generator(device="cuda").manual_seed(0)
                rho = 0.1 + 0.8 * torch.rand((ny, nx), device="cuda",
                                             generator=g)
                w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4,
                                 device="cuda")[:, None, None]
                f = (w * rho).contiguous()
                spare = torch.empty_like(f)
                kw = dict(omega=1.6, u_lb=0.0029, v_lb=-0.0017, lb_G=0.0025)
                if physics == "noisy_fisher":
                    kw.update(lb_Dg=0.05, noisy=True, seed=7)
                k = ks[physics]
                bufs = [f.clone(), spare]

                def temporal():
                    for _ in range(K3_STEPS // k):
                        temporal_diffusion_step(bufs[0], bufs[1], k, **kw)
                        bufs.reverse()
                try:
                    scratch = getattr(fused, "resident_scratch",
                                      torch.empty_like)(f)
                    row["resident"] = _median_ms(
                        lambda: resident_diffusion_run(f, scratch, K3_STEPS,
                                                       **kw),
                        reps=3, rounds=3)
                except ValueError as err:
                    row["resident"] = str(err)
                row["temporal"] = _median_ms(temporal, reps=3, rounds=3)
                row["by"] = "wrappers, CUDA events"
            sweep[f"{ny}x{nx}"] = row
            torch.cuda.empty_cache()
        out[f"sweep {physics} ms per {K3_STEPS} steps"] = sweep
        sweep = {}
    sim = PipeFlow(device="cuda", **FLOW)
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False)
    out["K1 flow 4096^2"] = _median_ms(_ping_pong(
        sim.state, lambda a, b: pipe_step(a, b, **kw)))
    del sim
    out.update(_k2_k4_times())
    from lb2d_tpu_torch.ops.fused_halo import (
        HALO_TEMPORAL_K,
        temporal_halo_step,
    )
    cut, kw = _k9_shards()["flow"]
    k = HALO_TEMPORAL_K["flow"]
    halo = cut(k)
    outb = torch.empty_like(halo.f)
    out["K9 flow 2048x8192 shard"] = _entry(_median_ms(
        lambda: temporal_halo_step(halo, outb, k, "flow", **kw)), k)
    return out


def _graph_ms(launch, per_graph=20, replays=20, rounds=5):
    """Device ms per launch by CUDA-graph replay: ``per_graph`` launches
    captured in one graph (after a warm launch outside the capture), the
    graph replayed ``replays`` times between two events; median of
    ``rounds``."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            launch()
    graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (replays * per_graph))
    return sorted(times)[rounds // 2]


SHARDED_8192 = dict(diameter=1.0, rho=1.0, viscosity=0.1,
                    pressure_grad=-0.01, pipe_length=(8192 - 1.5) / 8191,
                    N=8191)
K9_FLOW = dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0,
               incompressible=False)


def _k9_shards():
    """K9's flow, diffusion and noisy Fisher physics at the sharded main
    paths' first shards: physics -> (halo cutter ``cut(k)``, arguments)."""
    from lb2d_tpu_torch.ops.fused_halo import Halo

    g = torch.Generator(device="cuda").manual_seed(0)
    f = (1 + 0.01 * torch.randn((9, 8192, 8192), device="cuda",
                                generator=g)) / 9
    shards = {"flow": (lambda k, f=f: Halo.cut(f, 0, 0, 2048, 8192, k),
                       K9_FLOW)}
    for name, cls, cfg in (("diffusion", AdvectionDiffusion, ADVECTION),
                           ("noisy_fisher",
                            ReactionAdvectionDiffusionStochastic,
                            STOCHASTIC)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        kw.pop("noisy", None)
        state = sim.state
        H, W = sim.ny // 2, sim.nx // 2
        shards[name] = (lambda k, s=state, H=H, W=W: Halo.cut(s, 0, 0, H, W,
                                                              k), kw)
    return shards


def _k9_times():
    """K9's row-sweep physics at the main paths' shards (the checkout's
    HALO_TEMPORAL_K, and per step at every K), K2, K4 and K5 as the
    control, and ShardedPipeFlow 8192^2 4 x 1 beside PipeFlow (MLUPS)."""
    from lb2d_tpu_torch.ops.fused_halo import (
        HALO_TEMPORAL_K,
        temporal_halo_step,
    )
    from lb2d_tpu_torch.parallel import ShardedPipeFlow, make_mesh

    out = _k2_k4_times()
    for physics, (cut, kw) in _k9_shards().items():
        k = HALO_TEMPORAL_K[physics]
        halo = cut(k)
        H, W = halo.f.shape[1:]
        outb = torch.empty_like(halo.f)
        out[f"K9 {physics} {H}x{W} shard"] = _entry(_median_ms(
            lambda: temporal_halo_step(halo, outb, k, physics, **kw)), k)
        by_k = {}
        for kk in range(1, 9):
            halo = cut(kk)
            by_k[kk] = _median_ms(
                lambda: temporal_halo_step(halo, outb, kk, physics, **kw),
                reps=30, rounds=3) / kk
        out[f"K9 {physics} {H}x{W} shard per step by K"] = by_k
        del halo, outb
        torch.cuda.empty_cache()

    def median_mlups(sim, n=100):
        sim.run(n)  # warm
        runs = []
        for _ in range(3):
            sim.run(n, timed=True)
            runs.append(sim.last_mlups)
        return sorted(runs)[1]

    sh = ShardedPipeFlow(mesh=make_mesh(devices=["cuda"] * 4, shape=(4, 1)),
                         **SHARDED_8192)
    out["MLUPS ShardedPipeFlow 8192^2 4x1"] = median_mlups(sh)
    out["ShardedPipeFlow K"] = sh.steps_per_call
    del sh
    torch.cuda.empty_cache()
    out["MLUPS PipeFlow 8192^2"] = median_mlups(PipeFlow(device="cuda",
                                                         **SHARDED_8192))
    return out


def _graph_times():
    """K9 at its 2 x 2 shards, K7 and K7h: ms per launch by CUDA events
    around host launches and by CUDA-graph replay."""
    from lb2d_tpu_torch.ops.fused_coupled import (
        _coupled_cell_step,
        _coupled_cell_step_halo,
        coupled_reach,
        coupled_sweep,
        coupled_sweep_halo,
    )
    from lb2d_tpu_torch.ops.fused_halo import (
        HALO_TEMPORAL_K,
        Halo,
        temporal_halo_step,
    )

    out = {}

    def both(label, launch):
        out[label] = {"events_ms": _median_ms(launch),
                      "graph_ms": _graph_ms(launch)}

    shards = _k9_shards()
    del shards["flow"]
    ks = _models_k()
    for name, (cut, kw) in shards.items():
        k = HALO_TEMPORAL_K[name]
        halo = cut(k)
        outb = torch.empty_like(halo.f)
        both(f"K9 {name} {halo.f.shape[1]}^2 shard K={k}",
             lambda: temporal_halo_step(halo, outb, k, name, **kw))
    for name, cls, cfg in (("fisher", FisherExpansion, FISHER),
                           ("expansion", Expansion, EXPANSION)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        physics = "multifield_" + kw.pop("physics")
        F, k = sim.num_fields, ks[name]
        H, W = sim.ny // 2, sim.nx // 2
        halo = Halo.cut(sim.state.reshape(9 * F, sim.ny, sim.nx), 0, 0, H, W,
                        k)
        outb = torch.empty_like(halo.f)
        both(f"K9 {physics} {H}^2 shard F={F} K={k}",
             lambda: temporal_halo_step(halo, outb, k, physics, **kw))
    from lb2d_tpu_torch.models import PipeFlowVelocityInlet

    sim = PipeFlowVelocityInlet(device="cuda")
    k = HALO_TEMPORAL_K["velocity_inlet"]
    halo = Halo.cut(sim.state, 0, 0, sim.ny // 4, sim.nx, k)
    outb = torch.empty_like(halo.f)
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=sim.outlet,
              incompressible=False)
    both(f"K9 velocity_inlet {sim.ny // 4}x{sim.nx} shard K={k}",
         lambda: temporal_halo_step(halo, outb, k, "velocity_inlet", **kw))
    for model, mesh in _coupled_models(1024):
        cfg = model.coupled_config()
        f, ext, prm, k, cell = _k7_inputs(model)
        both(f"K7 {cfg.physics} {model.ny}^2 K={k}", _ping_pong(
            f, (lambda a, b: coupled_sweep(a, b, ext, cfg, k, prm))
            if cell is None else
            (lambda a, b: _coupled_cell_step(a, b, cell, ext, cfg, prm))))
        H, W = model.ny // mesh[0], model.nx // mesh[1]
        halo = Halo.cut(f.reshape(9 * cfg.fields, model.ny, model.nx), 0, 0,
                        H, W, coupled_reach(cfg) * k)
        outb = torch.empty_like(halo.f)
        both(f"K7h {cfg.physics} {H}x{W} shard K={k}",
             (lambda: coupled_sweep_halo(halo, outb, ext, cfg, k, prm))
             if cell is None else
             (lambda: _coupled_cell_step_halo(halo, outb, cell, ext, cfg,
                                              prm)))
    return out


def _k5_p1_times():
    """K5 and P1 at chip_smoke.py's shapes: ms per launch by CUDA events
    around host launches and by CUDA-graph replay."""
    from lb2d_tpu_torch.ops.fused import expansion_band_step
    from lb2d_tpu_torch.ops.random import normals

    sim = Expansion(device="cuda", **EXPANSION)
    k = _models_k()["expansion"]
    kw = sim.step_kwargs()
    B = 2 * k
    band = torch.cat([sim.state[:, :, -B:], sim.state[:, :, :B]],
                     dim=2).contiguous()
    args = [kw[n] for n in ("omegas", "omega_nutrient", "lb_G", "lb_Dg",
                            "cutoff", "u_lb", "v_lb")]
    band_kw = dict(seed=kw["seed"], step0=sim.steps_taken, row0=sim.ny - B,
                   ny=sim.ny)
    out = {}

    def both(label, launch):
        out[label] = {"events_ms": _median_ms(launch),
                      "graph_ms": _graph_ms(launch)}

    both(f"K5 band {2 * B}x{sim.nx} F={sim.num_fields} K={k}",
         lambda: expansion_band_step(band, k, *args, **band_kw))
    sto = ReactionAdvectionDiffusionStochastic(device="cuda", **STOCHASTIC)
    shape = (sto.ny, sto.nx)
    both(f"P1 normals {sto.ny}x{sto.nx}",
         lambda: normals(sto.rng_seed, 0, shape, "cuda"))
    from lb2d_tpu_torch.ops import random
    if hasattr(random, "normals_per_cell"):  # the first loop, where kept
        both(f"P1 per cell {sto.ny}x{sto.nx}",
             lambda: random.normals_per_cell(sto.rng_seed, 0, shape, "cuda"))
    return out


INLET_KS = (3, 4, 6, 8)
INLET_STEPS = 1000
INLET_ROUNDS = 6  # run(1000) at each K, in rotating order
INLET_GRIDS = (401, 2048, 4096)
# the grids between, where the velocity inlet's two loops cross over
CROSSOVER_GRIDS = (512, 640, 724, 900, 1024, 1448)


def _inlet_times():
    """The velocity inlet's K2 and K9, whichever loop the checkout runs,
    by CUDA-graph replay and by events, and the controls."""
    import lb2d_tpu_torch.models.lattice_units as lattice_units
    from lb2d_tpu_torch.models import PipeFlowVelocityInlet
    from lb2d_tpu_torch.ops import fused
    from lb2d_tpu_torch.ops.fused_halo import (
        HALO_TEMPORAL_K,
        Halo,
        temporal_halo_step,
    )

    out = {}

    def both(launch, k, replays=20):
        graph = _graph_ms(launch, replays=replays)
        return {"k": k, "graph_ms": graph, "graph_ms_per_step": graph / k,
                "events_ms": _median_ms(launch)}

    def state(n):
        return PipeFlowVelocityInlet(device="cuda", lx=n - 1,
                                     ly=n - 1).state

    sim = PipeFlowVelocityInlet(device="cuda")
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=sim.outlet,
              incompressible=False)

    def k2(f, k):
        return _ping_pong(f, lambda a, b: fused.temporal_velocity_step(
            a, b, k, **kw))

    for n in INLET_GRIDS:
        f = sim.state if n == 401 else state(n)
        for k in INLET_KS:
            out[f"K2 velocity {n}^2 K={k}"] = both(
                k2(f, k), k, replays=20 if n < 2048 else 5)
        del f
        torch.cuda.empty_cache()
    cut = {k: Halo.cut(sim.state, 0, 0, sim.ny // 4, sim.nx, k)
           for k in INLET_KS}
    outb = torch.empty_like(cut[3].f)
    for k in INLET_KS:
        out[f"K9 velocity {sim.ny // 4}x{sim.nx} shard K={k}"] = both(
            lambda k=k: temporal_halo_step(cut[k], outb, k, "velocity_inlet",
                                           **kw), k)
    out["HALO_TEMPORAL_K velocity_inlet"] = HALO_TEMPORAL_K["velocity_inlet"]
    # the model end to end through auto at each K (the checkout's constant
    # for the inlet's steps per launch, set between runs), the K in
    # rotating order so that host noise falls on each alike
    model = PipeFlowVelocityInlet(device="cuda")
    put_k = _inlet_k_setter(lattice_units, model)
    model_k = put_k(INLET_KS[0])
    out["model K"] = model_k
    for k in INLET_KS:  # warm
        put_k(k)
        model.run(100)
    runs = {k: [] for k in INLET_KS}
    for r in range(INLET_ROUNDS):
        for i in range(len(INLET_KS)):
            k = INLET_KS[(r + i) % len(INLET_KS)]
            put_k(k)
            model.run(INLET_STEPS, timed=True)
            runs[k].append(model.last_mlups)
    put_k(model_k)
    for k in INLET_KS:
        out[f"MLUPS PipeFlowVelocityInlet 401^2 K={k}"] = {
            "runs": runs[k], "median": sorted(runs[k])[len(runs[k]) // 2]}
    # the crossover: K2 at the grids between, in whichever loop the
    # checkout runs there, and (where the checkout has both) in each loop
    tiles_max = getattr(fused, "VELOCITY_TILE_MAX_CELLS", None)
    loops = {"": None} if tiles_max is None else {" tiles": 1 << 30,
                                                  " sweep": 0}
    for n in CROSSOVER_GRIDS:
        f = state(n)
        for label, cells in loops.items():
            if cells is not None:
                fused.VELOCITY_TILE_MAX_CELLS = cells
            for k in (3, 4):
                out[f"K2 velocity {n}^2{label} K={k}"] = _graph_ms(k2(f, k))
        del f
    if tiles_max is not None:
        fused.VELOCITY_TILE_MAX_CELLS = tiles_max
        out["VELOCITY_TILE_MAX_CELLS"] = tiles_max
    out.update(_inlet_controls())
    return out


def _inlet_k_setter(lattice_units, model):
    """A function that sets the velocity inlet ``model``'s steps per K2
    launch and returns the value it replaced: the class's ``_temporal_k``,
    which the model reads when it builds its step (rebuilt here), or in
    checkouts up to commit b864ddc, which have no ``_temporal_k``, the
    module's constant (``VELOCITY_TEMPORAL_K`` or ``TEMPORAL_K``), which
    the model reads at every ``run``. That second branch goes once no
    comparison runs such a checkout."""
    cls = type(model)
    if hasattr(cls, "_temporal_k"):
        def put(k):
            old = model._temporal_k
            cls._temporal_k = k  # in place of the class's own rule
            model._step = model.make_step()
            return old
        return put
    name = ("VELOCITY_TEMPORAL_K"
            if hasattr(lattice_units, "VELOCITY_TEMPORAL_K") else "TEMPORAL_K")

    def put(k):
        old = getattr(lattice_units, name)
        setattr(lattice_units, name, k)
        return old
    return put


def _inlet_controls():
    """K2 flow 4096^2 and 2048^2, diffusion and noisy Fisher 2048^2 at the
    models' K, and K9 flow at its 2048 x 8192 shard, by events and graph
    replay."""
    from lb2d_tpu_torch.ops.fused_halo import (
        HALO_TEMPORAL_K,
        temporal_halo_step,
    )

    ks = _models_k()
    out = {}

    def both(label, launch, k):
        out[label] = {"k": k, "events_ms": _median_ms(launch),
                      "graph_ms": _graph_ms(launch)}

    k = ks["flow"]
    for n in (4096, 2048):  # the inlet's large grids against flow's
        sim = PipeFlow(device="cuda", **dict(FLOW, N=n - 1))
        kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
                  outlet_rho=sim.outlet_rho, incompressible=False)
        both(f"K2 flow {n}^2", _ping_pong(
            sim.state, lambda a, b: temporal_pipe_step(a, b, k, **kw)), k)
        del sim
    for name, cls, cfg in (("diffusion", AdvectionDiffusion, ADVECTION),
                           ("noisy_fisher",
                            ReactionAdvectionDiffusionStochastic,
                            STOCHASTIC)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        k = ks[name]
        both(f"K2 {name} 2048^2", _ping_pong(
            sim.state, lambda a, b: temporal_diffusion_step(a, b, k, **kw)),
            k)
        del sim
    cut, kw = _k9_shards()["flow"]
    k = HALO_TEMPORAL_K["flow"]
    halo = cut(k)
    outb = torch.empty_like(halo.f)
    both("K9 flow 2048x8192 shard",
         lambda: temporal_halo_step(halo, outb, k, "flow", **kw), k)
    return out


def _coupled_models(n):
    """The coupled models at ``n``^2 (the surfactant waves at ``n / 2`` when
    ``n`` is 1024, as ``chip_smoke.py`` runs them), each with the mesh its
    sharded run takes (rocket yeast 4 x 1, the others 2 x 2)."""
    from lb2d_tpu_torch.models import (
        ClumpySurfactantNutrientWave,
        RocketYeast,
        RocketYeastForcesOnly,
        ScreenedFisherWave,
        SurfactantNutrientWave,
    )

    coupled = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=n)
    waves = dict(coupled, N=n // 2 if n == 1024 else n)
    rocket = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=n,
                  G_chen=-0.1)
    return ((ScreenedFisherWave(device="cuda", **coupled), (2, 2)),
            (SurfactantNutrientWave(device="cuda", **waves), (2, 2)),
            (ClumpySurfactantNutrientWave(device="cuda", rho_o=1.0,
                                          G_chen=-5.0, **waves), (2, 2)),
            (RocketYeast(device="cuda", **rocket), (4, 1)),
            (RocketYeastForcesOnly(device="cuda", c_o=0.25, alpha=2.0,
                                   **rocket), (2, 2)))


def _models_k():
    """The steps per launch of this checkout's models."""
    from lb2d_tpu_torch.models.diffusion import (
        DIFFUSION_TEMPORAL_K,
        NOISY_TEMPORAL_K,
    )
    from lb2d_tpu_torch.models.multifield import (
        EXPANSION_TEMPORAL_K,
        FISHER_TEMPORAL_K,
    )
    from lb2d_tpu_torch.models.pipe_flow import TEMPORAL_K
    return {"flow": TEMPORAL_K, "velocity": TEMPORAL_K,
            "diffusion": DIFFUSION_TEMPORAL_K, "noisy_fisher": NOISY_TEMPORAL_K,
            "fisher": FISHER_TEMPORAL_K, "expansion": EXPANSION_TEMPORAL_K}


def _entry(ms, k):
    return {"k": k, "ms": ms, "ms_per_step": ms / k}


def _k2_k4_times():
    """K2 per physics, K4 per physics and K5, at the models' K."""
    from lb2d_tpu_torch.models import PipeFlowVelocityInlet
    from lb2d_tpu_torch.ops.fused import (
        expansion_band_step,
        temporal_velocity_step,
    )

    ks = _models_k()
    out = {}
    sim = PipeFlow(device="cuda", **FLOW)
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False)
    k = ks["flow"]
    out["K2 flow 4096^2"] = _entry(_median_ms(_ping_pong(
        sim.state, lambda a, b: temporal_pipe_step(a, b, k, **kw))), k)
    del sim
    sim = PipeFlowVelocityInlet(device="cuda")
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=sim.outlet,
              incompressible=False)
    k = ks["velocity"]
    out[f"K2 velocity {sim.ny}^2"] = _entry(_median_ms(_ping_pong(
        sim.state, lambda a, b: temporal_velocity_step(a, b, k, **kw))), k)
    for name, cls, cfg in (("diffusion", AdvectionDiffusion, ADVECTION),
                           ("noisy_fisher",
                            ReactionAdvectionDiffusionStochastic,
                            STOCHASTIC)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        k = ks[name]
        out[f"K2 {name} 2048^2"] = _entry(_median_ms(_ping_pong(
            sim.state, lambda a, b: temporal_diffusion_step(a, b, k, **kw))),
            k)
    for name, cls, cfg in (("fisher", FisherExpansion, FISHER),
                           ("expansion", Expansion, EXPANSION)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        k = ks[name]
        out[f"K4 {name} {sim.ny}^2 F={sim.num_fields}"] = _entry(_median_ms(
            _ping_pong(sim.state, lambda a, b: temporal_multifield_step(
                a, b, k, **kw))), k)
    kw.pop("physics")
    B = 2 * k
    band = torch.cat([sim.state[:, :, -B:], sim.state[:, :, :B]],
                     dim=2).contiguous()
    args = [kw[n] for n in ("omegas", "omega_nutrient", "lb_G", "lb_Dg",
                            "cutoff", "u_lb", "v_lb")]
    band_kw = dict(seed=kw["seed"], step0=sim.steps_taken, row0=sim.ny - B,
                   ny=sim.ny)
    out[f"K5 band {2 * B}x{sim.nx} F={sim.num_fields}"] = _entry(
        _median_ms(lambda: expansion_band_step(band, k, *args, **band_kw)),
        k)
    return out


def _k2_flow_times():
    """K2 flow on the benchmark cells' states: ms per launch by events and
    by graph replay, three rounds in turns."""
    from lbbench.configs.pipe_flow import Cell
    from lbbench.harness import load_mix
    from lb2d_tpu_torch.models.pipe_flow import TEMPORAL_K

    k = TEMPORAL_K
    launches = {}
    for name in ("open_4096", "cylinder_n125"):
        sim = Cell(load_mix(name), 1, "cuda").sim
        mask = (None if sim.obstacle_mask is None
                else sim.obstacle_mask.to(torch.int32).contiguous())
        kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
                  outlet_rho=sim.outlet_rho, incompressible=False, mask=mask)
        label = f"K2 flow {name} {sim.ny}x{sim.nx}"
        launches[label] = _ping_pong(
            sim.state, lambda a, b, kw=kw: temporal_pipe_step(a, b, k, **kw))
    out = {f"{label} {how}": [] for label in launches
           for how in ("events", "graph")}
    for _ in range(3):
        for label, launch in launches.items():
            out[f"{label} events"].append(_median_ms(launch))
            out[f"{label} graph"].append(_graph_ms(launch))
    out["k"] = k
    return out


def _k_sweeps():
    """ms per step of K2 (flow, diffusion, noisy Fisher) and K4 (both
    physics) at every K from 1 to the checkout's limit, at the main paths'
    shapes (30 launches between the events, three times)."""
    from lb2d_tpu_torch.ops.fused import MAX_TEMPORAL_K, multifield_max_k

    def per_step(state, step, k_max):
        return {k: _median_ms(_ping_pong(
            state, lambda a, b, k=k: step(a, b, k)), reps=30, rounds=3) / k
            for k in range(1, k_max + 1)}

    out = {}
    sim = PipeFlow(device="cuda", **FLOW)
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False)
    out["K2 flow 4096^2 per step by K"] = per_step(
        sim.state, lambda a, b, k: temporal_pipe_step(a, b, k, **kw),
        MAX_TEMPORAL_K)
    del sim
    for name, cls, cfg in (("diffusion", AdvectionDiffusion, ADVECTION),
                           ("noisy_fisher",
                            ReactionAdvectionDiffusionStochastic,
                            STOCHASTIC)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        out[f"K2 {name} 2048^2 per step by K"] = per_step(
            sim.state, lambda a, b, k: temporal_diffusion_step(a, b, k, **kw),
            MAX_TEMPORAL_K)
    for name, cls, cfg in (("fisher", FisherExpansion, FISHER),
                           ("expansion", Expansion, EXPANSION)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        out[f"K4 {name} {sim.ny}^2 F={sim.num_fields} per step by K"] = (
            per_step(sim.state, lambda a, b, k: temporal_multifield_step(
                a, b, k, **kw), multifield_max_k(sim.num_fields)))
    return out


def _k9_multifield_times():
    """K9's multifield physics on the first shard of each multifield model
    cut 2 x 2, at the model's K (after an exchange of its halo)."""
    from lb2d_tpu_torch.ops.fused_halo import Halo, temporal_halo_step

    ks = _models_k()
    out = {}
    for name, cls, cfg in (("fisher", FisherExpansion, FISHER),
                           ("expansion", Expansion, EXPANSION)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        physics = "multifield_" + kw.pop("physics")
        F, k = sim.num_fields, ks[name]
        H, W = sim.ny // 2, sim.nx // 2
        halo = Halo.cut(sim.state.reshape(9 * F, sim.ny, sim.nx), 0, 0, H, W,
                        k)
        outb = torch.empty_like(halo.f)
        out[f"K9 multifield_{name} {H}^2 shard F={F}"] = _entry(_median_ms(
            lambda: temporal_halo_step(halo, outb, k, physics, **kw)), k)
    return out


def _sweep_mlups():
    """MLUPS of the main paths that run K2 and K4 (median of three timed
    runs after a warm one)."""
    def median_mlups(sim, n):
        sim.run(n)  # warm
        runs = []
        for _ in range(3):
            sim.run(n, timed=True)
            runs.append(sim.last_mlups)
        return sorted(runs)[1]

    from lb2d_tpu_torch.models import PipeFlowVelocityInlet

    out = {}
    for label, make, n in (
            ("PipeFlow 4096^2", lambda: PipeFlow(device="cuda", **FLOW), 1000),
            ("PipeFlowVelocityInlet 401^2",
             lambda: PipeFlowVelocityInlet(device="cuda"), 1000),
            ("AdvectionDiffusion 2048^2",
             lambda: AdvectionDiffusion(device="cuda", **ADVECTION), 2000),
            ("ReactionAdvectionDiffusionStochastic 2048^2",
             lambda: ReactionAdvectionDiffusionStochastic(
                 device="cuda", **STOCHASTIC), 2000),
            ("FisherExpansion 2048^2",
             lambda: FisherExpansion(device="cuda", **FISHER), 1000),
            ("Expansion 1024^2",
             lambda: Expansion(device="cuda", **EXPANSION), 2048)):
        sim = make()
        out[f"MLUPS {label}"] = median_mlups(sim, n)
        del sim
        torch.cuda.empty_cache()
    return out


def _k6_k7_times():
    """K6 at 8192^2 (C = 2, porous, Shan-Chen) and K7 per physics."""
    import numpy as np

    from lb2d_tpu_torch.models import Fluid, SimulationRunner
    from lb2d_tpu_torch.ops.fused_mc import mc_density, mc_params, mc_step

    out = {}
    n = 8192
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=True, device="cuda")
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    base = 0.5 + 0.05 * np.random.RandomState(0).rand(n, n).astype(
        np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    cfg, lat, ext = sim.config(), sim.lattice, sim.ext_planes()
    params = mc_params(cfg, lat)
    rho = torch.empty_like(sim.rho)
    out["K6 mc_density 8192^2 C=2"] = _median_ms(
        lambda: mc_density(sim.f, rho, cfg, lat))
    out["K6 mc_step 8192^2 C=2"] = _median_ms(_ping_pong(
        sim.f, lambda a, b: mc_step(a, b, rho, ext, cfg, lat, params)))
    del sim, rho
    torch.cuda.empty_cache()
    for n in (1024, 2048):
        out.update(_k7_times(n))
    return out


def _k8_times():
    """K8 per screened-gradient solve at 8192^2, 1024^2 and 512^2."""
    import numpy as np

    from lb2d_tpu_torch.ops.spectral import screened_gradients

    out = {}
    for n in (8192, 1024, 512):
        rho = torch.tensor(np.random.RandomState(5).rand(n, n).astype(
            np.float32), device="cuda")
        res = torch.empty((2, n, n), device="cuda")
        out[f"K8 {n}^2"] = _median_ms(
            lambda: screened_gradients(rho, 100.0, out=res, out_scale=1e-4),
            reps=20 if n == 8192 else 100)
        del rho, res
        torch.cuda.empty_cache()
    return out


def _path_mlups():
    """MLUPS of the main paths that run K8 (median of three timed runs)."""
    import numpy as np

    from lb2d_tpu_torch.models import (
        ClumpySurfactantNutrientWave,
        Fluid,
        ScreenedFisherWave,
        SimulationRunner,
        SurfactantNutrientWave,
    )

    def median_mlups(sim, n):
        sim.run(n)  # warm
        runs = []
        for _ in range(3):
            sim.run(n, timed=True)
            runs.append(sim.last_mlups)
        return sorted(runs)[1]

    out = {}
    for stale in (None, 8):
        n = 8192
        sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                               porous=True, device="cuda", stale_force=stale)
        for i in range(2):
            sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                                nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
        sim.complete_setup()
        base = 0.5 + 0.05 * np.random.RandomState(0).rand(n, n).astype(
            np.float32)
        sim.fluid_list[0].initialize(base)
        sim.fluid_list[1].initialize(1.0 - base)
        sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                                  potential_parameters=[1.0])
        sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                       amplitude=1e-4)
        label = f"config 5 8192^2 stale_force={stale}" if stale else (
            "config 5 8192^2")
        out[label] = median_mlups(sim, 16 if stale else 20)
        del sim
        torch.cuda.empty_cache()
    coupled = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2)
    for label, model in (
            ("ScreenedFisherWave 1024^2", ScreenedFisherWave(
                device="cuda", N=1024, **coupled)),
            ("SurfactantNutrientWave 512^2", SurfactantNutrientWave(
                device="cuda", N=512, **coupled)),
            ("ClumpySurfactantNutrientWave 512^2",
             ClumpySurfactantNutrientWave(device="cuda", N=512, rho_o=1.0,
                                          G_chen=-5.0, **coupled))):
        out[label] = median_mlups(model, 256)
    return out


def _k7_inputs(model):
    """A coupled model's state ``[9, F, ny, nx]``, the velocity planes of
    its density (the screened models), its K7 constants, the steps per
    launch of its main path and the densities its launch takes there (the
    screened models' at one step a launch: the one-step kernel), or
    None."""
    from lb2d_tpu_torch.ops.fused_coupled import (
        COUPLED_TEMPORAL_K,
        coupled_density,
        coupled_params,
    )

    cfg = model.coupled_config()
    f = model._fields4(model.state)
    rho = coupled_density(f, torch.empty((cfg.fields, model.ny, model.nx),
                                         device="cuda"))
    ext = (model._velocity.planes(rho[0]) if model._velocity is not None
           else None)
    k = min(model.steps_per_call, COUPLED_TEMPORAL_K[cfg.physics])
    cell = rho if ext is not None and k == 1 else None
    return f, ext, coupled_params(cfg), k, cell


def _k7_times(n):
    """K7 per physics on ``n``^2 models' states (the surfactant waves at
    ``n / 2`` when ``n`` is 1024, as ``chip_smoke.py`` runs them): ms per
    launch at every K up to the kernel's limit, by CUDA-graph replay and by
    events around host launches, and K6's density pass (the screened
    families' solve source) by graph replay."""
    from lb2d_tpu_torch.ops.fused_coupled import (
        _coupled_cell_step,
        coupled_density,
        coupled_max_k,
        coupled_sweep,
    )

    out = {}
    for model, _ in _coupled_models(n):
        cfg = model.coupled_config()
        f, ext, prm, _, _ = _k7_inputs(model)
        rho = torch.empty((cfg.fields, model.ny, model.nx), device="cuda")
        if ext is not None:  # the one-step kernel on the state's densities
            coupled_density(f, rho)
            out[f"K7 one-step kernel {cfg.physics} {model.ny}^2 graph_ms"] = (
                _graph_ms(_ping_pong(f, lambda a, b: _coupled_cell_step(
                    a, b, rho, ext, cfg, prm))))
        by_k = {}
        for k in range(1, coupled_max_k(cfg) + 1):
            launch = _ping_pong(f, lambda a, b, k=k: coupled_sweep(
                a, b, ext, cfg, k, prm))
            graph = _graph_ms(launch)
            by_k[k] = {"graph_ms": graph, "graph_ms_per_step": graph / k,
                       "events_ms": _median_ms(launch, reps=30, rounds=3)}
        out[f"K7 {cfg.physics} {model.ny}^2 by K"] = by_k
        out[f"K6 density {cfg.physics} {model.ny}^2 graph_ms"] = _graph_ms(
            lambda: coupled_density(f, rho))
    return out


def _coupled_mlups():
    """The coupled main paths of ``chip_smoke.py`` as MLUPS of ``run(n,
    timed=True)`` (median of three after a warm run): the five models at
    their sizes, the two ``stale_velocity=8`` runs, and ``ShardedCoupled``
    over four shards of one card (rocket yeast 4 x 1 and 2 x 2, the forces
    only 2 x 2, the screened Fisher wave 2 x 2 exact and ``stale_velocity=
    8``), ``run(256)`` unsharded and ``run(64)`` sharded."""
    from lb2d_tpu_torch.models import (
        ClumpySurfactantNutrientWave,
        RocketYeast,
        RocketYeastForcesOnly,
        ScreenedFisherWave,
        SurfactantNutrientWave,
    )
    from lb2d_tpu_torch.parallel import ShardedCoupled, make_mesh

    def median_mlups(sim, n):
        sim.run(n)  # warm
        runs = []
        for _ in range(3):
            sim.run(n, timed=True)
            runs.append(sim.last_mlups)
        return sorted(runs)[1]

    sfw = dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2, N=1024)
    waves = dict(sfw, N=512)
    rocket = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=1024,
                  G_chen=-0.1)
    forces = dict(rocket, c_o=0.25, alpha=2.0)
    makers = {
        "ScreenedFisherWave 1024^2": (ScreenedFisherWave, sfw),
        "ScreenedFisherWave 1024^2 stale8": (ScreenedFisherWave,
                                             dict(sfw, stale_velocity=8)),
        "SurfactantNutrientWave 512^2": (SurfactantNutrientWave, waves),
        "SurfactantNutrientWave 1024^2 stale8": (
            SurfactantNutrientWave, dict(waves, N=1024, stale_velocity=8)),
        "ClumpySurfactantNutrientWave 512^2": (
            ClumpySurfactantNutrientWave, dict(waves, rho_o=1.0,
                                               G_chen=-5.0)),
        "RocketYeast 1024^2": (RocketYeast, rocket),
        "RocketYeastForcesOnly 1024^2": (RocketYeastForcesOnly, forces),
    }
    out = {}
    for label, (cls, kw) in makers.items():
        out[f"MLUPS {label}"] = median_mlups(cls(device="cuda", **kw), 256)
        torch.cuda.empty_cache()
    for label, cls, kw, shape in (
            ("RocketYeast 4x1", RocketYeast, rocket, (4, 1)),
            ("RocketYeast 2x2", RocketYeast, rocket, (2, 2)),
            ("RocketYeastForcesOnly 2x2", RocketYeastForcesOnly, forces,
             (2, 2)),
            ("ScreenedFisherWave 2x2", ScreenedFisherWave, sfw, (2, 2)),
            ("ScreenedFisherWave stale8 2x2", ScreenedFisherWave,
             dict(sfw, stale_velocity=8), (2, 2))):
        sh = ShardedCoupled(cls(device="cuda", **kw),
                            mesh=make_mesh(devices=["cuda"] * 4, shape=shape))
        out[f"MLUPS ShardedCoupled {label}"] = median_mlups(sh, 64)
        del sh
        torch.cuda.empty_cache()
    return out


SHARDED_K = (4, 6, 8)


def _sharded_coupled_k():
    """``ShardedCoupled`` rocket yeast and forces only at 1024^2 over four
    shards of one card, 4 x 1 and 2 x 2, at each K of ``SHARDED_K`` in
    turns (the order reversed in the second round): MLUPS of five ``run(64,
    timed=True)`` after a warm run, each K's runs of both rounds."""
    from lb2d_tpu_torch.models import RocketYeast, RocketYeastForcesOnly
    from lb2d_tpu_torch.parallel import ShardedCoupled, make_mesh

    rocket = dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0, N=1024,
                  G_chen=-0.1)
    forces = dict(rocket, c_o=0.25, alpha=2.0)
    out = {}
    for rnd, order in enumerate((SHARDED_K, SHARDED_K[::-1])):
        for label, cls, kw, shape in (
                ("RocketYeast 4x1", RocketYeast, rocket, (4, 1)),
                ("RocketYeast 2x2", RocketYeast, rocket, (2, 2)),
                ("RocketYeastForcesOnly 4x1", RocketYeastForcesOnly, forces,
                 (4, 1)),
                ("RocketYeastForcesOnly 2x2", RocketYeastForcesOnly, forces,
                 (2, 2))):
            for k in order:
                sh = ShardedCoupled(cls(device="cuda", **kw),
                                    mesh=make_mesh(devices=["cuda"] * 4,
                                                   shape=shape), k_steps=k)
                assert sh.steps_per_call == k
                sh.run(64)  # warm
                runs = []
                for _ in range(5):
                    sh.run(64, timed=True)
                    runs.append(sh.last_mlups)
                out.setdefault(f"MLUPS ShardedCoupled {label} K={k}",
                               []).extend(runs)
                del sh
                torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
