"""Time K2 and K4 per launch on the card, at the shapes of PERF.md's kernel
table, and print one JSON line.

    cd <checkout> && python3 <path>/tools/time_tile_kernels.py [label]

imports ``lb2d_tpu_torch`` from the working directory, so one copy of this
script times any checkout of the port: run two checkouts in turns (A, B, B,
A) in one command on one card to compare them. Each kernel: 100 launches
between two CUDA events, five times; the median is printed, in ms per
launch. Shapes: K2 flow 4096^2 at K = 3, K2 diffusion and noisy Fisher
2048^2 at K = 3 and 2, K4 fisher 2048^2 with F = 2 and K4 expansion 1024^2
with F = 3, both at K = 4 (the models' ``auto`` paths); where the checkout
has K9, K9 flow on the first 2048 x 8192 shard of an 8192^2 grid (the
sharded main path's) and K9 noisy Fisher on a 1024^2 shard of a 2048^2
grid, from random states.
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
    sim = PipeFlow(device="cuda", **FLOW)
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho, incompressible=False)
    out["K2 flow 4096^2 K=3"] = _median_ms(_ping_pong(
        sim.state, lambda a, b: temporal_pipe_step(a, b, 3, **kw)))
    del sim
    for name, cls, cfg, k in (("diffusion", AdvectionDiffusion, ADVECTION, 3),
                              ("noisy_fisher",
                               ReactionAdvectionDiffusionStochastic,
                               STOCHASTIC, 2)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        out[f"K2 {name} 2048^2 K={k}"] = _median_ms(_ping_pong(
            sim.state, lambda a, b: temporal_diffusion_step(a, b, k,
                                                            **kw)))
    for name, cls, cfg in (("fisher", FisherExpansion, FISHER),
                           ("expansion", Expansion, EXPANSION)):
        sim = cls(device="cuda", **cfg)
        kw = sim.step_kwargs()
        out[f"K4 {name} {sim.ny}^2 F={sim.num_fields} K=4"] = _median_ms(
            _ping_pong(sim.state, lambda a, b: temporal_multifield_step(
                a, b, 4, **kw)))
    try:
        from lb2d_tpu_torch.ops.fused_halo import Halo, temporal_halo_step
    except ImportError:  # a checkout from before K9
        Halo = None
    if Halo is not None:
        for name, n, H, k, physics, kw in (
                ("flow", 8192, 2048, 3, "flow",
                 dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0,
                      incompressible=False)),
                ("noisy_fisher", 2048, 1024, 2, "noisy_fisher",
                 dict(omega=1.7, u_lb=0.01, v_lb=-0.02, lb_G=0.01,
                      lb_Dg=0.05, seed=3))):
            g = torch.Generator(device="cuda").manual_seed(0)
            f = (1 + 0.01 * torch.randn((9, n, n), device="cuda",
                                        generator=g)) / 9
            halo = Halo.cut(f, 0, 0, H, n if name == "flow" else H, k)
            del f
            outb = torch.empty_like(halo.f)
            out[f"K9 {name} {H}x{halo.f.shape[2]} shard K={k}"] = _median_ms(
                lambda: temporal_halo_step(halo, outb, k, physics, **kw))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
