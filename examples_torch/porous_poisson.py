"""BASELINE config 5: porous two-fluid flow with a per-step screened-Poisson
repulsion, sharded over a mesh.

The workload composes the reference's two largest subsystems, the Guo
porous-media engine (``porous_media/single_component.py``) and the
spectral-repulsion coupling of the multicomponent runner
(``multicomponent_multiphase/multi.py:488-511``), at a scale the reference
could not hold (8192^2 needs ~5 GB for f alone; its GPU had 6 GB for
everything, no multi-device support, fp64-only kernels).

Per step here, on each shard: the multicomponent kernel on the shard and
its halo (K6h: stream, moments, Shan-Chen interaction, Darcy/Forchheimer
drag, Guo-forced BGK), and once per device the hand-written FFT solve of
the screened-Poisson force (K8). The mesh holds one shard per card; on a
machine with one card it holds four shards of that card, ``4 x 1``.

Usage: python examples_torch/porous_poisson.py [--size 2048] [--steps 50] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from lb2d_tpu_torch.models import Fluid, SimulationRunner
from lb2d_tpu_torch.parallel import make_mesh


def mesh_devices(device="cuda"):
    """One shard per card where there are several, else four shards of the
    one device (the card, or the CPU)."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [device] * 4


def main(size=2048, steps=50, device="cuda"):
    """Build config 5 at ``size``^2, shard it, ``run(steps, timed=True)``;
    print and return the mesh, the backend, MLUPS, each fluid's mass and
    whether the densities are finite."""
    devices = mesh_devices(device)
    mesh = make_mesh(devices=devices, shape=(len(devices), 1))
    sim = SimulationRunner(nx=size, ny=size, L_lb=size, T_lb=1.0,
                           num_populations=2, porous=True, device=device)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0, epsilon=0.8,
                            nu_fluid=1.0 / 6.0, K=10.0, Fe=0.1))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    base = 0.5 + 0.05 * rng.rand(size, size).astype(np.float32)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.5, potential="shan_chen",
                              potential_parameters=[1.0])
    sim.add_screened_poisson_force(0, 1, interaction_length=10.0,
                                   amplitude=1e-4)
    sim.shard_over(mesh)

    sim.run(steps, timed=True)
    rho = sim.rho.double().cpu().numpy()  # [C, ny, nx]
    result = dict(size=size, mesh=[len(devices), 1], devices=devices,
                  backend=sim.backend_used, mlups=sim.last_mlups,
                  mass0=float(rho[0].sum()), mass1=float(rho[1].sum()),
                  finite=bool(np.isfinite(rho).all()))
    print(f"{size}^2 porous+poisson on a {len(devices)}x1 mesh of "
          f"{sorted(set(devices))} ({result['backend']} backend): "
          f"{result['mlups']:.1f} MLUPS")
    print(f"mass: fluid0 {result['mass0']:.6g}  fluid1 {result['mass1']:.6g}"
          f"  finite: {result['finite']}")
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args()
    main(a.size, a.steps, device="cpu" if a.cpu else "cuda")
