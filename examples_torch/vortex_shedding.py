"""Vortex shedding behind a cylinder: the reference's movie workload.

Script version of ``docs/cs205_movie.ipynb`` / ``docs/vortex_sheet_movie.
ipynb``: flow past a cylinder at moderate Reynolds number, frames rendered
on the model's device (``lb2d_tpu_torch.utils.render.FieldAnimator`` with a
numpy colormap, ``anchor_lut``: no matplotlib) and written as PNGs.

Usage: python examples_torch/vortex_shedding.py [outdir] [num_frames] [viscosity] [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from lb2d_tpu_torch.models import PipeFlowCylinder
from lb2d_tpu_torch.utils.render import FieldAnimator, anchor_lut


def main(outdir="vortex_frames", num_frames=20, viscosity=0.25,
         device="cuda", N=40, steps_per_frame=400):
    """Write ``num_frames`` frames of u; print and return the grid, the
    backend, the steps, the frame loop's MLUPS (rendering and PNG writing
    included), the range of u and the frames' paths."""
    os.makedirs(outdir, exist_ok=True)
    # cylinder of radius D/15 in a 3D-long pipe (vortex_sheet_movie.ipynb
    # uses r = D/25 at N=125; smaller here for a quick demo). The default
    # viscosity gives a creeping-flow demo (cylinder Re < 1); pass
    # viscosity ~0.002 for a Re ~ 50-100 flow that sheds a Karman street.
    D = 1.5
    sim = PipeFlowCylinder(
        # the cylinder sits slightly off the channel centerline, the
        # standard symmetry-breaking perturbation, without which the
        # (perfectly symmetric) discrete flow can hold an unstable
        # symmetric wake for tens of thousands of steps
        cylinder_center=(0.75, 0.72), cylinder_radius=D / 15,
        # scale the pressure gradient with viscosity so the steady
        # velocity (and the lattice Mach number) stays fixed while Re
        # sweeps: u_max ~ |dp/dx| D^2 / (8 rho nu)
        diameter=D, rho=10.0, viscosity=float(viscosity),
        pressure_grad=-10.0 * (float(viscosity) / 0.25),
        pipe_length=3 * D, N=N, device=device)
    print(f"grid {sim.nx}x{sim.ny}, omega={sim.omega:.4f}, "
          f"backend={sim.backend}", flush=True)
    anim = FieldAnimator(sim, field="u", steps_per_frame=steps_per_frame,
                         lut=anchor_lut())
    paths = []
    sim.block_until_ready()
    t0 = time.perf_counter()
    for k in range(int(num_frames)):
        paths.append(os.path.join(outdir, f"frame_{k:04d}.png"))
        anim.save_png(paths[-1])
    dt = time.perf_counter() - t0
    u = sim.device_field("u")
    result = dict(grid=[sim.ny, sim.nx], backend=sim.backend,
                  steps=sim.steps_taken,
                  mlups=sim.num_cells * sim.steps_taken / dt / 1e6,
                  u_min=float(u.min()), u_max=float(u.max()),
                  finite=bool(torch.isfinite(sim.state).all()), frames=paths)
    print(f"wrote {num_frames} frames to {outdir}/ ({sim.steps_taken} steps, "
          f"{result['mlups']:.1f} MLUPS with the rendering)")
    return result


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(*([args[0]] if args else []),
         **({"num_frames": int(args[1])} if len(args) > 1 else {}),
         **({"viscosity": float(args[2])} if len(args) > 2 else {}),
         device="cpu" if "--cpu" in sys.argv else "cuda")
