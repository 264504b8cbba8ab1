"""Karman vortex street behind a cylinder: the reference's movie workload
at a Reynolds number that sheds.

The cs205/vortex_sheet movies (``docs/cs205_movie.ipynb``) drive an
obstacle flow with a velocity inlet in lattice units. This script sets that
flow up with direct control of the Reynolds number: ``Re = u_w * d /
nu_lb`` with the cylinder diameter ``d`` in lattice cells, so ``Re ~ 150``
sheds periodically (onset ~47 unbounded). The cylinder sits slightly off
the channel centerline, the standard symmetry-breaking perturbation that
lets the street develop in a few convective times.

Frames are rendered on the model's device through
``lb2d_tpu_torch.utils.render`` with a numpy colormap (``anchor_lut``, no
matplotlib) and written as PNGs.

Usage: python examples_torch/karman_street.py [outdir] [num_frames] [Re] [--cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from lb2d_tpu_torch.models import PipeFlowVelocityInlet
from lb2d_tpu_torch.utils.render import FieldAnimator, anchor_lut


def build(Re=150.0, lx=1000, ly=300, u_w=0.1, d=40, device="cuda"):
    # the lattice-units classes use the reference's inclusive grids:
    # (ly+1) x (lx+1) nodes
    yy, xx = np.mgrid[0:ly + 1, 0:lx + 1]
    cy, cx = ly // 2 - 8, lx // 5          # slightly below the centerline
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= (d / 2) ** 2
    nu_lb = u_w * d / Re
    omega = 1.0 / (0.5 + 3.0 * nu_lb)
    return PipeFlowVelocityInlet(u_w=u_w, omega=omega, lx=lx, ly=ly,
                                 obstacle_mask=mask, device=device)


def main(outdir="karman_frames", num_frames=80, Re=150.0, device="cuda",
         lx=1000, ly=300, d=40, steps_per_frame=500):
    """Write ``num_frames`` frames of u; print and return the grid, the
    backend, the steps, the frame loop's MLUPS (rendering and PNG writing
    included), the range of u and the frames' paths."""
    os.makedirs(outdir, exist_ok=True)
    sim = build(Re=float(Re), lx=lx, ly=ly, d=d, device=device)
    print(f"grid {sim.nx}x{sim.ny}, omega={sim.omega:.4f}, Re={Re}, "
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
          f"{result['mlups']:.1f} MLUPS with the rendering, u in "
          f"[{result['u_min']:.4f}, {result['u_max']:.4f}])")
    return result


if __name__ == "__main__":
    a = [x for x in sys.argv[1:] if x != "--cpu"]
    main(*([a[0]] if a else []),
         **({"num_frames": int(a[1])} if len(a) > 1 else {}),
         **({"Re": float(a[2])} if len(a) > 2 else {}),
         device="cpu" if "--cpu" in sys.argv else "cuda")
