"""Two-fluid Shan-Chen spinodal decomposition.

Script version of ``docs/multicomponent/multicomponent_test.ipynb``: two
mutually repelling fluids demix from a noisy mixture into domains. On a
card ``SimulationRunner`` runs the multicomponent kernel K6. The figure is
drawn only where matplotlib imports; the numbers are printed either way.

Usage: python examples_torch/spinodal_decomposition.py [out.png] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lb2d_tpu_torch.models import Fluid, SimulationRunner


def build(n=128, device="cuda"):
    sim = SimulationRunner(nx=n, ny=n, L_lb=n, num_populations=2,
                           porous=False, device=device)
    for i in range(2):
        sim.add_fluid(Fluid(sim, i, nu_e=1.0 / 6.0))
    sim.complete_setup()
    rng = np.random.RandomState(0)
    base = 0.5 + 0.05 * rng.rand(n, n)
    sim.fluid_list[0].initialize(base)
    sim.fluid_list[1].initialize(1.0 - base)
    sim.add_interaction_force(0, 1, G_int=1.8, potential="linear")
    return sim


def main(out="spinodal.png", n=128, snapshots=(0, 200, 800, 3000),
         device="cuda"):
    """Run to each step of ``snapshots``; print and return one row per
    snapshot: the step, fluid 0's density range and its standard deviation
    (which grows as the fluids separate), and the total mass."""
    sim = build(n, device)
    print(f"{n}x{n} two-fluid Shan-Chen, backend={sim.backend}", flush=True)
    rows, images = [], []
    for steps in snapshots:
        if steps > sim.steps_taken:
            sim.run(steps - sim.steps_taken)
        rho = sim.get_fields()["rho"]  # [nx, ny, C]
        rows.append(dict(step=sim.steps_taken, rho0_min=float(rho[..., 0].min()),
                         rho0_max=float(rho[..., 0].max()),
                         rho0_std=float(rho[..., 0].std()),
                         mass=float(rho.astype(np.float64).sum()),
                         finite=bool(np.isfinite(rho).all())))
        images.append(rho[:, :, 0])
        print("step {step}: rho0 in [{rho0_min:.4f}, {rho0_max:.4f}], std "
              "{rho0_std:.4f}, mass {mass:.6f}".format(**rows[-1]),
              flush=True)
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no figure drawn")
        return rows
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(rows), figsize=(3.5 * len(rows), 3.5))
    for ax, row, img in zip(np.atleast_1d(axes), rows, images):
        ax.imshow(img.T, cmap="RdBu", vmin=0, vmax=1.2)
        ax.set_title(f"step {row['step']}")
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(*args, device="cpu" if "--cpu" in sys.argv else "cuda")
