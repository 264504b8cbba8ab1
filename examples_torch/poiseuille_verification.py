"""Poiseuille verification: profile against theory and convergence in N.

Script version of the reference's
``docs/opencl_dimensionless_verification.ipynb``: run the same pipe at
N = 10, 50, 200 to the same dimensionless time, compare the mean velocity
profile with ``(dP/dx / 2 rho nu) y (y - D)`` and report the RMS error
against N. On a card ``backend="auto"`` runs these grids through the
one-launch kernel (K3). The plot is drawn only where matplotlib imports.

Usage: python examples_torch/poiseuille_verification.py [out.png] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lb2d_tpu_torch.models import PipeFlow

PARAMS = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
              pipe_length=3.0)


def run(N, time_to_run=10.0, device="cuda"):
    """The pipe at resolution ``N`` run to ``time_to_run``: the model, the
    physical y of each row and the mean of u along x per row."""
    sim = PipeFlow(N=N, time_prefactor=1.0, device=device, **PARAMS)
    sim.run(int(time_to_run / sim.units.delta_t), timed=True)
    fields = sim.get_physical_fields()
    mean_u = fields["u"].T.mean(axis=1)
    y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
    return sim, y, mean_u


def main(out="poiseuille_verification.png", Ns=(10, 50, 200),
         device="cuda"):
    """Run each N; print and return one row per N (``N``, ``backend``,
    ``omega``, ``steps``, ``rms`` against theory in m/s, ``mlups``)."""
    D, rho, nu = PARAMS["diameter"], PARAMS["rho"], PARAMS["viscosity"]
    pref = PARAMS["pressure_grad"] / (2 * rho * nu)
    rows, profiles = [], []
    for N in Ns:
        sim, y, mean_u = run(N, device=device)
        rms = float(np.sqrt(((mean_u - pref * y * (y - D)) ** 2).mean()))
        rows.append(dict(N=N, backend=sim.backend, omega=float(sim.omega),
                         steps=sim.steps_taken, rms=rms,
                         mlups=sim.last_mlups))
        profiles.append((y, mean_u))
        print(f"N={N}: backend={sim.backend} omega={sim.omega:.5f} "
              f"steps={sim.steps_taken} rms={rms:.2e} "
              f"mlups={sim.last_mlups:.1f}", flush=True)
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no plot drawn")
        return rows
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for row, (y, mean_u) in zip(rows, profiles):
        ax1.plot(y, mean_u, ".", ms=3,
                 label=f"N={row['N']} ({row['mlups']:.0f} MLUPS)")
    yy = np.linspace(0, D, 200)
    ax1.plot(yy, pref * yy * (yy - D), "k-", lw=1, label="theory")
    ax1.set_xlabel("y [m]")
    ax1.set_ylabel("u [m/s]")
    ax1.legend()
    ax1.set_title("Poiseuille profile vs theory")
    ax2.loglog([r["N"] for r in rows], [r["rms"] for r in rows], "o-")
    ax2.set_xlabel("N")
    ax2.set_ylabel("RMS error [m/s]")
    ax2.set_title("Resolution convergence")
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(*args, device="cpu" if "--cpu" in sys.argv else "cuda")
