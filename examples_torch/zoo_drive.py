"""Drive the whole model zoo end to end on one device.

One construct -> run -> field-check pass over every model family the port
(and the reference) ships. On a card every model with a hand-written
kernel runs it through ``backend="auto"`` (the flow, diffusion and
multifield row sweeps or the one-launch kernel, the multicomponent kernel,
the coupled sweeps and the FFT solve), so this doubles as a smoke matrix of
the auto-selection; ``RepellingFisherWave``, ``PoissonSolver`` and
``ScreenedPoisson`` have no kernel (plain torch ops, CUDA graphs of them,
``torch.fft``). Prints a table of the backend picked and the throughput,
keeps driving after a failure, and raises when any row is not ``ok``.

Usage: python examples_torch/zoo_drive.py [--steps 200] [--big] [--cpu]
  --big uses production-scale grids for the kernel-backed families (a few
  minutes on a card).
"""

import gc
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from lb2d_tpu_torch import models as M

# the rows of the models without a hand-written kernel
NO_KERNEL = ("RepellingFisherWave", "PoissonSolver", "ScreenedPoisson")


def _release(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def drive(name, build, steps, field="rho", device="cuda"):
    """Build a model, run ``steps``, pull a field; the row ``[name,
    backend, MLUPS, status]``."""
    sim = None
    try:
        sim = build()
        backend = getattr(sim, "backend", None) or (
            "graphs" if sim.device.type == "cuda" else "eager")
        if getattr(sim, "steps_per_call", 1) > 1:
            backend += f" K={sim.steps_per_call}"
        sim.run(steps, timed=True)
        f = sim.get_fields()[field]
        ok = bool(np.isfinite(f).all())
        return [name, str(backend), sim.last_mlups,
                "ok" if ok else "NON-FINITE"]
    except Exception as e:  # keep driving the rest of the zoo
        traceback.print_exc()
        return [name, "-", None, f"FAIL: {type(e).__name__}: {e}"]
    finally:
        sim = None
        _release(device)  # the big grids must not pile up on the card


def zoo(big=False, device="cuda", tiny=False):
    """``(name, build)`` of every model family at ``examples/zoo_drive.py``'s
    sizes (``big``: production scale), or at the smallest sizes each model
    takes (``tiny``, for a test on the CPU)."""
    n_flow = 15 if tiny else (1023 if big else 255)
    n_cyl = 4 if tiny else 255
    n_diff = 15 if tiny else (341 if big else 63)  # 2048^2 / 128^2
    d_lx = 0.61 if big else 0.21
    n_cpl = 16 if tiny else None
    n_exp = 15 if tiny else (511 if big else 63)
    dev = dict(device=device)
    return [
        ("PipeFlow", lambda: M.PipeFlow(
            N=n_flow, pipe_length=(n_flow + 0.5) / n_flow, diameter=1.0,
            rho=1.0, viscosity=1.0, pressure_grad=-10.0, **dev)),
        # N counts cells per cylinder radius here (the characteristic
        # length), so the grid is ~10N x 10N: N=255 is already 2560^2
        ("PipeFlowCylinder", lambda: M.PipeFlowCylinder(
            N=n_cyl, pipe_length=1.0, diameter=1.0,
            rho=1.0, viscosity=1.0, pressure_grad=-10.0,
            cylinder_center=(0.5, 0.5), cylinder_radius=0.1, **dev)),
        ("PipeFlowVelocityInlet", lambda: M.PipeFlowVelocityInlet(
            u_w=0.05, omega=1.2, lx=n_flow, ly=n_flow, **dev)),
        ("LatticePipeFlow", lambda: M.LatticePipeFlow(
            omega=1.2, lx=n_flow, ly=n_flow, deltaP=-0.01, **dev)),
        ("Diffusion", lambda: M.Diffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, **dev)),
        ("AdvectionDiffusion", lambda: M.AdvectionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, vx=1.0, vy=0.5, vc=1.0,
            **dev)),
        ("ReactionDiffusion", lambda: M.ReactionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0, **dev)),
        ("ReactionAdvectionDiffusion", lambda: M.ReactionAdvectionDiffusion(
            Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0, vx=1.0, vy=1.0,
            vc=1.0, **dev)),
        ("ReactionAdvectionDiffusionStochastic",
         lambda: M.ReactionAdvectionDiffusionStochastic(
             Lx=d_lx, Ly=d_lx, z=0.1, N=n_diff, g=1.0, vx=1.0, vy=1.0,
             vc=1.0, Dg=0.05, **dev)),
        ("NoisyAdvectedFisherWave", lambda: M.NoisyAdvectedFisherWave(
            N=n_diff, z=0.1, Lx=d_lx, Ly=d_lx, D=1.0, g=10.0, Nc=10.0,
            **dev)),
        ("ScreenedFisherWave", lambda: M.ScreenedFisherWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
            N=n_cpl or (1024 if big else 48), **dev)),
        # sweep-stale variant: one spectral solve per 8-step kernel sweep
        ("ScreenedFisherWave-stale8", lambda: M.ScreenedFisherWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
            N=n_cpl or (1024 if big else 48),
            stale_velocity=8 if big else 2, **dev)),
        ("RepellingFisherWave", lambda: M.RepellingFisherWave(
            Lx=1.0, Ly=1.0, E=2.0, R0=0.25,
            N=12 if tiny else (128 if big else 24), max_inner_iter=60,
            # amortize the nested solve: reuse the converged potential
            # until mean |drho| drifts past 0.2% of mean rho
            reuse_tolerance=2e-3 if big else 0.0, **dev)),
        ("FisherExpansion", lambda: M.FisherExpansion(
            Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
            D_standard=1.0, D_list=[1.0, 1.2], N=n_exp,
            initial_frac_widths=[0.5, 0.5], initial_frac_indices=[0, 1],
            **dev)),
        ("Expansion", lambda: M.Expansion(
            Lx=4.1, Ly=4.1, mu_standard=1.0, mu_list=[1.0, 0.8],
            D_standard=1.0, D_list=[1.0, 1.2], N=n_exp, Nb=10.0, Dc=1.0,
            **dev)),
        ("SurfactantNutrientWave", lambda: M.SurfactantNutrientWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
            N=n_cpl or (512 if big else 32), **dev)),
        ("SurfactantNutrientWave-stale8", lambda: M.SurfactantNutrientWave(
            Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
            N=n_cpl or (1024 if big else 32),
            stale_velocity=8 if big else 2, **dev)),
        ("ClumpySurfactantNutrientWave",
         lambda: M.ClumpySurfactantNutrientWave(
             Lx=1.0, Ly=1.0, vc=1.0, lam=0.5, R0=0.2,
             N=n_cpl or (512 if big else 32), rho_o=1.0, G_chen=-5.0,
             **dev)),
        ("RocketYeast", lambda: M.RocketYeast(
            Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0,
            N=n_cpl or (1024 if big else 32), G_chen=-0.1, **dev)),
    ]


def _poisson_row(big, device, tiny):
    try:
        n_p = 16 if tiny else (512 if big else 64)
        solver = M.PoissonSolver(nx=n_p, ny=n_p, sources=np.ones((n_p, n_p)),
                                 delta_t=4e-4 * (64 / n_p) ** 2,
                                 delta_x=2.0 / n_p, device=device)
        solver.run(2000 if tiny else 20000, timed=True)
        phi = solver.get_fields()["rho"]
        note = "ok" if np.isfinite(phi).all() else "NON-FINITE"
        note += (f" ({int(solver.num_iterations)} iters, "
                 f"{solver.last_solve_seconds:.2f}s/solve, "
                 f"conv={solver.converged})")
        backend = "graphs" if solver.device.type == "cuda" else "eager"
        return ["PoissonSolver", backend, solver.last_mlups, note]
    except Exception as e:
        traceback.print_exc()
        return ["PoissonSolver", "-", None, f"FAIL: {type(e).__name__}: {e}"]


def _screened_poisson_row(device):
    try:
        phi, _, _ = M.screened_poisson_solve(
            np.ones((64, 64), np.float32), lam=1.0, dx=1.0, device=device)
        ok = bool(torch.isfinite(torch.view_as_real(phi)).all())
        return ["ScreenedPoisson", "torch.fft", None,
                "ok" if ok else "NON-FINITE"]
    except Exception as e:
        traceback.print_exc()
        return ["ScreenedPoisson", "-", None,
                f"FAIL: {type(e).__name__}: {e}"]


def _runner_row(steps, big, device, tiny):
    # the spinodal-decomposition notebook workload
    n_sc = 16 if tiny else (1024 if big else 128)
    try:
        runner = M.SimulationRunner(nx=n_sc, ny=n_sc, L_lb=n_sc, T_lb=1.0,
                                    num_populations=2, porous=False,
                                    device=device)
        for i in range(2):
            runner.add_fluid(M.Fluid(runner, i, nu_e=1.0 / 6.0, epsilon=1.0))
        runner.complete_setup()
        rng = np.random.RandomState(1)
        base = 0.5 + 0.05 * rng.rand(runner.ny, runner.nx)
        runner.fluid_list[0].initialize(base)
        runner.fluid_list[1].initialize(1.0 - base)
        # G=1.8 linear is past the stable quench depth at >=512^2 (rho
        # overshoots negative and diverges); 1.5 demixes strongly and stays
        # finite at every size
        runner.add_interaction_force(0, 1, G_int=1.5, potential="linear")
        runner.run(steps, timed=True)
        rho = runner.get_fields()["rho"]
        return [f"SimulationRunner (Shan-Chen x2) {n_sc}^2",
                f"{runner.backend_used} K={runner.steps_per_call}",
                runner.last_mlups,
                "ok" if np.isfinite(rho).all() else "NON-FINITE"]
    except Exception as e:
        traceback.print_exc()
        return ["SimulationRunner", "-", None,
                f"FAIL: {type(e).__name__}: {e}"]
    finally:
        _release(device)


def main(steps=200, big=False, device="cuda", tiny=False):
    """Drive every family; print the table and return its rows ``[name,
    backend, MLUPS or None, status]``. Raises ``RuntimeError`` after the
    table when any row is not ``ok``."""
    rows = [drive(name, build, steps, device=device)
            for name, build in zoo(big, device, tiny)]
    rows.append(_poisson_row(big, device, tiny))
    rows.append(_screened_poisson_row(device))
    rows.append(_runner_row(steps, big, device, tiny))

    where = (torch.cuda.get_device_name(torch.device(device))
             if torch.device(device).type == "cuda" else "cpu")
    size = "tiny" if tiny else ("big" if big else "small")
    print(f"\n=== model zoo drive | {where} | steps={steps} | {size} "
          "grids ===")
    print(f"{'model':38s} {'backend':16s} {'MLUPS':>10s}  status")
    failed = [row for row in rows if not row[3].startswith("ok")]
    for name, backend, mlups, status in rows:
        shown = "-" if mlups is None else f"{mlups:.1f}"
        print(f"{name:38s} {backend:16s} {shown:>10s}  {status}")
    print(f"\n{len(rows) - len(failed)}/{len(rows)} families ok", flush=True)
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(rows)} families failed: "
                           f"{[row[0] for row in failed]}")
    return rows


if __name__ == "__main__":
    steps = 200
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    main(steps, big="--big" in sys.argv,
         device="cpu" if "--cpu" in sys.argv else "cuda")
