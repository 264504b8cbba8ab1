"""Backend comparison on the reference's exact benchmark workload.

Reproduces ``docs/python_cython_opencl_comparison.ipynb``:
``Pipe_Flow_Cylinder`` with D=1, rho=1, nu=1, dP/dx=-10, pipe = 3D,
cylinder r = D/10 at (0.75, 0.5), N=125 -> 3751 x 1251 = 4.693e6 cells,
1000 steps, on the card through ``backend="auto"`` (the row-sweep kernel
K2 at this size). The reference's own results on this workload are printed
beside, as the reference's: pure Python 0.50 MLUPS, Cython 5.9 MLUPS,
pyOpenCL on a GTX Titan Black 325 MLUPS. The C++ CPU engine
(``backend="native"``) runs a reduced copy (N = 50) on the host CPU.

The JAX script's second row, the same cell count on a grid aligned to 128
lanes, measured a TPU kernel's alignment gate; the port's kernels run any
grid, so it is left out.

Usage: python examples_torch/backend_comparison.py [--steps 1000] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lb2d_tpu_torch.models import PipeFlowCylinder

PHYS = dict(diameter=1.0, rho=1.0, viscosity=1.0, pressure_grad=-10.0,
            pipe_length=3.0)
CYL = dict(cylinder_center=(0.75, 0.5), cylinder_radius=0.1)
REFERENCE = {"python (CPU)": 0.50, "cython (CPU)": 5.9,
             "pyOpenCL (GTX Titan Black)": 325.0}


def main(steps=1000, device="cuda", N=125, native_N=50):
    """Time the exact workload (``N`` = 125) through ``backend="auto"`` on
    ``device`` and the native engine at ``native_N``; print the table and
    return ``{"reference": REFERENCE, "grid": [ny, nx], "backend": ...,
    "rows": {name: MLUPS}}`` (the native row is missing, with
    ``native_error`` set, where the engine does not build)."""
    result = {"reference": dict(REFERENCE), "rows": {}}
    sim = PipeFlowCylinder(N=N, time_prefactor=1.0, device=device, **PHYS,
                           **CYL)
    result.update(grid=[sim.ny, sim.nx], backend=sim.backend)
    print(f"exact workload grid {sim.nx}x{sim.ny} "
          f"({sim.nx * sim.ny / 1e6:.3f}M cells), backend={sim.backend}, "
          f"device={sim.device}", flush=True)
    sim.run(steps, timed=True)
    result["rows"][f"lb2d_tpu_torch {sim.backend} (exact grid)"] = (
        sim.last_mlups)
    del sim
    try:  # the C++ engine on the host CPU, a reduced copy
        nat = PipeFlowCylinder(N=native_N, time_prefactor=1.0,
                               backend="native", device=device, **PHYS,
                               **CYL)
        nat.run(max(50, steps // 10), timed=True)
        result["native_grid"] = [nat.ny, nat.nx]
        result["rows"][f"lb2d_tpu_torch native C++ (CPU, N={native_N})"] = (
            nat.last_mlups)
    except RuntimeError as e:
        result["native_error"] = str(e)
        print("native backend unavailable:", e)

    print("\n=== MLUPS on the reference benchmark workload ===")
    for name, val in REFERENCE.items():
        print(f"{name + ' (reference)':48s} {val:10.1f}")
    for name, val in result["rows"].items():
        print(f"{name:48s} {val:10.1f}")
    return result


if __name__ == "__main__":
    steps = 1000
    if "--steps" in sys.argv:
        steps = int(sys.argv[sys.argv.index("--steps") + 1])
    main(steps, device="cpu" if "--cpu" in sys.argv else "cuda")
