"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lb2d_tpu_torch/csrc``, holds each against
its plain PyTorch version on the card, drives the main path (``PipeFlow``
at 4096^2, the ``bench.py`` workload, and at the reference's 32x256
benchmark grid; ``PipeFlowVelocityInlet`` at its default 401x401) through
the kernels that ``backend="auto"`` picks, checks the physics (Poiseuille
profile through each kernel backend, cylinder mass), and prints the
measured numbers. Every phase raises on failure; the
last line is the JSON result and is printed only when all phases passed.
Uses no JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from lb2d_tpu_torch.models import (
    PipeFlow,
    PipeFlowCylinder,
    PipeFlowVelocityInlet,
)
from lb2d_tpu_torch.models.pipe_flow import TEMPORAL_K
from lb2d_tpu_torch.ops import _build
from lb2d_tpu_torch.ops.fused import (
    pipe_run_reference,
    pipe_step,
    resident_pipe_run,
    temporal_pipe_step,
    temporal_velocity_step,
    velocity_step_reference,
)

BENCH_PHYS = dict(diameter=1.0, rho=1.0, viscosity=0.1, pressure_grad=-0.01,
                  pipe_length=1.0)   # bench.py's workload, N=4095 -> 4096^2
POISEUILLE = dict(diameter=1.5, rho=10.0, viscosity=5.0, pressure_grad=-100.0,
                  pipe_length=3.0)   # tests/test_pipe_flow.py
SMALL = dict(POISEUILLE, pipe_length=1.5 * 254.5 / 31)  # N=31 -> 32x256,
# the reference's launch-bound benchmark grid (benchmarks/run_all.py)
CYLINDER = dict(diameter=1.0, rho=1.0, viscosity=1.0, pressure_grad=-10.0,
                pipe_length=3.0, cylinder_center=(0.75, 0.5),
                cylinder_radius=0.1)  # examples/backend_comparison.py
KERNEL_TOL = 1e-6   # ~30 ulp at |f| <= 0.45: nvcc's FMA contraction
BYTES_PER_CELL = 72  # 9 float32 reads + 9 writes per cell-step
MAIN_STEPS = 1000    # 4096^2: 333 K2 launches of 3 steps and 1 K1 step
SMALL_STEPS = 20000  # 32x256: one K3 launch
INLET_STEPS = 1000   # 401x401 velocity inlet: 334 K2 launches
RESIDENT_CHECK_STEPS = (8, 9)  # both parities of the K3 buffer swap
H100_SXM = "H100 80GB HBM3"
H100_SXM_HBM = 3.35e12  # B/s, NVIDIA's H100 SXM data sheet


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test runs only on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if H100_SXM not in torch.cuda.get_device_name(0):
        raise RuntimeError(f"the roofline below assumes an {H100_SXM} (SXM) "
                           "card")
    return card


def build_phase():
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}",
          flush=True)


def _events_ms(fn, n):
    """Mean device time of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _disk(ny, nx):
    Y, X = np.mgrid[:ny, :nx]
    return ((X - nx / 3) ** 2 + (Y - ny / 2) ** 2 <= (ny / 6) ** 2
            ).astype(np.int32)


def _inputs(sim, obstacle):
    """The model's state with a 1% perturbation (numpy seed 0), and the
    kernel arguments of its step."""
    rng = np.random.RandomState(0)
    f0 = sim.state * torch.tensor(
        (1 + 0.01 * rng.randn(9, sim.ny, sim.nx)).astype(np.float32),
        device="cuda")
    if obstacle is True:
        mask = torch.tensor(_disk(sim.ny, sim.nx), device="cuda")
    else:
        mask = obstacle  # None or the model's own mask
    kw = dict(omega=sim.omega, inlet_rho=sim.inlet_rho,
              outlet_rho=sim.outlet_rho,
              incompressible=sim.equilibrium == "incompressible", mask=mask)
    return f0, kw


def _max_diff(a, b):
    torch.cuda.synchronize()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("non-finite populations in the comparison")
    return float((a - b).abs().max())


def compare_k1(sim, obstacle, steps=4):
    f0, kw = _inputs(sim, obstacle)
    a, spare = f0.clone(), torch.empty_like(f0)
    for _ in range(steps):
        a, spare = pipe_step(a, spare, **kw), a
    return _max_diff(a, pipe_run_reference(f0, steps, **kw))


def compare_k2(sim, obstacle, k=TEMPORAL_K):
    f0, kw = _inputs(sim, obstacle)
    out = temporal_pipe_step(f0, torch.empty_like(f0), k, **kw)
    return _max_diff(out, pipe_run_reference(f0, k, **kw))


def compare_k3(sim, obstacle, n):
    f0, kw = _inputs(sim, obstacle)
    f = f0.clone()
    resident_pipe_run(f, torch.empty_like(f), n, **kw)
    return _max_diff(f, pipe_run_reference(f0, n, **kw))


def compare_k2_velocity(sim, obstacle, outlet, incompressible,
                        k=TEMPORAL_K):
    """K2 with the velocity BCs against ``k`` plain velocity-inlet steps."""
    f0, kw = _inputs(sim, obstacle)
    kw = dict(omega=sim.omega, u_w=sim.u_w, u_e=sim.u_e, outlet=outlet,
              incompressible=incompressible, mask=kw["mask"])
    out = temporal_velocity_step(f0, torch.empty_like(f0), k, **kw)
    want = f0
    for _ in range(k):
        want = velocity_step_reference(want, **kw)
    return _max_diff(out, want)


def _checked(label, d):
    print(f"{label}: max|df| = {d:.3e}", flush=True)
    if not d <= KERNEL_TOL:
        raise RuntimeError(f"{label}: kernel disagrees, {d} > {KERNEL_TOL}")
    return d


def kernel_phase(main, small, cyl, inlet):
    """Each kernel against its plain version at the main path's shapes (and
    its four variants at an unaligned grid). Returns max |df| per kernel."""
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K2v": 0.0}
    for eq in ("compressible", "incompressible"):
        sim = PipeFlow(N=253, pipe_length=380.5 / 253, equilibrium=eq,
                       diameter=1.0, rho=10.0, viscosity=5.0,
                       pressure_grad=-100.0, device="cuda")
        assert (sim.ny, sim.nx) == (254, 382)
        tiny = PipeFlow(N=31, equilibrium=eq, device="cuda", **SMALL)
        for obstacle in (False, True):
            tag = f"{eq} obstacle={obstacle}"
            worst["K1"] = max(worst["K1"], _checked(
                f"K1 vs plain 254x382 {tag}, 4 steps",
                compare_k1(sim, obstacle or None)))
            worst["K2"] = max(worst["K2"], _checked(
                f"K2 vs plain 254x382 {tag}, {TEMPORAL_K} steps",
                compare_k2(sim, obstacle or None)))
            for n in RESIDENT_CHECK_STEPS:
                worst["K3"] = max(worst["K3"], _checked(
                    f"K3 vs plain 32x256 {tag}, {n} steps",
                    compare_k3(tiny, obstacle or None, n)))
    n = f"{main.ny}x{main.nx} compressible"
    worst["K1"] = max(worst["K1"], _checked(
        f"K1 vs plain {n}, 4 steps", compare_k1(main, None)))
    worst["K2"] = max(worst["K2"], _checked(
        f"K2 vs plain {n}, {TEMPORAL_K} steps", compare_k2(main, None)))
    cyl_mask = cyl.obstacle_mask.to(torch.int32)
    worst["K2"] = max(worst["K2"], _checked(
        f"K2 vs plain cylinder {cyl.ny}x{cyl.nx}, {TEMPORAL_K} steps",
        compare_k2(cyl, cyl_mask)))
    for n in RESIDENT_CHECK_STEPS:
        worst["K3"] = max(worst["K3"], _checked(
            f"K3 vs plain {small.ny}x{small.nx} model state, {n} steps",
            compare_k3(small, None, n)))
    for outlet in ("zero_gradient", "velocity"):
        for incompressible in (False, True):
            for obstacle in (False, True):
                worst["K2v"] = max(worst["K2v"], _checked(
                    f"K2 velocity inlet vs plain {inlet.ny}x{inlet.nx} "
                    f"outlet={outlet} incompressible={incompressible} "
                    f"obstacle={obstacle}, {TEMPORAL_K} steps",
                    compare_k2_velocity(inlet, obstacle or None, outlet,
                                        incompressible)))
    return worst


def timing_phase(main, small, inlet):
    """Device time of one launch of each kernel at the main path's shapes
    and of the plain version doing the same steps, by CUDA events, plus a
    device-to-device copy as the practical bandwidth ceiling. Launches here
    are not main-path launches."""
    kw = dict(omega=main.omega, inlet_rho=main.inlet_rho,
              outlet_rho=main.outlet_rho, incompressible=False)
    bufs = [main.state.clone(), torch.empty_like(main.state)]

    def k1():
        pipe_step(bufs[0], bufs[1], **kw)
        bufs.reverse()

    def k2():
        temporal_pipe_step(bufs[0], bufs[1], TEMPORAL_K, **kw)
        bufs.reverse()

    def plain(n):
        def run():
            bufs[0] = pipe_run_reference(bufs[0], n, **kw)
        return run

    times = {}
    for name, fn, reps in (("K1", k1, 200), ("K2", k2, 100)):
        fn()
        times[name] = _events_ms(fn, reps)
    plain(1)()
    times["plain K1"] = _events_ms(plain(1), 10)
    times["plain K2"] = _events_ms(plain(TEMPORAL_K), 4)
    src, dst = main.state, torch.empty_like(main.state)
    dst.copy_(src)
    copy_ms = _events_ms(lambda: dst.copy_(src), 50)
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    del bufs, dst

    n = 1000
    kw = dict(omega=small.omega, inlet_rho=small.inlet_rho,
              outlet_rho=small.outlet_rho, incompressible=False)
    f, scratch = small.state.clone(), torch.empty_like(small.state)
    resident_pipe_run(f, scratch, n, **kw)
    times["K3"] = _events_ms(lambda: resident_pipe_run(f, scratch, n, **kw), 5)
    g = [small.state.clone()]

    def plain_small():
        g[0] = pipe_run_reference(g[0], n, **kw)

    plain_small()
    times["plain K3"] = _events_ms(plain_small, 2)

    kw = dict(omega=inlet.omega, u_w=inlet.u_w, u_e=inlet.u_e,
              outlet=inlet.outlet, incompressible=False)
    bufs = [inlet.state.clone(), torch.empty_like(inlet.state)]

    def k2v():
        temporal_velocity_step(bufs[0], bufs[1], TEMPORAL_K, **kw)
        bufs.reverse()

    def plain_inlet():
        for _ in range(TEMPORAL_K):
            bufs[0] = velocity_step_reference(bufs[0], **kw)

    k2v()
    times["K2v"] = _events_ms(k2v, 200)
    plain_inlet()
    times["plain K2v"] = _events_ms(plain_inlet, 10)
    steps = {"K1": 1, "K2": TEMPORAL_K, "K3": n, "K2v": TEMPORAL_K}
    for k in ("K1", "K2", "K3", "K2v"):
        sim = {"K3": small, "K2v": inlet}.get(k, main)
        shape = f"{sim.ny}x{sim.nx}"
        print(f"{k} at {shape}: {times[k]:.4f} ms per launch of {steps[k]} "
              f"step(s); plain version {times['plain ' + k]:.4f} ms for the "
              f"same steps (CUDA events)", flush=True)
    print(f"copy_ of {src.numel() * 4 / 1e6:.0f} MB: {copy_ms:.4f} ms = "
          f"{copy_bw / 1e12:.3f} TB/s", flush=True)
    return times, steps, copy_bw


def main_path_phase(main, small, inlet, card, times, copy_bw):
    """The user's path: ``run(n, timed=True)`` on the models that
    ``backend="auto"`` built, with every kernel's launch count read around
    it."""
    main.run(2 * TEMPORAL_K + 1)  # warm every kernel this path launches
    small.run(10)
    inlet.run(TEMPORAL_K + 1)
    torch.cuda.synchronize()
    pipe_step.launches = 0
    temporal_pipe_step.launches = 0
    resident_pipe_run.launches = 0
    temporal_velocity_step.launches = 0
    main.run(MAIN_STEPS, timed=True)
    small.run(SMALL_STEPS, timed=True)
    inlet.run(INLET_STEPS, timed=True)
    launches = {"K1": pipe_step.launches,
                "K2": temporal_pipe_step.launches,
                "K3": resident_pipe_run.launches,
                "K2v": temporal_velocity_step.launches}
    expected = {"K1": MAIN_STEPS % TEMPORAL_K,
                "K2": MAIN_STEPS // TEMPORAL_K, "K3": 1,
                "K2v": -(-INLET_STEPS // TEMPORAL_K)}
    print(f"main path launches {launches} (expected {expected})", flush=True)
    if launches != expected or min(launches.values()) < 1:
        raise RuntimeError(f"kernel launches {launches} != {expected}")
    for sim in (main, small, inlet):
        if not torch.isfinite(sim.state).all():
            raise RuntimeError("non-finite state after the main path")
        fields = (sim.get_fields() if sim is inlet
                  else sim.get_physical_fields())
        if (fields["u"].shape != (sim.nx, sim.ny)
                or not np.isfinite(fields["u"]).all()):
            raise RuntimeError("bad physical fields after the main path")

    plain = PipeFlow(N=4095, device="cuda", backend="eager", **BENCH_PHYS)
    plain.run(2)
    plain.run(20, timed=True)
    plain_small = PipeFlow(N=31, device="cuda", backend="eager", **SMALL)
    plain_small.run(20)
    plain_small.run(500, timed=True)
    plain_inlet = PipeFlowVelocityInlet(device="cuda", backend="eager")
    plain_inlet.run(20)
    plain_inlet.run(200, timed=True)
    for sim, ref, steps in ((main, plain, MAIN_STEPS),
                            (small, plain_small, SMALL_STEPS),
                            (inlet, plain_inlet, INLET_STEPS)):
        print(f"main path {type(sim).__name__} {sim.ny}x{sim.nx} "
              f"backend={sim.backend}: "
              f"{sim.last_mlups:.1f} MLUPS over {steps} steps; plain (eager) "
              f"{ref.last_mlups:.1f} MLUPS; card: {card}", flush=True)
    equiv = main.last_mlups * 1e6 * BYTES_PER_CELL
    k1_bw = main.num_cells * BYTES_PER_CELL / (times["K1"] * 1e-3)
    print(f"4096^2 at {BYTES_PER_CELL} B/cell-step: the main path's "
          f"single-step-equivalent traffic {equiv / 1e12:.3f} TB/s = "
          f"{equiv / H100_SXM_HBM:.3f} of the {H100_SXM_HBM / 1e12:.2f} TB/s "
          f"data sheet (K2 moves fewer bytes per step); K1 alone "
          f"{k1_bw / 1e12:.3f} TB/s = {k1_bw / H100_SXM_HBM:.3f} of the data "
          f"sheet, {k1_bw / copy_bw:.3f} of the measured copy_; card: {card}",
          flush=True)
    del plain, plain_small, plain_inlet
    return launches


def physics_phase(cyl):
    for backend in ("resident", "temporal", "kernel"):
        sim = PipeFlow(N=10, device="cuda", backend=backend, **POISEUILLE)
        sim.run(int(10.0 / sim.units.delta_t))
        mean_u = sim.get_physical_fields()["u"].T.mean(axis=1)
        y = np.arange(mean_u.shape[0]) * sim.units.delta_x * sim.units.L
        predicted = ((1.0 / (2 * POISEUILLE["rho"] * POISEUILLE["viscosity"]))
                     * POISEUILLE["pressure_grad"] * y
                     * (y - POISEUILLE["diameter"]))
        err = float(np.sqrt(((mean_u - predicted) ** 2).mean()))
        print(f"Poiseuille N=10 through backend={backend}: RMS error "
              f"{err:.5f} (u_max {predicted.max():.4f}, limit 5%)", flush=True)
        if not err < 0.05 * 0.5625:
            raise RuntimeError(f"Poiseuille RMS error {err} >= 5% of u_max")

    rho_before = float(cyl.device_field("rho").mean())
    cyl.run(200)
    rho = cyl.device_field("rho")
    drift = abs(float(rho.mean()) - rho_before)
    print(f"cylinder {cyl.ny}x{cyl.nx} backend={cyl.backend} 200 steps: mean "
          f"rho drift {drift:.3e}", flush=True)
    if not (torch.isfinite(rho).all() and drift < 0.1):
        raise RuntimeError("cylinder run is not finite or lost mass")


def main():
    card = device_phase()
    build_phase()
    main_sim = PipeFlow(N=4095, device="cuda", **BENCH_PHYS)
    small = PipeFlow(N=31, device="cuda", **SMALL)
    cyl = PipeFlowCylinder(N=125, device="cuda", **CYLINDER)
    inlet = PipeFlowVelocityInlet(device="cuda")  # the reference's defaults
    shapes = {"main": (main_sim.backend, main_sim.ny, main_sim.nx),
              "small": (small.backend, small.ny, small.nx),
              "cylinder": (cyl.backend, cyl.ny, cyl.nx),
              "inlet": (inlet.backend, inlet.ny, inlet.nx)}
    print(f"backend='auto' picked {shapes}", flush=True)
    if shapes != {"main": ("temporal", 4096, 4096),
                  "small": ("resident", 32, 256),
                  "cylinder": ("temporal", 1251, 3751),
                  "inlet": ("temporal", 401, 401)}:
        raise RuntimeError(f"unexpected backends or grids {shapes}")
    max_err = kernel_phase(main_sim, small, cyl, inlet)
    times, steps, copy_bw = timing_phase(main_sim, small, inlet)
    launches = main_path_phase(main_sim, small, inlet, card, times, copy_bw)
    physics_phase(cyl)
    sources = {"K1": ("pipe_step", "pipe_step.cu", "lb2d_tpu/ops/fused.py:682"),
               "K2": ("temporal_pipe_step", "temporal_step.cu",
                      "lb2d_tpu/ops/fused.py:888"),
               "K3": ("resident_pipe_run", "resident_run.cu",
                      "lb2d_tpu/ops/fused.py:1193"),
               "K2v": ("temporal_velocity_step", "temporal_step.cu",
                       "lb2d_tpu/ops/fused.py:888")}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"lb2d_tpu_torch/csrc/{src}", "replaces": tpu,
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": times[k], "plain_ms": times["plain " + k],
        "steps_per_launch": steps[k]}
        for k, (name, src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
