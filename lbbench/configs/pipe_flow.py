"""``pipe_flow``: the reference's single-component D2Q9 channel through the
port, ``PipeFlow`` or ``PipeFlowCylinder`` (pressure-driven, Zou-He
pressure inlet and outlet, bounce-back walls, a bounce-back cylinder where
the mix has one), float32, ``backend="auto"``: K3 where the grid fits its
shared memory, K2 (and K1 for a remainder) above. Each traffic mix gives
its problem's physical parameters and names their source.

One interval is what a user of the reference's notebooks does in a loop:
``run(M)``, then a look at the fields. Every interval the monitoring
readout: ``MachWatchdog.check`` on ``device_field("u")`` and
``device_field("v")`` (``"mach"``), or the ``u`` profile across the
channel at mid-length (``"u_profile"``); every ``snapshot_every``-th
interval a snapshot of ``rho``, ``u`` and ``v`` into pinned host buffers.
The port is imported only when a cell is built.

The initial state is the mix's ``initial``. ``"density_waves"``: the
equilibrium at rest of the inlet-to-outlet density ramp times
``1 + amplitude s(x, y)``, where ``s`` sums the mix's standing waves
(fixed wave numbers) with weights and phases drawn on the card from the
seed, and peaks at 1 at most; the waves keep the speeds far above
float32's rounding for the whole window, so the check sees the velocity
terms (the program's own start, 0.1% white noise per population, decays
within an interval to speeds of 1e-5 at 4096^2, float32's rounding's
size there). ``"program"``: the program's own start from the seed, for a
cell where the waves would change the program's path: at rest, a solid
cell's populations are symmetric and stay so under bounce-back, and K2's
obstacle branch runs 1.5 times as long on such cells as on the noisy ones
that users' starts give.
"""

import math

import numpy as np
import torch

SOURCE = ("https://github.com/latticeboltzmann/2d-lb/tree/master/LB_D2Q9/"
          "dimensionless")
# what the benchmark sets that the source leaves open
ASSUMED = {
    "dtype": "float32",
    "backend": "auto",
    "equilibrium": "compressible",
    "convention": "W",
    "time_prefactor": 1.0,
    "initial_state": "the mix's initial.kind: 'density_waves', feq at rest "
                     "of the inlet-to-outlet density ramp times 1 + amplitude "
                     "s(x, y), s the mix's standing waves, weights U(0.5, 1) "
                     "and phases U(0, 2 pi) from torch.Generator(device)"
                     ".manual_seed(seed), normalised to peak at 1 at most; "
                     "'program', the program's own, the ramp's feq times "
                     "1 + 0.001 randn per population from "
                     "np.random.RandomState(seed % 2**32)",
    "perturbation_amplitude": "the mix's initial.amplitude (0.001) for "
                              "'density_waves'; 0.001 for 'program'",
}


def work(mix) -> dict:
    """The work of the flow steps by kernel family (``lbbench/kernels``):
    K2 (with K1) or K3, whichever ``backend="auto"`` picks."""
    from lbbench.kernels import _counts
    w = _counts.flow_work(mix["model"] == "PipeFlowCylinder")
    return {"k2": w, "k3": w}


def inputs(mix, seed, device) -> dict:
    """The raw input both sides read: the seed of the program's
    ``np.random.RandomState`` perturbation, or the standing waves' weights
    and phases, drawn on ``device`` from ``seed``."""
    kind = mix["initial"]["kind"]
    if kind == "program":
        return {"seed": seed % 2**32}
    if kind != "density_waves":
        raise ValueError(f"unknown initial state {kind!r}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    draw = torch.rand((2, len(mix["initial"]["modes"])), generator=g,
                      device=device, dtype=torch.float64)
    return {"weights": 0.5 + 0.5 * draw[0], "phases": 2 * math.pi * draw[1]}


def wave_field(mix, inputs, ny, nx, device) -> torch.Tensor:
    """``s(x, y)`` in float64 on ``device``: the sum of
    ``w cos(2 pi (kx x / nx + ky y / ny) + phase)`` over the mix's modes
    ``[kx, ky]``, over the sum of the weights."""
    w = inputs["weights"].to(device)
    ph = inputs["phases"].to(device)
    x = torch.arange(nx, dtype=torch.float64, device=device) / nx
    y = torch.arange(ny, dtype=torch.float64, device=device) / ny
    s = torch.zeros((ny, nx), dtype=torch.float64, device=device)
    for m, (kx, ky) in enumerate(mix["initial"]["modes"]):
        s += w[m] * torch.cos(2 * math.pi * (kx * x[None, :] + ky * y[:, None])
                              + ph[m])
    return s / w.sum()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Cell:
    """The port's model for one traffic mix, and one interval of it."""

    def __init__(self, mix, seed, device):
        from lb2d_tpu_torch.models import PipeFlow, PipeFlowCylinder
        from lb2d_tpu_torch.models.base import LBModel
        from lb2d_tpu_torch.utils import MachWatchdog

        own = mix["initial"]["kind"] == "program"
        kw = dict(mix["physical"], time_prefactor=1.0, dtype=torch.float32,
                  backend="auto", device=device, seed=seed % 2**32,
                  init_state=own)
        if mix["model"] == "PipeFlowCylinder":
            cyl = mix["cylinder"]
            self.sim = PipeFlowCylinder(
                cylinder_center=tuple(cyl["center"]),
                cylinder_radius=cyl["radius"], **kw)
        elif mix["model"] == "PipeFlow":
            self.sim = PipeFlow(**kw)
        else:
            raise ValueError(f"pipe_flow has no model {mix['model']!r}")
        self.device = torch.device(device)
        self.inputs = inputs(mix, seed, self.device)
        if not own:
            # the model's own set-up with the benchmark's state in place of
            # its perturbation (as LBModel's subclasses do: ``state``, then
            # __init__)
            self.sim.state = self._waves_state(mix)
            LBModel.__init__(self.sim)
        self.steps_per_interval = int(mix["steps_per_interval"])
        self.ny, self.nx = self.sim.ny, self.sim.nx
        self.cells = self.sim.num_cells
        self.backend = self.sim.backend
        self.monitor_kind = mix["monitor"]
        if self.monitor_kind not in ("mach", "u_profile"):
            raise ValueError(f"unknown monitor {self.monitor_kind!r}")
        self.watchdog = MachWatchdog()
        self._pin = self.device.type == "cuda"
        self._profile = torch.empty(self.ny, pin_memory=self._pin)

    def _waves_state(self, mix) -> torch.Tensor:
        """``w_i rho`` of ``rho = ramp (1 + amplitude s)``, worked out in
        float64 on the card and rounded to the model's float32."""
        sim = self.sim
        ramp = sim.inlet_rho - torch.arange(
            sim.nx, dtype=torch.float64, device=self.device) * (
            (sim.inlet_rho - sim.outlet_rho) / float(sim.nx))
        rho = ramp[None, :] * (1.0 + mix["initial"]["amplitude"] * wave_field(
            mix, self.inputs, sim.ny, sim.nx, self.device))
        w = torch.tensor(sim.lattice.w, dtype=torch.float64,
                         device=self.device)
        return (w[:, None, None] * rho[None]).to(torch.float32).contiguous()

    def state(self) -> torch.Tensor:
        return self.sim.state

    def run(self):
        self.sim.run(self.steps_per_interval)

    def monitor(self) -> np.ndarray:
        """The monitoring readout's values on the host."""
        sim = self.sim
        if self.monitor_kind == "mach":
            return np.array([self.watchdog.check(sim.device_field("u"),
                                                 sim.device_field("v"))])
        self._profile.copy_(sim.device_field("u")[:, self.nx // 2],
                            non_blocking=True)
        _sync(self.device)
        return self._profile.numpy().copy()

    def snapshot_buffers(self) -> dict:
        return {name: torch.empty((self.ny, self.nx), dtype=torch.float32,
                                  pin_memory=self._pin)
                for name in ("rho", "u", "v")}

    def snapshot(self, out: dict):
        """``rho``, ``u`` and ``v`` into the host buffers ``out``, on the
        host when this returns."""
        for name, buf in out.items():
            buf.copy_(self.sim.device_field(name), non_blocking=True)
        _sync(self.device)

    def close(self):
        self.sim = None
