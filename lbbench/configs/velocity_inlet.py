"""``velocity_inlet``: the reference's lattice-units velocity-inlet channel
through the port, ``PipeFlowVelocityInlet`` (``OLD/python.py:318``,
``Pipe_Flow_PeriodicBC_VelocityInlet``; kernels ``OLD/opencl.py:281-375``,
``D2Q9.cl:263-374``) at its notebook defaults, lx = ly = 400 (401 x 401
nodes), u_w = 0.1 and omega = 0.99, with a cylinder in the channel as in
the reference's obstacle movies (``docs/cs205_movie.ipynb``) and
``examples_torch/karman_street.py``. Zou-He velocity inlet on the west
column, zero-gradient outlet, periodic in y (DIVERGENCES.md #20-21),
bounce-back in the disk, float32, ``backend="auto"``: on CUDA K2's
velocity inlet, its 32 x 32 tiles up to 640^2, K = 4 steps a launch.

One interval is what a user of the reference's velocity-inlet notebooks
does in a loop: ``run(M)``, then the Mach readout (``MachWatchdog.check``
on ``device_field("u")`` and ``device_field("v")``); every
``snapshot_every``-th interval a snapshot of ``rho``, ``u`` and ``v`` into
pinned host buffers. The readouts, snapshots and ``close`` are
``configs/pipe_flow.py``'s. The port is imported only when a cell is
built.

The initial state is the plug flow ``feq(rho, u_w, 0)`` with ``rho = 1 +
amplitude s(x, y)``, ``s`` the standing waves of ``pipe_flow.wave_field``
with weights and phases drawn on the card from the seed (the program's own
start is the exact plug flow, the same for every seed).
"""

import numpy as np
import torch

from lbbench.configs import pipe_flow

SOURCE = ("https://github.com/latticeboltzmann/2d-lb/blob/master/OLD/"
          "python.py")
# what the benchmark sets that the source leaves open
ASSUMED = {
    "dtype": "float32",
    "backend": "auto",
    "equilibrium": "compressible",
    "outlet": "zero_gradient (DIVERGENCES.md #21: the source's velocity "
              "outlet is linearly unstable)",
    "obstacle": "the nodes with (x - cx)^2 + (y - cy)^2 <= (d / 2)^2 on the "
                "(ly + 1) x (lx + 1) grid, the mix's obstacle.center [cx, cy] "
                "and diameter d: (80, 192) and 40 at 401^2, "
                "examples_torch/karman_street.py's placement (x = lx // 5, "
                "y = ly // 2 - 8); Re = u_w d / nu_lb = 23.5 at omega = 0.99, "
                "a steady wake",
    "initial_state": "the plug flow feq(rho, u_w, 0), rho = 1 + amplitude "
                     "s(x, y), s pipe_flow.wave_field's standing waves, "
                     "weights U(0.5, 1) and phases U(0, 2 pi) from "
                     "torch.Generator(device).manual_seed(seed); worked out "
                     "in float64 and rounded to float32",
    "perturbation_amplitude": "the mix's initial.amplitude (0.001)",
}


def work(mix) -> dict:
    """The work of the velocity inlet's steps: the k2v family, whichever
    K2 kernel runs them (an obstacle flag read an interval)."""
    from lbbench.kernels import _counts
    return {"k2v": _counts.flow_work(True)}


# the standing waves' weights and phases, drawn on the device from the seed
inputs = pipe_flow.inputs


def obstacle_mask(mix) -> np.ndarray:
    """The disk of the mix's ``obstacle``, bool ``[ly + 1, lx + 1]``."""
    lat, obs = mix["lattice"], mix["obstacle"]
    yy, xx = np.mgrid[0:lat["ly"] + 1, 0:lat["lx"] + 1]
    cx, cy = obs["center"]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= (obs["diameter"] / 2) ** 2


class Cell(pipe_flow.Cell):
    """The port's ``PipeFlowVelocityInlet`` for one traffic mix, and one
    interval of it."""

    def __init__(self, mix, seed, device):
        from lb2d_tpu_torch.models import PipeFlowVelocityInlet
        from lb2d_tpu_torch.models.base import LBModel
        from lb2d_tpu_torch.utils import MachWatchdog

        lat = mix["lattice"]
        self.mix = mix
        self.device = torch.device(device)
        self.sim = PipeFlowVelocityInlet(
            u_w=lat["u_w"], omega=lat["omega"], lx=lat["lx"], ly=lat["ly"],
            outlet=lat["outlet"], obstacle_mask=obstacle_mask(mix),
            dtype=torch.float32, backend="auto", device=self.device)
        self.inputs = inputs(mix, seed, self.device)
        # the model's own set-up with the benchmark's state in place of its
        # plug flow (as LBModel's subclasses do: ``state``, then __init__),
        # so that the kernel step's buffers are built on it
        self.sim.state = self._plug_state(mix)
        LBModel.__init__(self.sim)
        self.steps_per_interval = int(mix["steps_per_interval"])
        self.ny, self.nx = self.sim.ny, self.sim.nx
        self.cells = self.sim.num_cells
        self.backend = self.sim.backend
        self.monitor_kind = mix["monitor"]   # "mach"
        self.watchdog = MachWatchdog()
        self._pin = self.device.type == "cuda"

    def _plug_state(self, mix) -> torch.Tensor:
        """``feq(rho, u_w, 0)`` of ``rho = 1 + amplitude s``, worked out in
        float64 on the card from the model's float32 ``u_w`` and rounded
        to the model's float32."""
        sim = self.sim
        rho = 1.0 + mix["initial"]["amplitude"] * pipe_flow.wave_field(
            mix, self.inputs, sim.ny, sim.nx, self.device)
        u = float(np.float32(sim.u_w))
        planes = []
        for w, cx in zip(sim.lattice.w, sim.lattice.cx):
            cu = cx * u
            planes.append(w * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu
                                     - 1.5 * u * u))
        return torch.stack(planes).to(torch.float32).contiguous()
