"""LBM Poisson solver (counterpart of ``lb2d_tpu.models.poisson``).

Chai & Shi's diffusion LBM iterated to steady state (``poisson/solver.py``,
``Poisson_Solver``): the feq ``(w_0 - 1) rho`` / ``w_j rho``
(``D2Q9_poisson.cl:1-31``), density ``(9/5) sum_{j>=1} f_j`` (``:59``), a
per-step source ``w_j S dt D`` in the collision (``:65-97``), Dirichlet
density on the four walls and corners by weight-renormalised redistribution
(``:149-254``), and the convergence test ``avg|drho| / avg rho < tol`` that
stops the iteration and refreshes the central-difference negative gradient
(``solver.py:324-358``).

The iterate-check loop (JAX: one ``lax.while_loop``,
``lb2d_tpu/models/poisson.py:238-285``) runs in blocks of ``check_every``
iterations, ``check_every - 1`` unchecked and one checked
(:class:`_PoissonLoop`). On CUDA tensors a block is captured once as a CUDA
graph on the loop's own buffers and replayed; its convergence flag stays on
the device and the host reads it once per block, so a solve of ``n``
iterations costs ``ceil(n / check_every)`` host reads and one graph
replay per full block. The host counts the iterations: a last block
shorter than ``check_every`` (near the iteration budget) runs eagerly with
the iterations that are left, which is JAX's masking at ``:258-265``. On
CPU tensors every block runs eagerly.

Reproduced quirks (``DIVERGENCES.md`` #7, #8):

* the source is scaled **twice** by ``D_lb * dt``, once in
  :meth:`PoissonSolver.update_source` and once per iteration;
* :func:`negative_gradient` writes the **y**-derivative into ``u`` and the
  **x**-derivative into ``v``, with zero-padded edges;
* the gradient is refreshed only when the loop converges.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..core import D2Q9
from ..ops.equilibrium import feq_poisson
from ..ops.moments import rho_poisson
from ..ops.stream import stream
from ..utils.metrics import synchronize
from .base import graph_in_place, resolve_device, state_from_numpy, \
    state_to_numpy

__all__ = ["PoissonSolver"]

# the populations each boundary region replaces, in JAX's order
# (lb2d_tpu/models/poisson.py:58-87): north, east, south and west walls
# (corners excluded), then the corners (0, 0), (0, -1), (-1, 0), (-1, -1)
_UNKNOWN = ((4, 7, 8), (3, 6, 7), (2, 5, 6), (1, 5, 8),
            (1, 2, 5), (2, 3, 6), (1, 4, 8), (3, 4, 7))


def _region_cells(ny, nx):
    """The ``(y, x)`` cells of each region of ``_UNKNOWN``."""
    inner_x, inner_y = np.arange(1, nx - 1), np.arange(1, ny - 1)
    return (
        (np.full(nx - 2, ny - 1), inner_x), (inner_y, np.full(ny - 2, nx - 1)),
        (np.zeros(nx - 2, int), inner_x), (inner_y, np.zeros(ny - 2, int)),
        ([0], [0]), ([0], [nx - 1]), ([ny - 1], [0]), ([ny - 1], [nx - 1]))


class _BoundaryPlan:
    """The Dirichlet walls and corners of ``_poisson_bcs`` as index tensors
    over the ``2 (ny + nx) - 4`` boundary cells, made once per grid.

    A boundary cell's three unknown populations become
    ``w_j * r``, ``r = -(sum of its five known non-rest populations +
    (w_0 - 1) rho_b) / (sum of the unknown weights)``, the known ones added
    in direction order as JAX adds them. All reads precede all writes (JAX's
    snapshot ``s = f``); the regions' cells are disjoint.
    """

    def __init__(self, ny, nx, w, rho_b, device, dtype):
        if ny < 2 or nx < 2:
            raise ValueError(f"the Poisson grid needs ny, nx >= 2, got "
                             f"{ny}x{nx}")
        known, unknown, denom, w_unknown = [], [], [], []
        cells = ny * nx
        for dirs, (ys, xs) in zip(_UNKNOWN, _region_cells(ny, nx)):
            cell = (np.asarray(ys) * nx + np.asarray(xs)).astype(np.int64)
            rest = [j for j in range(1, 9) if j not in dirs]
            known.append(np.stack([j * cells + cell for j in rest]))
            unknown.append(np.stack([j * cells + cell for j in dirs]))
            # the denominator as JAX forms it: a Python sum, then float32
            denom.append(np.full(cell.size, sum(w[j] for j in dirs),
                                 np.float32))
            w_unknown.append(np.stack([np.full(cell.size, w[j], np.float32)
                                       for j in dirs]))

        def put(a, dt=dtype):
            return torch.tensor(np.concatenate(a, axis=-1), dtype=dt,
                                device=device)

        self.known = put(known, torch.int64)          # [5, nb] into f.view(-1)
        self.unknown = put(unknown, torch.int64).reshape(-1)  # [3 nb]
        self.denom = put(denom)
        self.w_unknown = put(w_unknown)               # [3, nb]
        # (w_0 - 1) rho_b, each factor rounded to float32 first, as in JAX
        self.shift = float(np.float32(w[0] - 1.0) * np.float32(rho_b))

    def apply_(self, f: torch.Tensor) -> torch.Tensor:
        """The walls and corners on ``f`` (contiguous ``[9, ny, nx]``), in
        place; returns ``f``."""
        flat = f.view(-1)
        k = flat.take(self.known)
        known = k[0] + k[1] + k[2] + k[3] + k[4]
        r = -(known + self.shift) / self.denom
        flat.index_copy_(0, self.unknown, (self.w_unknown * r).reshape(-1))
        return f


def _poisson_bcs(f, rho_b, w):
    """Dirichlet-density walls and corners (``D2Q9_poisson.cl:149-254``) on
    a copy of ``f [9, ny, nx]``: each boundary cell's three populations that
    stream in from outside become ``w_j * rho_to_add``, ``rho_to_add = -(sum
    known f + (w_0 - 1) rho_b) / (sum unknown w)``."""
    plan = _BoundaryPlan(f.shape[-2], f.shape[-1], w, rho_b, f.device,
                         f.dtype)
    return plan.apply_(f.contiguous().clone())


def negative_gradient(rho, delta_x):
    """Central-difference negative gradient with zero-padded edges; note the
    reference's axis swap: ``u`` gets the y-derivative, ``v`` the
    x-derivative (``D2Q9_poisson.cl:294-304``)."""
    yp = F.pad(rho[1:, :], (0, 0, 0, 1))
    ym = F.pad(rho[:-1, :], (0, 0, 1, 0))
    xp = F.pad(rho[:, 1:], (0, 1, 0, 0))
    xm = F.pad(rho[:, :-1], (1, 0, 0, 0))
    u = -(yp - ym) / (2.0 * delta_x)
    v = -(xp - xm) / (2.0 * delta_x)
    return u, v


class PoissonSolver:
    """API mirror of ``Poisson_Solver`` (``poisson/solver.py:56-376``).

    Args:
      nx, ny: grid size (reference arrays are (nx, ny) x-major; ours are
        ``[ny, nx]`` with identical cell indexing).
      sources: source field, ``[ny, nx]`` (or reference-layout ``[nx, ny]``
        via ``sources_xy=True``), a numpy array or a tensor.
      delta_t, delta_x: lattice scales of the *embedding* simulation; the
        solver's diffusivity is ``D_lb = dt/dx^2`` and
        ``omega = (0.5 + D_lb/cs^2)^-1`` (``solver.py:144-150``).
      rho_on_boundary: Dirichlet boundary density.
      tolerance: convergence threshold for ``avg|drho|/avg rho``.
      seed: the initial perturbation's ``np.random.RandomState`` seed.
      check_every: iterations per convergence check (a block).
      device: ``"cuda"`` (the default) or ``"cpu"``.

    ``state_numpy`` / ``load_numpy_state`` move ``(f, rho, u, v)``.
    """

    def __init__(self, nx=None, ny=None, sources=None, delta_t=None,
                 delta_x=None, rho_on_boundary=0.0, tolerance=1e-6,
                 seed=0, dtype=torch.float32, sources_xy=False,
                 check_every=10, device="cuda"):
        self.nx, self.ny = int(nx), int(ny)
        self.delta_x = float(delta_x)
        self.delta_t = float(delta_t)
        self.rho_on_boundary = float(rho_on_boundary)
        self.tolerance = float(tolerance)
        self.check_every = max(1, int(check_every))
        self.dtype = dtype
        self.device = resolve_device(device)
        self.lattice = D2Q9

        self.lb_D = self.delta_t / self.delta_x**2
        self.omega = 1.0 / (0.5 + self.lb_D / self.lattice.cs2)
        if not self.omega < 2.0:
            raise ValueError(f"omega = {self.omega} >= 2 is unstable")

        shape = (self.ny, self.nx)
        self.rho = torch.zeros(shape, dtype=dtype, device=self.device)
        self.u = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.scaled_sources = None
        self.num_iterations = 0
        self.converged = False
        self.last_mlups = self.last_solve_seconds = None

        self.update_source(sources, sources_xy=sources_xy)

        # f = perturbed feq of rho = 0 (solver.py:263-287)
        feq0 = feq_poisson(self.rho, self.lattice)
        rng = np.random.RandomState(seed)
        perturb = 1.0 + 1e-5 * rng.randn(9, self.ny, self.nx)
        self.f = feq0 * torch.tensor(perturb, dtype=dtype, device=self.device)
        self._loop = _PoissonLoop(self._consts())

    def _consts(self):
        return dict(
            w=tuple(float(x) for x in self.lattice.w), omega=self.omega,
            rho_b=self.rho_on_boundary, tol=self.tolerance,
            delta_t=self.delta_t, lb_D=self.lb_D, delta_x=self.delta_x,
            lattice=self.lattice, check_every=self.check_every,
            ny=self.ny, nx=self.nx, dtype=self.dtype, device=self.device)

    def update_source(self, new_source, sources_xy=False):
        """Rescale and install a new source; keeps the current rho as the
        warm-start guess (``solver.py:152-161``)."""
        if isinstance(new_source, torch.Tensor):
            new_source = new_source.detach().cpu().numpy()
        s = np.asarray(new_source, dtype=np.float32)
        if sources_xy:
            s = s.T
        if s.shape != (self.ny, self.nx):
            raise ValueError(f"sources must be {(self.ny, self.nx)}, got "
                             f"{s.shape}")
        self.scaled_sources = torch.tensor(s * self.lb_D * self.delta_t,
                                           dtype=self.dtype,
                                           device=self.device)
        self.num_iterations = 0

    def update_negative_gradient(self):
        self.u, self.v = negative_gradient(self.rho, self.delta_x)

    def run(self, num_iterations: int, *, timed=False):
        """Iterate until convergence or ``num_iterations``; on convergence the
        negative gradient is refreshed (``solver.py:324-358``).

        The convergence test runs every ``check_every`` iterations
        (``check_every=1`` reproduces the reference's cadence). With
        ``timed=True`` records throughput in ``last_mlups`` /
        ``last_solve_seconds``.
        """
        if timed:
            it_before = self.num_iterations
            synchronize(self.f)
            t0 = time.perf_counter()
        self.f, self.rho, self.u, self.v, it, converged = _poisson_run(
            self._consts(), self.f, self.rho, self.u, self.v,
            self.scaled_sources, self.num_iterations,
            self.num_iterations + int(num_iterations), loop=self._loop)
        self.num_iterations = it
        self.converged = converged
        if timed:
            synchronize(self.f)
            dt = time.perf_counter() - t0
            self.last_solve_seconds = dt
            self.last_mlups = (self.nx * self.ny
                               * (self.num_iterations - it_before) / dt / 1e6)
        return self

    def get_fields(self):
        feq = feq_poisson(self.rho, self.lattice)

        def host(t):
            return t.detach().cpu().numpy()

        return {
            "f": np.swapaxes(host(self.f), -1, -2),
            "feq": np.swapaxes(host(feq), -1, -2),
            "rho": host(self.rho).T,
            "u": host(self.u).T,
            "v": host(self.v).T,
        }

    def state_numpy(self):
        """``(f, rho, u, v)`` as numpy arrays."""
        return state_to_numpy((self.f, self.rho, self.u, self.v))

    def load_numpy_state(self, state) -> None:
        """Replace ``(f, rho, u, v)`` with numpy arrays of their shapes."""
        self.f, self.rho, self.u, self.v = state_from_numpy(
            state, (self.f, self.rho, self.u, self.v), self.device)


def _make_poisson_iter(c):
    """One LBM-Poisson iteration as ``(f, react) -> (f, rho)``; ``react``
    is the fully scaled per-cell source already multiplied by both
    ``D_lb * dt`` stages (the reference's double scaling). ``c`` is
    :meth:`PoissonSolver._consts`; its grid, dtype and device fix the
    boundary plan and the constants, made here, so that the iteration
    copies nothing from the host."""
    lattice = c["lattice"]
    plan = _BoundaryPlan(c["ny"], c["nx"], c["w"], c["rho_b"], c["device"],
                         c["dtype"])
    w_arr = torch.tensor(np.asarray(c["w"], np.float32), dtype=c["dtype"],
                         device=c["device"])[:, None, None]
    omega = np.float32(c["omega"])
    keep, omega = float(np.float32(1.0) - omega), float(omega)

    def lbm_iter(f, react):
        f = plan.apply_(stream(f, lattice))
        new_rho = rho_poisson(f, lattice)
        feq = feq_poisson(new_rho, lattice)
        f = f * keep + omega * feq + w_arr * react
        return f, new_rho

    return lbm_iter


class _PoissonLoop:
    """``_poisson_run``'s iterate-check loop (``poisson.py:249-279``) on
    buffers of its own: ``f``, ``rho``, ``react`` and the device flag.

    :meth:`run` copies its arguments in, runs blocks until convergence or
    ``it_max`` and returns copies of ``f`` and ``rho``. A block of
    ``check_every`` iterations on CUDA is one replay of a CUDA graph,
    captured on first use; any shorter block, and every block on the CPU,
    runs eagerly. ``reads`` counts the host's reads of the flag (one per
    block), ``replays`` the blocks run as graph replays and ``iterations``
    the iterations run.
    """

    def __init__(self, c):
        self.check_every = c["check_every"]
        self.tol = float(np.float32(c["tol"]))
        self.iterate = _make_poisson_iter(c)
        kw = dict(dtype=c["dtype"], device=c["device"])
        shape = (c["ny"], c["nx"])
        self.f = torch.zeros((c["lattice"].q,) + shape, **kw)
        self.rho = torch.zeros(shape, **kw)
        self.react = torch.zeros(shape, **kw)
        self.flag = torch.zeros((), dtype=torch.bool, device=c["device"])
        self.graph = None
        self.reads = self.replays = self.iterations = 0

    def block(self, f, rho, react, n):
        """``n`` iterations, ``n - 1`` unchecked, then one checked
        (``poisson.py:253-276``): ``(f, rho, flag)``, the flag
        ``avg|rho_before - rho| / avg rho_before < tol`` of the last two rho
        fields, as a device tensor (the ``it != 1`` rule is the caller's)."""
        for _ in range(n - 1):
            f, rho = self.iterate(f, react)
        rho_before = rho
        f, rho = self.iterate(f, react)
        n_cells = rho.numel()
        avg_diff = torch.sum(torch.abs(rho_before - rho)) / n_cells
        avg_rho = torch.sum(rho_before) / n_cells
        return f, rho, avg_diff / avg_rho < self.tol

    def run_block(self, n):
        """One block of ``n`` iterations on the loop's buffers."""
        inputs, outputs = (self.f, self.rho, self.react), (self.f, self.rho,
                                                           self.flag)
        if n == self.check_every and self.f.is_cuda:
            if self.graph is None:
                self.graph = graph_in_place(
                    lambda f, rho, react: self.block(f, rho, react, n),
                    inputs, outputs)
            self.graph.replay()
            self.replays += 1
            return
        for out, result in zip(outputs, self.block(*inputs, n)):
            out.copy_(result)

    def run(self, f, rho, react, it0, it_max):
        """``(f, rho, it, converged)`` after blocks from iteration ``it0``
        until convergence or ``it_max``."""
        self.f.copy_(f)
        self.rho.copy_(rho)
        self.react.copy_(react)
        it, converged = int(it0), False
        while it < it_max and not converged:
            n = min(self.check_every, it_max - it)
            self.run_block(n)
            it += n
            self.iterations += n
            self.reads += 1
            # the reference skips the check on the very first iteration
            # (solver.py:346-347)
            converged = bool(self.flag) and it != 1
        return self.f.clone(), self.rho.clone(), it, converged


def _poisson_run(c, f, rho, u, v, scaled_sources, it0, it_max, *, loop):
    """``(f, rho, u, v, it, converged)`` after iterating from ``it0`` until
    convergence or ``it_max`` through ``loop`` (a :class:`_PoissonLoop` of
    ``c``); ``u, v`` are refreshed only on convergence
    (``solver.py:354-358``). The inputs are not changed."""
    # second source scaling stage (D2Q9_poisson.cl:83): * delta_t * D
    react = (scaled_sources * float(np.float32(c["delta_t"]))
             * float(np.float32(c["lb_D"])))
    f, rho, it, converged = loop.run(f, rho, react, it0, it_max)
    if converged:
        u, v = negative_gradient(rho, float(np.float32(c["delta_x"])))
    return f, rho, u, v, it, converged
