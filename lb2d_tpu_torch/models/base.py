"""Base machinery shared by the port's models (counterpart of
``lb2d_tpu.models.base``).

A model owns its populations ``state`` (``[Q, ny, nx]`` on its device,
``[Q, F, ny, nx]`` for the multifield models, or a tuple of tensors) and a
``step(f) -> f`` function from :meth:`make_step`. ``run(n)`` advances ``n``
steps through it (or through the run hooks that ``make_step`` sets); on
CUDA each call enqueues kernels on PyTorch's current stream and the host
never waits inside the loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.tracing import span, traced

__all__ = ["LBModel", "resolve_device", "plain_backend", "advance",
           "held_solve_sweep", "graph_in_place", "state_to_numpy",
           "state_from_numpy"]


def plain_backend(backend: str) -> str:
    """``backend`` with JAX's name of the plain path, ``"xla"``, read as the
    port's ``"eager"``."""
    return "eager" if backend == "xla" else backend


def resolve_device(device) -> torch.device:
    """The model's device; a CUDA device on a machine without CUDA raises
    (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the eager path on the CPU")
    return device


def advance(f, n: int, K: int, sweep, single):
    """``n`` steps of ``f``: ``n // K`` calls of ``sweep`` (K steps each),
    then the rest through ``single`` (JAX's ``run``,
    ``lb2d_tpu/models/base.py:77-93``)."""
    calls, rest = divmod(int(n), K)
    for _ in range(calls):
        f = sweep(f)
    for _ in range(rest):
        f = single(f)
    return f


def held_solve_sweep(f, n: int, step, density, solve=None,
                     density_every_step: bool = False):
    """``n`` steps of ``f`` that share one solve, the stale-solve policy of
    the coupled models' ``stale_velocity`` and the multicomponent runner's
    ``stale_force``: at the first step ``rho = density(f)`` (the post-stream
    densities) and ``solve(rho)``, which writes the held planes in place;
    then each step ``f = step(f, rho)``. ``density`` runs again before each
    later step when ``density_every_step`` (a stencil reads the neighbours'
    densities). Without a ``solve`` the density runs only then. One step
    (``n == 1``) is exact."""
    rho = None
    for k in range(n):
        first = k == 0 and solve is not None
        if first or density_every_step:
            rho = density(f)
        if first:
            solve(rho)
        f = step(f, rho)
    return f


def graph_in_place(fn, inputs, outputs) -> torch.cuda.CUDAGraph:
    """``results = fn(*inputs)`` followed by ``outputs[i].copy_(results[i])``,
    captured once as a CUDA graph: each ``graph.replay()`` reruns it on the
    same buffers (``inputs`` and ``outputs`` are the graph's static tensors,
    on one CUDA device; a result must not alias another output buffer).

    ``fn`` runs once before the capture, on a side stream and on copies of
    the inputs (so no buffer changes), to make what its ops create on first
    use (the cached lattice columns, for instance). It must not read device
    values on the host or copy from the host. A capture that fails raises;
    nothing falls back to running ``fn`` eagerly.
    """
    device = inputs[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*(t.clone() for t in inputs))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for out, result in zip(outputs, fn(*inputs)):
            out.copy_(result)
    return graph


def state_to_numpy(state):
    """A state (a tensor or a tuple of tensors) as numpy arrays of the same
    structure."""
    if isinstance(state, tuple):
        return tuple(state_to_numpy(s) for s in state)
    with span("lb2d.wait.state_to_numpy"):
        return state.detach().cpu().numpy().copy()


def state_from_numpy(arrays, like, device):
    """numpy ``arrays`` as tensors of the structure, shapes and dtypes of the
    state ``like`` on ``device``; raises on a mismatch."""
    if isinstance(like, tuple):
        if not isinstance(arrays, (tuple, list)) or len(arrays) != len(like):
            raise ValueError(f"state must be a sequence of {len(like)} "
                             "arrays")
        return tuple(state_from_numpy(a, t, device)
                     for a, t in zip(arrays, like))
    a = np.ascontiguousarray(arrays)
    if a.shape != tuple(like.shape):
        raise ValueError(f"state must be {tuple(like.shape)}, got {a.shape}")
    return torch.tensor(a, dtype=like.dtype, device=device)


class LBModel:
    """Owns ``state`` and the step function.

    Subclasses set ``self.state`` and ``self.device``, implement
    :meth:`make_step` and ``num_cells``, then call ``LBModel.__init__``.
    ``make_step`` may set two run hooks:

    * ``steps_per_call`` > 1 with ``_single_step``: the step advances that
      many steps and ``_single_step`` runs the rest of ``run(n)`` as exact
      single steps (the stale-solve models of ``waves.py``, whose shorter
      sweep would hold a solve for other steps);
    * ``_run_n(f, n) -> f``: the whole ``run(n)`` in one call.

    ``steps_taken`` counts the steps run so far; during ``run`` it is the
    global index of the run's first step, which the stochastic models'
    ``_run_n`` uses as the noise's step counter.
    """

    steps_per_call = 1
    _single_step = None
    _run_n = None

    def __init__(self):
        self._step = self.make_step()
        self.steps_taken = 0
        self.last_mlups = None

    def make_step(self):
        raise NotImplementedError

    @property
    def num_cells(self) -> int:
        raise NotImplementedError

    @traced("lb2d.wait.synchronize")
    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def block_until_ready(self):
        """Wait until the device has run everything enqueued so far (nothing
        to wait for on the CPU); returns the model."""
        self._synchronize()
        return self

    def device_field(self, name):
        """One 2-D field as a device tensor, without a copy to the host;
        None for a name the model does not have (the models with fields
        override this)."""
        return None

    @traced("lb2d.run")
    def run(self, num_iterations: int, *, timed: bool = False):
        """Advance ``num_iterations`` steps on the model's device.

        With ``timed=True`` the device is synchronised before and after, and
        ``last_mlups`` records million lattice-site updates per second.
        Kernels are built when the model is constructed, never in here.
        """
        if timed:
            self._synchronize()
            t0 = time.perf_counter()
        f = self.state
        if self._run_n is not None:
            f = self._run_n(f, num_iterations)
        else:
            f = advance(f, num_iterations, self.steps_per_call, self._step,
                        self._single_step)
        self.state = f
        if timed:
            self._synchronize()
            dt = time.perf_counter() - t0
            self.last_mlups = self.num_cells * num_iterations / dt / 1e6
        self.steps_taken += num_iterations
        return self

    # -- state carried across packages ------------------------------------------
    def state_numpy(self):
        """The state as a numpy array of its shape and dtype, or a tuple of
        them for a tuple state (in JAX: ``np.asarray(sim.state)``, or that of
        each member)."""
        return state_to_numpy(self.state)

    def load_numpy_state(self, f) -> None:
        """Replace the state with a numpy array of its shape (a sequence of
        arrays for a tuple state), for example the state of the JAX model
        built from the same arguments."""
        self.state = state_from_numpy(f, self.state, self.device)

    @staticmethod
    @traced("lb2d.wait.to_host_xy")
    def _to_host_xy(t: torch.Tensor) -> np.ndarray:
        """Device ``[..., ny, nx]`` -> host ``[..., nx, ny]``, the reference's
        (x, y)-indexed layout (``opencl_dim.py:390-415``)."""
        return np.swapaxes(t.detach().cpu().numpy(), -1, -2)
