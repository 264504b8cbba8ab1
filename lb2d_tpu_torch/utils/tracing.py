"""Spans on ``torch.profiler``'s clock: the port's only tracing code.

While a ``torch.profiler`` records in this thread (``utils.profiling.trace``,
or any ``torch.profiler.profile(...).start()``), :func:`span` is
``torch.profiler.record_function``: the span lands in the exported trace as
a ``user_annotation`` event, on the timeline of the kernels and copies it
caused, inside the span that contains it on the same thread. Otherwise
:func:`span` returns one shared no-op context after a single check, and the
decorators call the function they wrap after the same check: no span costs
a ``record_function`` call while nothing records. There is no setting;
spans exist exactly when a profiler records.

The names, by layer (``PERF.md``, section 3):

* ``lb2d.run``: ``LBModel.run`` and ``SimulationRunner.run``, whole;
* ``lb2d.launch.<wrapper>``: a kernel wrapper of ``ops/`` called on CUDA
  tensors, its checks, plan, argument packing and C calls (the wrappers'
  ``.launches`` counters count the launches, the spans time them);
* ``lb2d.solve``: the multicomponent runner's screened-Poisson solve (K8);
* ``lb2d.hydro``: the multicomponent runner's refresh of ``rho`` and the
  barycentric velocity after ``run``;
* ``lb2d.readout.<what>``: ``device_field(name)`` as
  ``lb2d.readout.field.<name>``, ``get_fields``, ``mach_number``,
  ``conservation_report``;
* ``lb2d.wait.<site>``: a place where the host blocks on the card (a
  synchronize, a device value read on the host, a device tensor built
  from host lists, which PyTorch copies and then synchronizes).
"""

from __future__ import annotations

import contextlib
import functools
import inspect

import torch

__all__ = ["span", "traced", "traced_field", "traced_launch", "recording"]

# whether a profiler records in this thread (about 0.1 us a call; a
# ``record_function`` costs about 13 us even with nothing recording)
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the span ``name`` while a profiler records,
    else the shared no-op context."""
    if recording():
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str):
    """Decorate a function so that each call runs inside the span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def traced_field(fn):
    """Decorate a model's ``device_field(self, name)``: each call runs
    inside the span ``lb2d.readout.field.<name>``."""
    @functools.wraps(fn)
    def call(self, name):
        if not recording():
            return fn(self, name)
        with torch.profiler.record_function(f"lb2d.readout.field.{name}"):
            return fn(self, name)
    return call


def _device_type(arg) -> str:
    if isinstance(arg, torch.Tensor):
        return arg.device.type
    if isinstance(arg, (str, torch.device)):
        return torch.device(arg).type
    return _device_type(arg.f)  # a Halo: its shard's populations


def traced_launch(fn):
    """Decorate a kernel wrapper: each call on CUDA runs inside the span
    ``lb2d.launch.<the wrapper's name>``. The device is that of the
    wrapper's ``device`` argument where it has one, else of its first
    argument (a tensor, or a ``Halo``'s populations)."""
    name = f"lb2d.launch.{fn.__name__}"
    params = list(inspect.signature(fn).parameters)
    key = "device" if "device" in params else params[0]
    index = params.index(key)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not recording():
            return fn(*args, **kwargs)
        arg = args[index] if index < len(args) else kwargs[key]
        if _device_type(arg) != "cuda":
            return fn(*args, **kwargs)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call
