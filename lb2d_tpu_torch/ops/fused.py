"""Fused D2Q9 pipe-flow steps: the CUDA kernels and their plain versions.

Each step is stream -> Zou-He pressure BCs -> optional obstacle bounce-back
-> moments -> feq -> BGK. Three kernels compute it, each the port of a
Pallas kernel of ``lb2d_tpu.ops.fused``:

* :func:`pipe_step` (``csrc/pipe_step.cu``, K1): one step, ``f`` read once
  and written once; ports ``make_fused_pipe_step`` and
  ``make_pipelined_pipe_step``.
* :func:`temporal_pipe_step` (``csrc/temporal_step.cu``, K2): ``k_steps``
  steps per pass over ``f``; ports ``make_temporal_pipe_step``
  (``physics="flow"``). :func:`temporal_velocity_step` launches the same
  kernel with the velocity-inlet BCs (``physics="velocity_inlet"``).
* :func:`resident_pipe_run` (``csrc/resident_run.cu``, K3): ``n`` steps in
  one launch; ports ``make_resident_pipe_step`` (``physics="flow"``).

The kernels run only on CUDA tensors. On CPU tensors each wrapper runs the
plain version, :func:`pipe_step_reference` or
:func:`velocity_step_reference` (``n`` times for K2 and K3): the same step
composed from the plain ops exactly as the JAX models' ``_make_xla_step``
composes it. Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..core import D2Q9
from . import _build
from .boundary import (
    bounce_back_obstacle,
    zou_he_pressure_bcs,
    zou_he_pressure_bcs_incompressible,
    zou_he_velocity_bcs,
    zou_he_velocity_inlet_open_outlet,
)
from .collide import bgk
from .equilibrium import feq_incompressible, feq_quadratic
from .moments import hydro_compressible, hydro_incompressible
from .stream import stream

__all__ = ["pipe_step", "pipe_step_reference", "pipe_run_reference",
           "temporal_pipe_step", "resident_pipe_run", "supports_resident",
           "velocity_step_reference", "temporal_velocity_step",
           "MAX_TEMPORAL_K", "RESIDENT_MAX_CELLS"]

MAX_TEMPORAL_K = 8  # the K2 tile is 32 cells wide with a K-cell halo
# K3 keeps f and its scratch buffer (72 B/cell together) in the 50 MB L2;
# on an H100 it beats K2 up to 724^2 and loses at 1024^2
RESIDENT_MAX_CELLS = 1 << 19


def supports_resident(ny: int, nx: int) -> bool:
    """Whether the one-launch run (K3) is the fast path for this grid: both
    buffers fit in L2."""
    return ny * nx <= RESIDENT_MAX_CELLS


def pipe_step_reference(f: torch.Tensor, omega, inlet_rho, outlet_rho, *,
                        incompressible: bool,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """One pipe-flow step in plain PyTorch ops (returns a new tensor).

    With the incompressible equilibrium and an obstacle, the velocity is
    zeroed inside the mask after the moments (``opencl_dim_D2Q9i.py:494-502``).
    """
    bcs = (zou_he_pressure_bcs_incompressible if incompressible
           else zou_he_pressure_bcs)
    f = bcs(stream(f, D2Q9), inlet_rho, outlet_rho)
    if mask is not None:
        mask = mask.bool()
        f = bounce_back_obstacle(f, mask, D2Q9)
    hydro = hydro_incompressible if incompressible else hydro_compressible
    rho, u, v = hydro(f, D2Q9)
    if mask is not None and incompressible:
        u = torch.where(mask, 0.0, u)
        v = torch.where(mask, 0.0, v)
    feq = (feq_incompressible if incompressible else feq_quadratic)(
        rho, u, v, D2Q9)
    return bgk(f, feq, omega)


def pipe_run_reference(f: torch.Tensor, n: int, omega, inlet_rho, outlet_rho,
                       *, incompressible: bool,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` plain steps (the plain version of K2 and K3); returns a new
    tensor, or ``f`` itself when ``n`` is 0."""
    for _ in range(n):
        f = pipe_step_reference(f, omega, inlet_rho, outlet_rho,
                                incompressible=incompressible, mask=mask)
    return f


def velocity_step_reference(f: torch.Tensor, omega, u_w, u_e, *,
                            outlet: str, incompressible: bool,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """One velocity-inlet step in plain PyTorch ops (returns a new tensor):
    stream -> Zou-He velocity inlet ``u_w`` with the zero-gradient outlet
    (``outlet="zero_gradient"``) or the velocity outlet ``u_e``
    (``outlet="velocity"``), periodic in y -> [bounce-back] -> compressible
    moments, velocity zeroed in the obstacle (``OLD/opencl.py:346-360``) ->
    feq (incompressible if ``incompressible``) -> BGK."""
    _check_outlet(outlet)
    f = stream(f, D2Q9)
    if outlet == "zero_gradient":
        f = zou_he_velocity_inlet_open_outlet(f, u_w)
    else:
        f = zou_he_velocity_bcs(f, u_w, u_e)
    if mask is not None:
        mask = mask.bool()
        f = bounce_back_obstacle(f, mask, D2Q9)
    rho, u, v = hydro_compressible(f, D2Q9)
    if mask is not None:
        u = torch.where(mask, 0.0, u)
        v = torch.where(mask, 0.0, v)
    feq = (feq_incompressible if incompressible else feq_quadratic)(
        rho, u, v, D2Q9)
    return bgk(f, feq, omega)


def pipe_step(f_in: torch.Tensor, f_out: torch.Tensor, omega, inlet_rho,
              outlet_rho, *, incompressible: bool,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Write one step of ``f_in`` (``[9, ny, nx]`` float32) into ``f_out``
    and return ``f_out``.

    ``mask`` is an optional int32 ``[ny, nx]`` obstacle mask. On CUDA
    tensors this launches K1 on the current stream (and counts the launch
    in ``pipe_step.launches``); on CPU tensors it runs
    :func:`pipe_step_reference`.
    """
    _check(f_in, f_out, mask)
    if f_in.device.type == "cpu":
        f_out.copy_(pipe_step_reference(f_in, omega, inlet_rho, outlet_rho,
                                        incompressible=incompressible,
                                        mask=mask))
        return f_out
    _, ny, nx = f_in.shape
    _launch("lb2d_pipe_step", f_in, f_out, mask, ny, nx, float(omega),
            float(inlet_rho), float(outlet_rho), int(bool(incompressible)))
    pipe_step.launches += 1
    return f_out


pipe_step.launches = 0


def temporal_pipe_step(f_in: torch.Tensor, f_out: torch.Tensor, k_steps: int,
                       omega, inlet_rho, outlet_rho, *, incompressible: bool,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``k_steps`` steps of ``f_in`` into ``f_out`` in one pass over
    ``f`` and return ``f_out``; ``1 <= k_steps <= MAX_TEMPORAL_K``.

    On CUDA tensors this launches K2 (counted in
    ``temporal_pipe_step.launches``); on CPU tensors it runs
    :func:`pipe_run_reference`.
    """
    _check(f_in, f_out, mask)
    k_steps = _check_k(k_steps)
    if f_in.device.type == "cpu":
        f_out.copy_(pipe_run_reference(f_in, k_steps, omega, inlet_rho,
                                       outlet_rho,
                                       incompressible=incompressible,
                                       mask=mask))
        return f_out
    _, ny, nx = f_in.shape
    _launch("lb2d_temporal_step", f_in, f_out, mask, ny, nx, k_steps,
            float(omega), float(inlet_rho), float(outlet_rho),
            int(bool(incompressible)))
    temporal_pipe_step.launches += 1
    return f_out


temporal_pipe_step.launches = 0


def temporal_velocity_step(f_in: torch.Tensor, f_out: torch.Tensor,
                           k_steps: int, omega, u_w, u_e, *, outlet: str,
                           incompressible: bool,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``k_steps`` velocity-inlet steps of ``f_in`` into ``f_out`` in
    one pass over ``f`` and return ``f_out``; arguments as
    :func:`velocity_step_reference`, ``nx >= 2``.

    On CUDA tensors this launches K2 with the velocity BCs (counted in
    ``temporal_velocity_step.launches``); on CPU tensors it runs
    :func:`velocity_step_reference` ``k_steps`` times.
    """
    _check(f_in, f_out, mask)
    k_steps = _check_k(k_steps)
    _check_outlet(outlet)
    if f_in.device.type == "cpu":
        f = f_in
        for _ in range(k_steps):
            f = velocity_step_reference(f, omega, u_w, u_e, outlet=outlet,
                                        incompressible=incompressible,
                                        mask=mask)
        f_out.copy_(f)
        return f_out
    _, ny, nx = f_in.shape
    _launch("lb2d_temporal_velocity_step", f_in, f_out, mask, ny, nx, k_steps,
            float(omega), float(u_w), float(u_e), int(outlet == "velocity"),
            int(bool(incompressible)))
    temporal_velocity_step.launches += 1
    return f_out


temporal_velocity_step.launches = 0


def resident_pipe_run(f: torch.Tensor, scratch: torch.Tensor, n: int, omega,
                      inlet_rho, outlet_rho, *, incompressible: bool,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Advance ``f`` by ``n`` steps in place and return it; ``scratch`` is a
    second buffer of ``f``'s shape whose contents are overwritten.

    On CUDA tensors this is one launch of K3 for any ``n >= 1`` (counted in
    ``resident_pipe_run.launches``); on CPU tensors it runs
    :func:`pipe_run_reference`. ``n == 0`` launches nothing.
    """
    _check(f, scratch, mask)
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if f.device.type == "cpu":
        f.copy_(pipe_run_reference(f, n, omega, inlet_rho, outlet_rho,
                                   incompressible=incompressible, mask=mask))
        return f
    if n == 0:
        return f
    _, ny, nx = f.shape
    _launch("lb2d_resident_run", f, scratch, mask, ny, nx, n, float(omega),
            float(inlet_rho), float(outlet_rho), int(bool(incompressible)))
    resident_pipe_run.launches += 1
    return f


resident_pipe_run.launches = 0


def _launch(entry, a, b, mask, *args):
    """Call a C entry point on CUDA tensors ``a``, ``b`` (and the mask) on
    the current stream; raise on any CUDA error it reports."""
    if a.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu, not {a.device}")
    fn = getattr(_build.load_library(), entry)
    err = fn(a.data_ptr(), b.data_ptr(),
             None if mask is None else mask.data_ptr(), *args,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _check_k(k_steps) -> int:
    k_steps = int(k_steps)
    if not 1 <= k_steps <= MAX_TEMPORAL_K:
        raise ValueError(f"k_steps must be in 1..{MAX_TEMPORAL_K}, "
                         f"got {k_steps}")
    return k_steps


def _check_outlet(outlet):
    if outlet not in ("zero_gradient", "velocity"):
        raise ValueError(f"outlet must be 'zero_gradient' or 'velocity', "
                         f"not {outlet!r}")


def _check(f_in, f_out, mask):
    for name, t in (("f_in", f_in), ("f_out", f_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[0] != 9:
            raise ValueError(f"{name} must be [9, ny, nx], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f_out.shape != f_in.shape or f_out.device != f_in.device:
        raise ValueError("f_out must match f_in in shape and device")
    if f_out.data_ptr() == f_in.data_ptr():
        raise ValueError("f_out must be a distinct tensor (the step is out "
                         "of place)")
    if mask is not None:
        if mask.dtype != torch.int32 or tuple(mask.shape) != tuple(f_in.shape[1:]):
            raise ValueError(f"mask must be int32 {tuple(f_in.shape[1:])}, got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != f_in.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on f_in's device")
