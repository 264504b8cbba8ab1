"""Fused D2Q9 steps: the CUDA kernels and their plain versions.

The pipe-flow step is stream -> Zou-He pressure BCs -> optional obstacle
bounce-back -> moments -> feq -> BGK. Three kernels compute it, each the
port of a Pallas kernel of ``lb2d_tpu.ops.fused``:

* :func:`pipe_step` (``csrc/pipe_step.cu``, K1): one step, ``f`` read once
  and written once; ports ``make_fused_pipe_step`` and
  ``make_pipelined_pipe_step``.
* :func:`temporal_pipe_step` (``csrc/temporal_step.cu``, K2): ``k_steps``
  steps per pass over ``f``; ports ``make_temporal_pipe_step``
  (``physics="flow"``). :func:`temporal_velocity_step` launches the same
  kernel with the velocity-inlet BCs (``physics="velocity_inlet"``).
* :func:`resident_pipe_run` (``csrc/resident_run.cu``, K3): ``n`` steps in
  one launch; ports ``make_resident_pipe_step`` (``physics="flow"``).
  :func:`resident_velocity_run` launches it with the velocity-inlet BCs
  (``physics="velocity_inlet"``).

The periodic advection-diffusion family (``physics="diffusion"`` and
``"noisy_fisher"`` of the same two Pallas kernels) runs through K2 and K3
too: :func:`temporal_diffusion_step` and :func:`resident_diffusion_run`.
Its step is stream -> density -> linear feq -> BGK -> ``+ w G rho (1 -
rho)``, and for the noisy physics ``+ w sqrt(Dg rho (1 - rho)) eta`` and
the clip ``max(f, 0)``, where ``eta`` is the Philox normal of (seed, global
step, cell) (:mod:`lb2d_tpu_torch.ops.random`). The domain is fully
periodic and the kernels wrap exactly, so the JAX model's seam patch is not
needed: K2 and K3 equal ``k`` / ``n`` plain steps, noise included.

The kernels run only on CUDA tensors. On CPU tensors each wrapper runs the
plain version, :func:`pipe_step_reference`,
:func:`velocity_step_reference`, :func:`diffusion_step_reference` or
:func:`noisy_fisher_step_reference` (``k`` / ``n`` times for K2 and K3):
the same step composed from the plain ops exactly as the JAX models'
``_make_xla_step`` and ``_make_xla_stochastic_step`` compose it. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
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
from .equilibrium import feq_incompressible, feq_linear, feq_quadratic
from .moments import hydro_compressible, hydro_incompressible
from .random import normals_reference, philox_key
from .stream import stream

__all__ = ["pipe_step", "pipe_step_reference", "pipe_run_reference",
           "temporal_pipe_step", "resident_pipe_run", "supports_resident",
           "velocity_step_reference", "temporal_velocity_step",
           "resident_velocity_run", "diffusion_step_reference",
           "noisy_fisher_step_reference", "diffusion_run_reference",
           "temporal_diffusion_step", "resident_diffusion_run",
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


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar as a 0-d tensor of ``like``'s dtype and device, so that it
    is rounded to that dtype first, as the JAX models hold their scalars."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _weights(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(D2Q9.w, dtype=like.dtype,
                        device=like.device)[:, None, None]


def _density_in_order(f: torch.Tensor) -> torch.Tensor:
    """``sum_j f_j`` added in direction order, as the kernels add it (a
    reduction may add in another order). The noise needs the same bits:
    ``sqrt(rho (1 - rho))`` has an unbounded slope at ``rho = 1``, where
    one ulp of ``rho`` moves it by up to ~1e-5."""
    rho = f[0]
    for j in range(1, f.shape[0]):
        rho = rho + f[j]
    return rho


def diffusion_step_reference(f: torch.Tensor, omega, u_lb, v_lb,
                             lb_G=0.0) -> torch.Tensor:
    """One step of the periodic advection-diffusion family in plain PyTorch
    ops (returns a new tensor): stream -> density (in direction order) ->
    linear feq with the imposed lattice velocity ``(u_lb, v_lb)`` -> BGK ->
    ``+ w G rho (1 - rho)`` when ``lb_G`` is not 0, as JAX
    ``Diffusion._make_xla_step`` (``lb2d_tpu/models/diffusion.py:263-279``).
    """
    f = stream(f, D2Q9)
    rho = _density_in_order(f)
    feq = feq_linear(rho, _f32(u_lb, f), _f32(v_lb, f), D2Q9)
    f = bgk(f, feq, omega)
    if lb_G:
        f = f + _weights(f) * (_f32(lb_G, f) * rho * (1.0 - rho))
    return f


def noisy_fisher_step_reference(f: torch.Tensor, omega, u_lb, v_lb, lb_G,
                                lb_Dg, *, seed: int, step: int,
                                eta: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """One stochastic Fisher step in plain PyTorch ops (returns a new
    tensor), as JAX ``_make_xla_stochastic_step``
    (``lb2d_tpu/models/diffusion.py:460-480``, ``waves.py:167-187``):
    the deterministic step with growth, ``+ w sqrt(max(Dg rho (1 - rho),
    0)) eta``, then ``max(f, 0)``. The clip applies even when ``lb_Dg`` is
    0, as in the JAX kernel (``lb2d_tpu/ops/fused.py:1040``).

    ``eta`` is the ``[ny, nx]`` normal field of global step ``step``:
    :func:`~lb2d_tpu_torch.ops.random.normals_reference` of ``seed`` unless
    given (a given ``eta`` serves the parity test against JAX, which draws
    its own). With ``lb_Dg`` 0 no normal is drawn.
    """
    f = stream(f, D2Q9)
    rho = _density_in_order(f)
    feq = feq_linear(rho, _f32(u_lb, f), _f32(v_lb, f), D2Q9)
    react = _f32(lb_G, f) * rho * (1.0 - rho)
    if lb_Dg:
        if eta is None:
            eta = normals_reference(seed, step, *rho.shape, device=f.device)
        var = _f32(lb_Dg, f) * rho * (1.0 - rho)
        react = react + torch.sqrt(torch.clamp(var, min=0.0)) * eta
    f = bgk(f, feq, omega) + _weights(f) * react
    return torch.clamp(f, min=0.0)


def diffusion_run_reference(f: torch.Tensor, n: int, omega, u_lb, v_lb,
                            lb_G=0.0, lb_Dg=0.0, *, noisy: bool = False,
                            seed: int = 0, step0: int = 0) -> torch.Tensor:
    """``n`` plain steps of the diffusion family (the plain version of K2
    and K3): :func:`noisy_fisher_step_reference` at global steps ``step0``
    .. ``step0 + n - 1`` when ``noisy``, else
    :func:`diffusion_step_reference`. Returns ``f`` itself when ``n`` is 0.
    """
    for i in range(n):
        if noisy:
            f = noisy_fisher_step_reference(f, omega, u_lb, v_lb, lb_G, lb_Dg,
                                            seed=seed, step=step0 + i)
        else:
            f = diffusion_step_reference(f, omega, u_lb, v_lb, lb_G)
    return f


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
    n = _check_n(n)
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


def resident_velocity_run(f: torch.Tensor, scratch: torch.Tensor, n: int,
                          omega, u_w, u_e, *, outlet: str,
                          incompressible: bool,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Advance ``f`` by ``n`` velocity-inlet steps in place and return it;
    arguments as :func:`velocity_step_reference`, ``scratch`` as
    :func:`resident_pipe_run`, ``nx >= 2``.

    On CUDA tensors this is one launch of K3 with the velocity BCs for any
    ``n >= 1`` (counted in ``resident_velocity_run.launches``); on CPU
    tensors it runs :func:`velocity_step_reference` ``n`` times.
    """
    _check(f, scratch, mask)
    _check_outlet(outlet)
    n = _check_n(n)
    if f.device.type == "cpu":
        g = f
        for _ in range(n):
            g = velocity_step_reference(g, omega, u_w, u_e, outlet=outlet,
                                        incompressible=incompressible,
                                        mask=mask)
        f.copy_(g)
        return f
    if n == 0:
        return f
    _, ny, nx = f.shape
    _launch("lb2d_resident_velocity_run", f, scratch, mask, ny, nx, n,
            float(omega), float(u_w), float(u_e), int(outlet == "velocity"),
            int(bool(incompressible)))
    resident_velocity_run.launches += 1
    return f


resident_velocity_run.launches = 0


def temporal_diffusion_step(f_in: torch.Tensor, f_out: torch.Tensor,
                            k_steps: int, omega, u_lb, v_lb, lb_G=0.0,
                            lb_Dg=0.0, *, noisy: bool = False, seed: int = 0,
                            step0: int = 0) -> torch.Tensor:
    """Write ``k_steps`` steps of the diffusion family of ``f_in`` into
    ``f_out`` in one pass over ``f`` and return ``f_out``; ``1 <= k_steps
    <= MAX_TEMPORAL_K``. With ``noisy`` the steps are the stochastic Fisher
    steps at global steps ``step0`` .. ``step0 + k_steps - 1`` with the
    Philox key ``seed``.

    On CUDA tensors this launches K2 (counted in
    ``temporal_diffusion_step.launches``); on CPU tensors it runs
    :func:`diffusion_run_reference`.
    """
    _check(f_in, f_out, None)
    k_steps = _check_k(k_steps)
    step0 = _check_step0(step0, k_steps)
    if f_in.device.type == "cpu":
        f_out.copy_(diffusion_run_reference(
            f_in, k_steps, omega, u_lb, v_lb, lb_G, lb_Dg, noisy=noisy,
            seed=seed, step0=step0))
        return f_out
    _, ny, nx = f_in.shape
    _launch("lb2d_temporal_diffusion_step", f_in, f_out, ny, nx, k_steps,
            *_diffusion_args(omega, u_lb, v_lb, lb_G, lb_Dg, noisy, seed,
                             step0))
    temporal_diffusion_step.launches += 1
    return f_out


temporal_diffusion_step.launches = 0


def resident_diffusion_run(f: torch.Tensor, scratch: torch.Tensor, n: int,
                           omega, u_lb, v_lb, lb_G=0.0, lb_Dg=0.0, *,
                           noisy: bool = False, seed: int = 0,
                           step0: int = 0) -> torch.Tensor:
    """Advance ``f`` by ``n`` steps of the diffusion family in place and
    return it (arguments as :func:`temporal_diffusion_step`, ``scratch`` as
    :func:`resident_pipe_run`).

    On CUDA tensors this is one launch of K3 for any ``n >= 1`` (counted in
    ``resident_diffusion_run.launches``); on CPU tensors it runs
    :func:`diffusion_run_reference`. ``n == 0`` launches nothing.
    """
    _check(f, scratch, None)
    n = _check_n(n)
    step0 = _check_step0(step0, n)
    if f.device.type == "cpu":
        f.copy_(diffusion_run_reference(f, n, omega, u_lb, v_lb, lb_G, lb_Dg,
                                        noisy=noisy, seed=seed, step0=step0))
        return f
    if n == 0:
        return f
    _, ny, nx = f.shape
    _launch("lb2d_resident_diffusion_run", f, scratch, ny, nx, n,
            *_diffusion_args(omega, u_lb, v_lb, lb_G, lb_Dg, noisy, seed,
                             step0))
    resident_diffusion_run.launches += 1
    return f


resident_diffusion_run.launches = 0


def _diffusion_args(omega, u_lb, v_lb, lb_G, lb_Dg, noisy, seed, step0):
    key0, key1 = philox_key(seed)
    return (float(omega), float(u_lb), float(v_lb), float(lb_G),
            float(lb_Dg), int(bool(noisy)), key0, key1, step0)


def _launch(entry, *args):
    """Call a C entry point on the current stream: tensors (all on one CUDA
    device) go as their data pointers, ``None`` as NULL; raise on any CUDA
    error it reports."""
    device = args[0].device
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu, not {device}")
    fn = getattr(_build.load_library(), entry)
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _check_n(n) -> int:
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    return n


def _check_step0(step0, n) -> int:
    step0 = int(step0)
    if step0 < 0 or step0 + n > 1 << 64:
        raise ValueError(f"step0 must be in [0, 2^64 - n], got {step0}")
    return step0


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
