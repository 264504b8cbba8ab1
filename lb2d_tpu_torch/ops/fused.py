"""Fused D2Q9 steps: the CUDA kernels and their plain versions.

The pipe-flow step is stream -> Zou-He pressure BCs -> optional obstacle
bounce-back -> moments -> feq -> BGK. Three kernels compute it, each the
port of a Pallas kernel of ``lb2d_tpu.ops.fused``:

* :func:`pipe_step` (``csrc/pipe_step.cu``, K1): one step, ``f`` read once
  and written once; ports ``make_fused_pipe_step`` and
  ``make_pipelined_pipe_step``.
* :func:`temporal_pipe_step` (``csrc/temporal_step.cu``, K2): ``k_steps``
  steps per pass over ``f``, a row sweep down strips of the grid
  (:mod:`~lb2d_tpu_torch.ops.sweep`); ports ``make_temporal_pipe_step``
  (``physics="flow"``). :func:`temporal_velocity_step` launches the same
  sweep with the velocity-inlet BCs (``physics="velocity_inlet"``), and on
  grids of at most ``VELOCITY_TILE_MAX_CELLS`` cells the first K2's loop of
  32 x 32 tiles with a K-cell halo, which is faster there.
* :func:`resident_pipe_run` (``csrc/resident_run.cu``, K3): ``n`` steps in
  one launch, the grid held in the shared memory of persistent blocks, one
  band of rows each, which exchange halo rows with their two neighbours
  alone (:mod:`~lb2d_tpu_torch.ops.resident_plan`); ports
  ``make_resident_pipe_step`` (``physics="flow"``).
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

The multifield range expansions (``F`` fields, state ``[9, F, ny, nx]``,
plane ``j * F + p`` when flattened) run through K4 and K5
(``csrc/multifield_step.cu``):

* :func:`temporal_multifield_step` (K4): ``k_steps`` steps per pass, with
  ``physics="fisher"`` (no-flux walls on all four sides, logistic
  competition against the total density) or ``"expansion"`` (fully
  periodic; populations plus a nutrient, Milstein noise, clips), K2's row
  sweep on ``9 F`` planes; ports ``make_temporal_multifield_step``. The
  walls apply by global coordinates and the periodic wrap is exact, so K4
  equals ``k`` plain steps and the JAX models' wall and seam patches are
  not needed.
* :func:`expansion_band_step` (K5): ``k`` Expansion steps on a band of rows
  that wraps within itself, emitting its central ``2k`` rows, each block
  the cone of one strip, one cell a thread (:mod:`.band_plan`); ports
  ``make_expansion_band_step``. Its noise is keyed to global rows, so the
  band of rows ``[-B, B)`` gives K4's rows ``[-k, k)`` bit for bit.

The kernels run only on CUDA tensors. On CPU tensors each wrapper runs the
plain version, :func:`pipe_step_reference`,
:func:`velocity_step_reference`, :func:`diffusion_step_reference`,
:func:`noisy_fisher_step_reference`, :func:`fisher_step_reference`,
:func:`expansion_step_reference` (``k`` / ``n`` times for K2-K4) or
:func:`expansion_band_reference`: the same step composed from the plain ops
exactly as the JAX models' ``_make_xla_step`` and
``_make_xla_stochastic_step`` compose it. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import D2Q9
from ..utils.tracing import traced_launch
from . import _build
from .boundary import (
    GridCoords,
    bounce_back_obstacle,
    zou_he_pressure_bcs,
    zou_he_pressure_bcs_incompressible,
    zou_he_velocity_bcs,
    zou_he_velocity_inlet_open_outlet,
)
from .collide import bgk
from .equilibrium import feq_incompressible, feq_linear, feq_quadratic
from . import band_plan, resident_plan
from .random import (
    normals_reference,
    philox_key,
    population_normals_at,
    population_normals_reference,
)
from .stream import stream
from .sweep import max_k as _sweep_max_k

__all__ = ["pipe_step", "pipe_step_reference", "pipe_run_reference",
           "temporal_pipe_step", "resident_pipe_run", "supports_resident",
           "velocity_step_reference", "temporal_velocity_step",
           "resident_velocity_run", "diffusion_step_reference",
           "noisy_fisher_step_reference", "diffusion_run_reference",
           "temporal_diffusion_step", "resident_diffusion_run",
           "noflux_walls_reference", "fisher_step_reference",
           "expansion_step_reference", "multifield_run_reference",
           "expansion_band_reference", "temporal_multifield_step",
           "expansion_band_step", "multifield_max_k", "band_max_k",
           "MAX_TEMPORAL_K", "MAX_MULTIFIELD_FIELDS", "RESIDENT_MAX_CELLS",
           "VELOCITY_TILE_MAX_CELLS",
           "RESIDENT_MAX_CELLS_DIFFUSION", "resident_scratch"]

MAX_TEMPORAL_K = _sweep_max_k(1)  # K2's rings fit one block's shared memory
# K3 holds the grid in shared memory up to about 790^2 (resident_plan). On
# an H100 80GB HBM3 at 700 W, ms per 1000 steps through the models (K3 /
# K2, tools/time_tile_kernels.py k3; PERF.md): K3 wins at every size from
# 32x256 to 724^2, and at 16x4096, for flow (724^2: 14.9 / 17.1), noisy
# Fisher (12.8 / 14.6) and the velocity inlet (13.0 / 18.6); for diffusion
# up to 512^2 (4.4 / 4.9), and K2 takes 724^2 (7.0-7.6 / 6.9-7.1)
RESIDENT_MAX_CELLS = 1 << 19
RESIDENT_MAX_CELLS_DIFFUSION = 1 << 18
# K2's velocity inlet runs 32 x 32 tiles up to this many cells and the row
# sweep above. On an H100 (ms per launch, graph replay; PERF.md, section
# 6) the tiles win up to 640^2 at K = 3 (512^2 0.0325 against the sweep's
# 0.0330, 640^2 0.0385 against 0.0414) and at K = 4 tie there (0.0526,
# 0.0520); from 724^2 the sweep wins at K = 4 (0.0603 against 0.0714;
# 2048^2 0.3042 against 0.4808) and ties at K = 3 (0.0437, 0.0439)
VELOCITY_TILE_MAX_CELLS = 640 * 640
MAX_MULTIFIELD_FIELDS = 8  # K4's rings, K5's levels: 9F planes each


def supports_resident(ny: int, nx: int, physics: str = "flow") -> bool:
    """Whether the one-launch run (K3) is the fast path for this grid and
    physics (``"flow"``, ``"velocity_inlet"``, ``"diffusion"`` or
    ``"noisy_fisher"``): K3 holds it
    (:func:`~lb2d_tpu_torch.ops.resident_plan.plan` on this card) and it
    has at most ``RESIDENT_MAX_CELLS`` cells, ``RESIDENT_MAX_CELLS_DIFFUSION``
    for ``"diffusion"``, where K2 runs 8 steps a launch."""
    most = (RESIDENT_MAX_CELLS_DIFFUSION if physics == "diffusion"
            else RESIDENT_MAX_CELLS)
    return (ny * nx <= most
            and resident_plan.plan(ny, nx, sms=_sm_count(None)) is not None)


def _sm_count(device) -> int:
    """The SMs of ``device`` (the current CUDA device for None), or the
    H100's where there is no CUDA device."""
    if not torch.cuda.is_available():
        return resident_plan.H100_SMS
    return torch.cuda.get_device_properties(
        device or torch.cuda.current_device()).multi_processor_count


def resident_scratch(f: torch.Tensor) -> torch.Tensor:
    """The exchange buffer of K3's run on ``f`` (``[9, ny, nx]`` on CUDA):
    the floats of scratch its plan needs (none where every edge stays in
    one cluster). Raises where K3 cannot hold the grid."""
    return torch.empty(_resident_plan(f).exchange, dtype=torch.float32,
                       device=f.device)


def _resident_plan(f: torch.Tensor, scratch: torch.Tensor | None = None
                   ) -> resident_plan.ResidentPlan:
    """K3's plan for ``f``; raises where K3 cannot hold the grid, or where
    ``scratch`` is given and smaller than the plan's exchange."""
    _, ny, nx = f.shape
    p = resident_plan.plan(ny, nx, sms=_sm_count(f.device))
    if p is None:
        raise ValueError(f"K3 cannot hold a {ny}x{nx} grid in shared memory "
                         "(resident_plan.plan); run it with K2")
    if scratch is not None and scratch.numel() < p.exchange:
        raise ValueError(f"scratch holds {scratch.numel()} floats; K3's "
                         f"exchange on a {ny}x{nx} grid needs {p.exchange} "
                         "(resident_scratch)")
    return p


def _check_resident(f: torch.Tensor, scratch: torch.Tensor, mask):
    """``f`` and ``mask`` as :func:`_check` takes them; ``scratch`` a
    contiguous float32 tensor on ``f``'s device, not ``f``."""
    _check_state("f", f)
    _check_mask(f, mask)
    if (scratch.dtype != torch.float32 or scratch.device != f.device
            or not scratch.is_contiguous()):
        raise ValueError("scratch must be contiguous float32 on f's device")
    if scratch.numel() and scratch.data_ptr() == f.data_ptr():
        raise ValueError("scratch must be a distinct tensor")


def pipe_step_reference(f: torch.Tensor, omega, inlet_rho, outlet_rho, *,
                        incompressible: bool,
                        mask: torch.Tensor | None = None,
                        at: GridCoords | None = None) -> torch.Tensor:
    """One pipe-flow step in plain PyTorch ops (returns a new tensor).

    With the incompressible equilibrium and an obstacle, the velocity is
    zeroed inside the mask after the moments (``opencl_dim_D2Q9i.py:494-502``).
    With ``at``, ``f`` is a block of the grid and the BCs apply by its
    global coordinates (:class:`~lb2d_tpu_torch.ops.boundary.GridCoords`).
    """
    bcs = (zou_he_pressure_bcs_incompressible if incompressible
           else zou_he_pressure_bcs)
    f = bcs(stream(f, D2Q9), inlet_rho, outlet_rho, at)
    if mask is not None:
        mask = mask.bool()
        f = bounce_back_obstacle(f, mask, D2Q9)
    rho, u, v = _hydro_in_order(f, incompressible)
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
                            mask: torch.Tensor | None = None,
                            at: GridCoords | None = None) -> torch.Tensor:
    """One velocity-inlet step in plain PyTorch ops (returns a new tensor):
    stream -> Zou-He velocity inlet ``u_w`` with the zero-gradient outlet
    (``outlet="zero_gradient"``) or the velocity outlet ``u_e``
    (``outlet="velocity"``), periodic in y -> [bounce-back] -> compressible
    moments, velocity zeroed in the obstacle (``OLD/opencl.py:346-360``) ->
    feq (incompressible if ``incompressible``) -> BGK; ``at`` as
    :func:`pipe_step_reference`."""
    _check_outlet(outlet)
    f = stream(f, D2Q9)
    if outlet == "zero_gradient":
        f = zou_he_velocity_inlet_open_outlet(f, u_w, at)
    else:
        f = zou_he_velocity_bcs(f, u_w, u_e, at)
    if mask is not None:
        mask = mask.bool()
        f = bounce_back_obstacle(f, mask, D2Q9)
    rho, u, v = _hydro_in_order(f, False)
    if mask is not None:
        u = torch.where(mask, 0.0, u)
        v = torch.where(mask, 0.0, v)
    feq = (feq_incompressible if incompressible else feq_quadratic)(
        rho, u, v, D2Q9)
    return bgk(f, feq, omega)


def _hydro_in_order(f: torch.Tensor, incompressible: bool):
    """``(rho, u, v)`` of a D2Q9 ``f``, each sum added in direction order
    as the flow kernels add it (``csrc/pipe_cell.cuh``: ``collide``); u = j
    / rho, or u = j with ``incompressible`` (He-Luo). A reduction adds in an
    order that follows the tensor's layout, so a block cut from the grid
    would not give the grid's bits."""
    rho = _density_in_order(f)
    jx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8]
    jy = f[2] - f[4] + f[5] + f[6] - f[7] - f[8]
    if incompressible:
        return rho, jx, jy
    inv = 1.0 / rho
    return rho, jx * inv, jy * inv


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


@traced_launch
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


@traced_launch
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


@traced_launch
def temporal_velocity_step(f_in: torch.Tensor, f_out: torch.Tensor,
                           k_steps: int, omega, u_w, u_e, *, outlet: str,
                           incompressible: bool,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Write ``k_steps`` velocity-inlet steps of ``f_in`` into ``f_out`` in
    one pass over ``f`` and return ``f_out``; arguments as
    :func:`velocity_step_reference`, ``nx >= 2``.

    On CUDA tensors this launches K2 with the velocity BCs (counted in
    ``temporal_velocity_step.launches``): its 32 x 32 tiles on grids of at
    most ``VELOCITY_TILE_MAX_CELLS`` cells, its row sweep above; on CPU
    tensors it runs :func:`velocity_step_reference` ``k_steps`` times.
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
    entry = ("lb2d_temporal_velocity_tiles"
             if ny * nx <= VELOCITY_TILE_MAX_CELLS
             else "lb2d_temporal_velocity_step")
    _launch(entry, f_in, f_out, mask, ny, nx, k_steps, float(omega),
            float(u_w), float(u_e), int(outlet == "velocity"),
            int(bool(incompressible)))
    temporal_velocity_step.launches += 1
    return f_out


temporal_velocity_step.launches = 0


@traced_launch
def resident_pipe_run(f: torch.Tensor, scratch: torch.Tensor, n: int, omega,
                      inlet_rho, outlet_rho, *, incompressible: bool,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Advance ``f`` by ``n`` steps in place and return it; ``scratch`` is
    float32 on ``f``'s device, K3's exchange buffer, whose contents are
    overwritten: on CUDA at least :func:`resident_scratch`'s floats (a
    grid in one cluster needs none), unused on the CPU.

    On CUDA tensors this is one launch of K3 for any ``n >= 1`` (counted in
    ``resident_pipe_run.launches``); on CPU tensors it runs
    :func:`pipe_run_reference`. ``n == 0`` launches nothing.
    """
    _check_resident(f, scratch, mask)
    n = _check_n(n)
    if f.device.type == "cpu":
        f.copy_(pipe_run_reference(f, n, omega, inlet_rho, outlet_rho,
                                   incompressible=incompressible, mask=mask))
        return f
    if n == 0:
        return f
    p = _resident_plan(f, scratch)
    _launch("lb2d_resident_run", f, scratch, scratch.numel(), mask, p.ny,
            p.nx, n, int(p.strip), p.bands, p.cluster, float(omega),
            float(inlet_rho), float(outlet_rho), int(bool(incompressible)))
    resident_pipe_run.launches += 1
    return f


resident_pipe_run.launches = 0


@traced_launch
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
    _check_resident(f, scratch, mask)
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
    p = _resident_plan(f, scratch)
    _launch("lb2d_resident_velocity_run", f, scratch, scratch.numel(), mask,
            p.ny, p.nx, n, int(p.strip), p.bands, p.cluster, float(omega),
            float(u_w), float(u_e), int(outlet == "velocity"),
            int(bool(incompressible)))
    resident_velocity_run.launches += 1
    return f


resident_velocity_run.launches = 0


@traced_launch
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


@traced_launch
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
    _check_resident(f, scratch, None)
    n = _check_n(n)
    step0 = _check_step0(step0, n)
    if f.device.type == "cpu":
        f.copy_(diffusion_run_reference(f, n, omega, u_lb, v_lb, lb_G, lb_Dg,
                                        noisy=noisy, seed=seed, step0=step0))
        return f
    if n == 0:
        return f
    p = _resident_plan(f, scratch)
    _launch("lb2d_resident_diffusion_run", f, scratch, scratch.numel(), p.ny,
            p.nx, n, int(p.strip), p.bands, p.cluster,
            *_diffusion_args(omega, u_lb, v_lb, lb_G, lb_Dg, noisy, seed,
                             step0))
    resident_diffusion_run.launches += 1
    return f


resident_diffusion_run.launches = 0


# -- the multifield range expansions: K4 and K5 -----------------------------

_PHYSICS = ("fisher", "expansion")
# no-flux walls and corners, in the order of JAX's _mf_noflux_walls
# (lb2d_tpu/ops/fused.py:1465-1489): (walls, destination, source) per field
_WALLS = ((("n",), 7, 5), (("n",), 4, 2), (("n",), 8, 6),
          (("s",), 2, 4), (("s",), 5, 7), (("s",), 6, 8),
          (("e",), 3, 1), (("e",), 6, 8), (("e",), 7, 5),
          (("w",), 1, 3), (("w",), 5, 7), (("w",), 8, 6),
          (("ul", "bl"), 1, 3), (("ul", "ur"), 4, 2), (("ul",), 8, 6),
          (("ur", "br"), 3, 1), (("ur",), 7, 5), (("br", "bl"), 2, 4),
          (("br",), 6, 8), (("bl",), 5, 7))


def band_max_k(num_fields: int) -> int:
    """The most steps per K5 launch for ``num_fields`` fields: its cone's
    two levels in shared memory (``9 F`` planes of levels 1 and 2) fit one
    block at strips of one column, 8 steps up to F = 7 and 7 at F = 8
    (:func:`lb2d_tpu_torch.ops.band_plan.max_k`)."""
    return band_plan.max_k(num_fields)


def multifield_max_k(num_fields: int) -> int:
    """The most steps per K4 launch for ``num_fields`` fields: the rings
    of ``K`` levels fit one block's shared memory
    (:func:`lb2d_tpu_torch.ops.sweep.max_k`)."""
    return _sweep_max_k(num_fields)


def _per_field(values, like: torch.Tensor) -> torch.Tensor:
    """Per-field constants rounded to float32, as the JAX models hold them,
    as a 1-d tensor of ``like``'s dtype and device."""
    return torch.tensor(np.asarray(values, np.float32).ravel(),
                        dtype=like.dtype, device=like.device)


def noflux_walls_reference(f: torch.Tensor,
                           at: GridCoords | None = None) -> torch.Tensor:
    """No-flux walls and corners on every field of a streamed ``[9, F, ny,
    nx]`` state (returns a new tensor): full bounce-back of the three
    populations that leave through each wall, three per corner, as masked
    selects from the pre-wall values, exactly as JAX
    ``noflux_bcs_multifield`` (``D2Q9_multifield_fisher.cl:184-289``).
    With ``at``, ``f`` is a block of the grid and the walls are those of
    its global coordinates."""
    if at is None:
        ny, nx = f.shape[-2:]
        row = torch.arange(ny, device=f.device)[:, None]
        lane = torch.arange(nx, device=f.device)[None, :]
    else:
        row, lane, ny, nx = at
    row_int, lane_int = (row >= 1) & (row <= ny - 2), (lane >= 1) & (lane <= nx - 2)
    row0, row_n, lane0, lane_n = row == 0, row == ny - 1, lane == 0, lane == nx - 1
    masks = {"n": row_n & lane_int, "s": row0 & lane_int,
             "e": lane_n & row_int, "w": lane0 & row_int,
             "ul": row_n & lane0, "ur": row_n & lane_n,
             "br": row0 & lane_n, "bl": row0 & lane0}
    pre = [f[j] for j in range(9)]
    st = list(pre)
    for walls, dst, src in _WALLS:
        mask = masks[walls[0]]
        for wall in walls[1:]:
            mask = mask | masks[wall]
        st[dst] = torch.where(mask, pre[src], st[dst])
    return torch.stack(st)


def fisher_step_reference(f: torch.Tensor, omegas, lb_G, u_lb, v_lb,
                          at: GridCoords | None = None) -> torch.Tensor:
    """One FisherExpansion step of ``f[9, F, ny, nx]`` in plain PyTorch ops
    (returns a new tensor), exactly as JAX ``FisherExpansion._make_xla_step``
    (``lb2d_tpu/models/multifield.py:233-248``): periodic stream -> no-flux
    walls -> ``rho_p`` (summed in direction order) -> ``rho_tot`` (summed in
    field order) -> linear feq -> per-field BGK ``+ w G_p rho_p (1 -
    rho_tot)``. ``omegas`` and ``lb_G`` have one entry per field; ``at`` as
    :func:`noflux_walls_reference`."""
    f = noflux_walls_reference(stream(f, D2Q9), at)
    rho = _density_in_order(f)                     # [F, ny, nx]
    rho_tot = _density_in_order(rho)               # [ny, nx]
    feq = feq_linear(rho, _f32(u_lb, f), _f32(v_lb, f), D2Q9)
    omega = _per_field(omegas, f)[None, :, None, None]
    growth = _per_field(lb_G, f)[:, None, None] * rho * (1.0 - rho_tot)
    return f * (1.0 - omega) + omega * feq + _weights(f)[:, None] * growth


def expansion_step_reference(f: torch.Tensor, omegas, omega_nutrient, lb_G,
                             lb_Dg, cutoff, u_lb, v_lb, *, seed: int,
                             step: int, eta: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """One Expansion step of ``f[9, P + 1, ny, nx]`` (the nutrient last) in
    plain PyTorch ops (returns a new tensor), exactly as JAX
    ``Expansion._make_xla_stochastic_step``
    (``lb2d_tpu/models/multifield.py:421-465``): periodic stream -> ``rho``
    per field in direction order, zeroed below ``cutoff`` or NaN -> linear
    feq -> growth ``G_p rho_p c`` plus, where ``Dg_p`` is not 0, the
    Milstein noise ``sqrt(max(Dg_p rho_p c, 0)) eta_p + (Dg_p c / 4)
    (eta_p^2 - 1)`` -> nutrient consumption ``-sum_p react_p`` -> BGK per
    field with ``omegas`` (one per population) and ``omega_nutrient`` ->
    zero where ``rho`` is below ``cutoff``, the result negative or NaN.

    ``eta`` is the ``[P, ny, nx]`` normal field of global step ``step``:
    :func:`~lb2d_tpu_torch.ops.random.population_normals_reference` of
    ``seed`` unless given (a given ``eta`` serves the parity test against
    JAX, which draws its own). A population with ``Dg_p = 0`` draws
    nothing; JAX draws for it and multiplies by 0, which gives the same
    result up to the sign of a zero that the growth's add removes.
    """
    f = stream(f, D2Q9)
    P = f.shape[1] - 1
    cut = _f32(cutoff, f)
    rho = _density_in_order(f)
    rho = torch.where((rho < cut) | torch.isnan(rho), 0.0, rho)
    feq = feq_linear(rho, _f32(u_lb, f), _f32(v_lb, f), D2Q9)
    c = rho[P]
    G, Dg = _per_field(lb_G, f), _per_field(lb_Dg, f)
    noisy = np.asarray(lb_Dg, np.float32).ravel() != 0
    if noisy.any() and eta is None:
        eta = population_normals_reference(seed, step, P, *c.shape,
                                           device=f.device)
    reacts = []
    for p in range(P):
        react = G[p] * rho[p] * c
        if noisy[p]:
            amp = torch.sqrt(torch.clamp(Dg[p] * rho[p] * c, min=0.0))
            react = react + (amp * eta[p]
                             + (Dg[p] * c / 4.0) * (eta[p] * eta[p] - 1.0))
        reacts.append(react)
    react_p = torch.stack(reacts)
    react_n = -_density_in_order(react_p)
    w = _weights(f)
    omega_p = _per_field(omegas, f)[None, :, None, None]
    new_p = (f[:, :P] * (1.0 - omega_p) + omega_p * feq[:, :P]
             + w[:, None] * react_p)
    new_p = torch.where((rho[:P] < cut) | (new_p < 0) | torch.isnan(new_p),
                        0.0, new_p)
    om_n = _f32(np.float32(omega_nutrient), f)
    new_n = f[:, P] * (1.0 - om_n) + om_n * feq[:, P] + w * react_n
    new_n = torch.where((c < cut) | (new_n < 0) | torch.isnan(new_n), 0.0,
                        new_n)
    return torch.cat([new_p, new_n[:, None]], dim=1)


def multifield_run_reference(f: torch.Tensor, n: int, omegas, lb_G, u_lb,
                             v_lb, *, physics: str = "fisher",
                             omega_nutrient=None, lb_Dg=None, cutoff=0.01,
                             seed: int = 0, step0: int = 0) -> torch.Tensor:
    """``n`` plain multifield steps (the plain version of K4):
    :func:`fisher_step_reference`, or :func:`expansion_step_reference` at
    global steps ``step0`` .. ``step0 + n - 1``. Returns ``f`` itself when
    ``n`` is 0."""
    _check_physics(physics)
    for i in range(n):
        if physics == "fisher":
            f = fisher_step_reference(f, omegas, lb_G, u_lb, v_lb)
        else:
            f = expansion_step_reference(f, omegas, omega_nutrient, lb_G,
                                         lb_Dg, cutoff, u_lb, v_lb,
                                         seed=seed, step=step0 + i)
    return f


def expansion_band_reference(band: torch.Tensor, k_steps: int, omegas,
                             omega_nutrient, lb_G, lb_Dg, cutoff, u_lb, v_lb,
                             *, seed: int = 0, step0: int = 0, row0: int = 0,
                             ny: int) -> torch.Tensor:
    """``k_steps`` plain Expansion steps on a ``[9, F, R, nx]`` band whose
    rows wrap within the band (the plain version of K5); returns the
    central ``[9, F, 2 k, nx]`` rows, as JAX ``make_expansion_band_step``
    (``lb2d_tpu/ops/fused.py:1784-1911``) emits them. Band row ``r`` draws
    the noise of global row ``(row0 + r) mod ny`` of an ``ny``-row grid, so
    a band of rows ``[-B, B)`` (``row0 = ny - B``) gives rows ``[-k, k)`` of
    ``k`` steps on the whole grid."""
    R, nx = band.shape[2:]
    _check_band_rows(R, k_steps)
    rows = (int(row0) + torch.arange(R, device=band.device)) % int(ny)
    cells = (rows[:, None] * nx
             + torch.arange(nx, device=band.device)[None, :]).reshape(-1)
    P = band.shape[1] - 1
    noisy = bool(np.any(np.asarray(lb_Dg, np.float32)))
    for i in range(k_steps):
        eta = (population_normals_at(seed, step0 + i, P, cells).reshape(
            P, R, nx) if noisy else None)
        band = expansion_step_reference(band, omegas, omega_nutrient, lb_G,
                                        lb_Dg, cutoff, u_lb, v_lb, seed=seed,
                                        step=step0 + i, eta=eta)
    o0 = (R - 2 * k_steps) // 2
    return band[:, :, o0:o0 + 2 * k_steps]


@traced_launch
def temporal_multifield_step(f_in: torch.Tensor, f_out: torch.Tensor,
                             k_steps: int, omegas, lb_G, u_lb, v_lb, *,
                             physics: str = "fisher", omega_nutrient=None,
                             lb_Dg=None, cutoff=0.01, seed: int = 0,
                             step0: int = 0) -> torch.Tensor:
    """Write ``k_steps`` multifield steps of ``f_in`` (``[9, F, ny, nx]``
    float32) into ``f_out`` in one pass over ``f`` and return ``f_out``;
    arguments as :func:`multifield_run_reference`, ``1 <= k_steps <=
    multifield_max_k(F)``.

    On CUDA tensors this launches K4 (counted in
    ``temporal_multifield_step.launches``), for ``F <=
    MAX_MULTIFIELD_FIELDS``; on CPU tensors it runs
    :func:`multifield_run_reference`.
    """
    F = _check_multifield(f_in, f_out)
    k_steps = _check_k(k_steps, multifield_max_k(F))
    step0 = _check_step0(step0, k_steps)
    consts = _multifield_constants(F, physics, omegas, lb_G, omega_nutrient,
                                   lb_Dg)
    if f_in.device.type == "cpu":
        f_out.copy_(multifield_run_reference(
            f_in, k_steps, omegas, lb_G, u_lb, v_lb, physics=physics,
            omega_nutrient=omega_nutrient, lb_Dg=lb_Dg, cutoff=cutoff,
            seed=seed, step0=step0))
        return f_out
    _, _, ny, nx = f_in.shape
    _launch("lb2d_temporal_multifield_step", f_in, f_out, ny, nx, F, k_steps,
            int(physics == "expansion"),
            _multifield_params(*consts, cutoff, u_lb, v_lb, seed, step0))
    temporal_multifield_step.launches += 1
    return f_out


temporal_multifield_step.launches = 0


@traced_launch
def expansion_band_step(band: torch.Tensor, k_steps: int, omegas,
                        omega_nutrient, lb_G, lb_Dg, cutoff, u_lb, v_lb, *,
                        seed: int = 0, step0: int = 0, row0: int = 0,
                        ny: int) -> torch.Tensor:
    """``k_steps`` Expansion steps on the self-wrapping band ``band``
    (``[9, F, R, nx]`` float32, ``R >= 4 k_steps``, ``1 <= k_steps <=
    band_max_k(F)``); returns a new ``[9, F, 2 k_steps, nx]`` tensor of its
    central rows. Arguments as :func:`expansion_band_reference`.

    On CUDA tensors this launches K5 (counted in
    ``expansion_band_step.launches``); on CPU tensors it runs
    :func:`expansion_band_reference`.
    """
    F = _check_multifield(band, None)
    k_steps = _check_k(k_steps, band_max_k(F))
    step0 = _check_step0(step0, k_steps)
    R, nx = band.shape[2:]
    _check_band_rows(R, k_steps)
    ny = int(ny)
    if ny < 1:
        raise ValueError(f"ny must be >= 1, got {ny}")
    consts = _multifield_constants(F, "expansion", omegas, lb_G,
                                   omega_nutrient, lb_Dg)
    kw = dict(seed=seed, step0=step0, row0=int(row0) % ny, ny=ny)
    if band.device.type == "cpu":
        return expansion_band_reference(band, k_steps, omegas, omega_nutrient,
                                        lb_G, lb_Dg, cutoff, u_lb, v_lb,
                                        **kw).clone()
    out = torch.empty((9, F, 2 * k_steps, nx), dtype=band.dtype,
                      device=band.device)
    _launch("lb2d_expansion_band_step", band, out, R, nx, F, k_steps,
            kw["row0"], ny,
            _multifield_params(*consts, cutoff, u_lb, v_lb, seed, step0))
    expansion_band_step.launches += 1
    return out


expansion_band_step.launches = 0


def _check_physics(physics):
    if physics not in _PHYSICS:
        raise ValueError(f"physics must be 'fisher' or 'expansion', not "
                         f"{physics!r}")


def _check_band_rows(R, k_steps):
    if R < 4 * k_steps:
        raise ValueError(f"a band of {R} rows is too short for {k_steps} "
                         f"steps: the band's own wrap reaches the emitted "
                         f"rows unless R >= 4 k_steps")


def _multifield_constants(F, physics, omegas, lb_G, omega_nutrient, lb_Dg):
    """Check that there is one omega and one G (and Dg) per field (Fisher)
    or per population (Expansion, which also needs ``omega_nutrient``);
    return them as float32 arrays ``(omega per field, G, Dg)``."""
    _check_physics(physics)
    P = F if physics == "fisher" else F - 1
    omegas = np.asarray(omegas, np.float32).ravel()
    lb_G = np.asarray(lb_G, np.float32).ravel()
    lb_Dg = np.zeros(P, np.float32) if lb_Dg is None else np.asarray(
        lb_Dg, np.float32).ravel()
    if P < 1 or not len(omegas) == len(lb_G) == len(lb_Dg) == P:
        raise ValueError(f"{physics} on {F} fields needs {max(P, 1)} "
                         f"population(s) and one omega, G (and Dg) each; "
                         f"got {len(omegas)}, {len(lb_G)}, {len(lb_Dg)}")
    if physics == "expansion":
        if omega_nutrient is None:
            raise ValueError("expansion needs omega_nutrient")
        omegas = np.append(omegas, np.float32(omega_nutrient))
    return omegas, lb_G, lb_Dg


def _multifield_params(omegas, lb_G, lb_Dg, cutoff, u_lb, v_lb, seed,
                       step0):
    """The constants of one K4/K5 launch as the kernels' by-value struct
    (at most ``MAX_MULTIFIELD_FIELDS`` fields, checked before)."""
    prm = _build.MultifieldParams()
    prm.omega[:len(omegas)] = omegas.tolist()
    prm.g[:len(lb_G)] = lb_G.tolist()
    prm.dg[:len(lb_Dg)] = lb_Dg.tolist()
    prm.cutoff, prm.u, prm.v = float(cutoff), float(u_lb), float(v_lb)
    prm.k0, prm.k1 = philox_key(seed)
    prm.step0 = step0
    return prm


def _check_multifield(f_in, f_out):
    """Check a ``[9, F, ny, nx]`` float32 state (and, unless None, its
    distinct output of the same shape); return F."""
    for name, t in (("f_in", f_in), ("f_out", f_out)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or t.shape[0] != 9:
            raise ValueError(f"{name} must be [9, F, ny, nx], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f_out is not None:
        if f_out.shape != f_in.shape or f_out.device != f_in.device:
            raise ValueError("f_out must match f_in in shape and device")
        if f_out.data_ptr() == f_in.data_ptr():
            raise ValueError("f_out must be a distinct tensor (the step is "
                             "out of place)")
    F = f_in.shape[1]
    if f_in.device.type == "cuda" and not 1 <= F <= MAX_MULTIFIELD_FIELDS:
        raise ValueError(f"the multifield kernels take 1..."
                         f"{MAX_MULTIFIELD_FIELDS} fields, not {F}")
    return F


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


def _check_k(k_steps, max_k=MAX_TEMPORAL_K) -> int:
    k_steps = int(k_steps)
    if not 1 <= k_steps <= max_k:
        raise ValueError(f"k_steps must be in 1..{max_k}, got {k_steps}")
    return k_steps


def _check_outlet(outlet):
    if outlet not in ("zero_gradient", "velocity"):
        raise ValueError(f"outlet must be 'zero_gradient' or 'velocity', "
                         f"not {outlet!r}")


def _check(f_in, f_out, mask):
    for name, t in (("f_in", f_in), ("f_out", f_out)):
        _check_state(name, t)
    if f_out.shape != f_in.shape or f_out.device != f_in.device:
        raise ValueError("f_out must match f_in in shape and device")
    if f_out.data_ptr() == f_in.data_ptr():
        raise ValueError("f_out must be a distinct tensor (the step is out "
                         "of place)")
    _check_mask(f_in, mask)


def _check_state(name, t):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[0] != 9:
        raise ValueError(f"{name} must be [9, ny, nx], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mask(f, mask):
    if mask is not None:
        if mask.dtype != torch.int32 or tuple(mask.shape) != tuple(f.shape[1:]):
            raise ValueError(f"mask must be int32 {tuple(f.shape[1:])}, got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != f.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on f_in's device")
