"""K steps of the coupled two-field families: K7 and its plain versions
(counterpart of ``lb2d_tpu.ops.fused_coupled``).

The families: rocket yeast (population + surfactant; the velocity is the
surfactant's one-belt gradient, plus a Shan-Chen pseudo-force; or, forces
only, a surface-tension and a pressure force field), the screened Fisher
wave (one field advected by its screened-Poisson velocity) and the
surfactant-nutrient waves (population + nutrient on the screened-Poisson
velocity of the population, growth ``G rho n``; clumpy: plus the
pseudo-force). The state is ``f[9, F, ny, nx]``, K4's and K6's layout.

* The plain steps, each exactly the JAX model's XLA step and each its
  model's eager step: :func:`rocket_yeast_step_reference` (both variants),
  :func:`screened_fisher_step_reference` and
  :func:`surfactant_step_reference` (plain and clumpy). The last two take
  the velocity as ``velocity(rho) -> (u, v)`` (solved from this step's
  post-stream density) or as held planes ``ext = [u, v]``. Their stencils
  are the port's copies of the JAX models': :func:`stencil_gradient`,
  :func:`psi_shan_chen`, :func:`psi_sticky_repulsive`, :func:`pseudo_force`.
* :func:`coupled_sweep` (``csrc/coupled_step.cu``, K7): ``k`` steps in one
  launch, a row sweep (K4's, ``csrc/row_sweep.cuh``) that computes each
  level's post-stream densities inside, the velocity planes held for the
  ``k`` steps; at most :func:`coupled_max_k` steps (shared memory; the
  geometry is mirrored in :mod:`~lb2d_tpu_torch.ops.sweep`, and
  :mod:`~lb2d_tpu_torch.ops.coupled_sweep` emulates the schedule on the
  CPU). Ports ``make_rocket_yeast_step``, ``make_screened_fisher_step``
  and ``make_surfactant_step`` (``fused_coupled.py:105, 202, 251``), which
  JAX also runs as K-step sweeps. The models run ``COUPLED_TEMPORAL_K``
  steps per launch. :func:`coupled_density` (K6's density pass on F
  periodic fields) gives the spectral solve its source.
* :func:`coupled_sweep_halo` (K7h): the same on one shard and its halos of
  ``k`` times the step's reach (:func:`coupled_reach`), the velocity
  planes read from whole-grid planes at global coordinates; with
  :func:`coupled_density_halo` for the solve.
* :func:`_coupled_cell_step` and :func:`_coupled_cell_step_halo`: K7's
  and K7h's one-step kernel, one thread a cell, which reads the densities
  that the solve's density pass has just written: the screened families'
  exact (``stale_velocity=1``) step, where it is faster than a sweep of
  one step. Their launches count with the sweep's.

The kernels run only on CUDA tensors; on CPU tensors each wrapper runs its
plain twin (:func:`coupled_sweep_reference`,
:func:`coupled_sweep_halo_reference`: ``k`` plain steps). Each counts its
launches (``coupled_sweep.launches``, ``coupled_sweep_halo.launches``).
:func:`coupled_params` packs a configuration's constants once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import D2Q9
from ..utils.tracing import traced_launch
from . import _build, sweep
from .fused import _check_k, _launch
from .fused_halo import Halo, check_pieces, cut_region
from .fused_mc import (
    FluidParams,
    MCKernelConfig,
    _check_grid_planes,
    _check_plane_stack,
    _sum_in_order,
    mc_density,
    mc_density_halo,
    mc_density_halo_reference,
)
from .stream import stream

__all__ = ["COUPLED_PHYSICS", "COUPLED_TEMPORAL_K", "CoupledConfig",
           "stencil_gradient", "psi_shan_chen", "psi_sticky_repulsive",
           "pseudo_force", "rocket_yeast_velocity", "coupled_feq",
           "rocket_yeast_step_reference",
           "screened_fisher_step_reference", "surfactant_step_reference",
           "density_in_order", "coupled_step_reference",
           "coupled_sweep_reference",
           "coupled_sweep_halo_reference", "coupled_reach", "coupled_max_k",
           "coupled_density", "coupled_density_halo",
           "coupled_density_halo_reference", "coupled_sweep",
           "coupled_sweep_halo", "coupled_params"]

# Lb2dCoupledParams.physics (csrc/coupled_cell.cuh)
COUPLED_PHYSICS = {"rocket_yeast": 0, "rocket_yeast_forces_only": 1,
                   "screened_fisher": 2, "surfactant": 3,
                   "clumpy_surfactant": 4}
_EXT_PHYSICS = ("screened_fisher", "surfactant", "clumpy_surfactant")
_NEIGHBOUR_PHYSICS = ("rocket_yeast", "rocket_yeast_forces_only",
                      "clumpy_surfactant")
# steps per K7 launch of the models: the rocket yeasts' K, and the most
# steps of one launch of the spectral families' stale_velocity sweeps (a
# deeper sweep runs several launches, the velocity held). Each is the
# fastest per step at the models' shapes on an H100 (PERF.md, section 6):
# the physics with a density stage at K = 4, where two blocks fit
# an SM (from K = 5 one does, 1.3-1.4x slower a step; JAX's first choice,
# 8, fused_coupled.py:56-84, ran 1.29x slower), the others at K = 8.
COUPLED_TEMPORAL_K = {"rocket_yeast": 4, "rocket_yeast_forces_only": 4,
                      "screened_fisher": 8, "surfactant": 8,
                      "clumpy_surfactant": 4}


@dataclass(frozen=True)
class CoupledConfig:
    """A coupled model's step: ``physics`` (a key of ``COUPLED_PHYSICS``)
    and its constants as the JAX model holds them: ``omega``, ``lb_G`` of
    the population, ``omega2`` of the second field (rocket yeast's
    ``omega_c``, the surfactant waves' ``omega_n``), ``lb_G2`` (rocket
    yeast's production ``lb_Gc``), ``epsilon``, ``rho_o``, ``G_chen``,
    ``c_o`` and ``alpha``."""
    physics: str
    omega: float
    lb_G: float
    omega2: float = 1.0
    lb_G2: float = 0.0
    epsilon: float = 0.0
    rho_o: float = 1.0
    G_chen: float = 0.0
    c_o: float = 0.25
    alpha: float = 2.0

    def __post_init__(self):
        if self.physics not in COUPLED_PHYSICS:
            raise ValueError(f"unknown physics {self.physics!r}; use one of "
                             f"{', '.join(COUPLED_PHYSICS)}")

    @property
    def fields(self) -> int:
        return 1 if self.physics == "screened_fisher" else 2

    @property
    def reads_ext(self) -> bool:
        """The velocity comes from the spectral solve, as ext planes."""
        return self.physics in _EXT_PHYSICS

    @property
    def reads_neighbours(self) -> bool:
        """The step reads the neighbours' post-stream densities (its belt is
        1)."""
        return self.physics in _NEIGHBOUR_PHYSICS

    @property
    def belt(self) -> int:
        return int(self.reads_neighbours)


# -- the plain pieces (in the JAX package: models/surfactant.py,
#    models/rocket_yeast.py) ------------------------------------------------

def _belt_terms(shifted, lattice=D2Q9):
    """``(sum_j w_j cx_j v_j, sum_j w_j cy_j v_j)`` over the moving
    directions in direction order, ``v_j = shifted(cx_j, cy_j)`` the value
    at ``x + c_j``."""
    fx = fy = None
    for j in range(1, lattice.q):
        cxj, cyj = lattice.cx[j], lattice.cy[j]
        v = shifted(cxj, cyj)
        if fx is None:
            fx, fy = torch.zeros_like(v), torch.zeros_like(v)
        fx = fx + lattice.w[j] * cxj * v
        fy = fy + lattice.w[j] * cyj * v
    return fx, fy


def _belt_sum(field, lattice):
    """:func:`_belt_terms` of ``field`` with periodic neighbours (a shift
    by ``-c`` on the array index)."""
    return _belt_terms(lambda cx, cy: torch.roll(
        torch.roll(field, -cy, dims=-2), -cx, dims=-1), lattice)


def stencil_gradient(field, lattice=D2Q9):
    """D2Q9 isotropic gradient ``(1/cs^2) sum_j w_j c_j field(x + c_j)``
    with periodic neighbours (``rocket_yeast.cl:377-397``)."""
    gx, gy = _belt_sum(field, lattice)
    return gx / lattice.cs2, gy / lattice.cs2


def psi_shan_chen(rho, rho_o):
    """``psi = rho_o (1 - exp(-rho/rho_o))`` with negative-density clamp
    (``surfactant_nutrient_waves.cl:242-260``)."""
    r = torch.clamp(rho, min=0.0)
    return rho_o * (1.0 - torch.exp(-r / rho_o))


def psi_sticky_repulsive(rho, rho_o):
    """``psi = rho - rho_o rho^2``
    (``surfactant_nutrient_waves.cl:262-281``)."""
    r = torch.clamp(rho, min=0.0)
    return r - rho_o * r * r


def pseudo_force(psi, G_chen, lattice=D2Q9, sums=None):
    """Shan-Chen pseudo-force with periodic neighbours
    (``surfactant_nutrient_waves.cl:283-364``):
    ``F = -cs^2 G_chen psi(x) sum_j w_j c_j psi(x + c_j)``; ``sums``: the
    belt sums, when they come from elsewhere (a shard's neighbours)."""
    fx, fy = _belt_sum(psi, lattice) if sums is None else sums
    pref = -lattice.cs2 * G_chen * psi
    return pref * fx, pref * fy


def _own_belt(rho):
    """``belt(g)``: the belt sums of the field ``g(rho)`` of the grid's own
    densities ``rho[F, ny, nx]``."""
    return lambda g: _belt_sum(g(rho), D2Q9)


def _surface(cfg):
    """The surface-tension field ``S = (1 - exp(-c / c_o))^alpha`` of the
    densities."""
    def field(rho):
        c = torch.clamp(rho[1], min=0.0)
        return (1.0 - torch.exp(-c / cfg.c_o)) ** cfg.alpha
    return field


def _psi_pop(cfg):
    return lambda rho: psi_shan_chen(rho[0], cfg.rho_o)


def rocket_yeast_velocity(rho, cfg: CoupledConfig, belt=None):
    """The rocket-yeast advection velocity from the densities ``rho[2, ny,
    nx]`` (population, surfactant): ``-epsilon grad(surfactant)``
    (``rocket_yeast.py:401-410``), or, forces only, the surface-tension
    force ``-epsilon grad S``, ``S = (1 - exp(-c / c_o))^alpha``, plus the
    pressure force ``-G_chen grad(rho) (rho - rho_o)``
    (``rocket_yeast_forces_only.cl:45-62, 225-316``). ``belt(g)``: the belt
    sums of a field ``g`` of the densities (default: of ``rho`` itself)."""
    belt = belt or _own_belt(rho)

    def grad(g):
        gx, gy = belt(g)
        return gx / D2Q9.cs2, gy / D2Q9.cs2

    if cfg.physics == "rocket_yeast":
        gx, gy = grad(lambda r: r[1])
        return -cfg.epsilon * gx, -cfg.epsilon * gy
    sx, sy = grad(_surface(cfg))
    sfx, sfy = -cfg.epsilon * sx, -cfg.epsilon * sy
    gx, gy = grad(lambda r: r[0])
    pfx = -cfg.G_chen * gx * (rho[0] - cfg.rho_o)
    pfy = -cfg.G_chen * gy * (rho[0] - cfg.rho_o)
    return sfx + pfx, sfy + pfy


def density_in_order(f):
    """Each field's density of ``f[9, ...]``, the directions added in
    order, as K6's density pass and K7 add them: a reduction adds in an
    order that follows the tensor's layout, so a block cut from the grid
    would not give the grid's bits."""
    return _sum_in_order([f[j] for j in range(f.shape[0])])


def _columns(like):
    """D2Q9 ``w``, ``cx``, ``cy`` as ``[9, 1, 1]`` columns of ``like``'s
    dtype and device."""
    kw = dict(dtype=like.dtype, device=like.device)
    return tuple(torch.tensor(c, **kw)[:, None, None]
                 for c in (D2Q9.w, D2Q9.cx, D2Q9.cy))


def coupled_feq(rho, u, v):
    """The linear feq of every field: ``w rho (1 + c.u / cs^2)``, ``[9, F,
    ny, nx]`` for ``rho[F, ny, nx]``."""
    w, cx, cy = (c[:, None] for c in _columns(rho))
    cu = cx * u + cy * v
    return w * rho[None] * (1.0 + cu / D2Q9.cs2)


def _f32(x, like):
    return torch.as_tensor(np.float32(x), dtype=like.dtype, device=like.device)


def _force_term(w, cx, cy, force):
    fx, fy = force
    return w * (cx * fx + cy * fy) / D2Q9.cs2


def rocket_yeast_step_reference(f, cfg: CoupledConfig):
    """One rocket-yeast step of ``f[9, 2, ny, nx]`` in plain PyTorch ops,
    as JAX ``RocketYeast._make_xla_step`` (``rocket_yeast.py:150-160``):
    stream, densities, velocity, linear feq, BGK per field with logistic
    growth and the pseudo-force (rocket yeast) on the population, clipped
    at 0 (``rocket_yeast.cl:127``), production ``Gc rho`` into the
    surfactant."""
    return _rocket_yeast_update(stream(f, D2Q9), cfg)


def _rocket_yeast_update(f, cfg, belt=None):
    """The rocket-yeast step after the stream; ``belt`` as
    :func:`rocket_yeast_velocity`."""
    rho = density_in_order(f)
    belt = belt or _own_belt(rho)
    u, v = rocket_yeast_velocity(rho, cfg, belt)
    feq = coupled_feq(rho, u, v)
    w, cx, cy = _columns(f)
    om, om_c = _f32(cfg.omega, f), _f32(cfg.omega2, f)
    pop_rho = rho[0]
    growth = _f32(cfg.lb_G, f) * pop_rho * (1.0 - pop_rho)
    new_pop = f[:, 0] * (1 - om) + om * feq[:, 0] + w * growth
    if cfg.physics == "rocket_yeast":
        force = pseudo_force(psi_shan_chen(pop_rho, cfg.rho_o), cfg.G_chen,
                             sums=belt(_psi_pop(cfg)))
        new_pop = new_pop + _force_term(w, cx, cy, force)
    new_pop = torch.clamp(new_pop, min=0.0)
    produce = _f32(cfg.lb_G2, f) * pop_rho
    new_surf = f[:, 1] * (1 - om_c) + om_c * feq[:, 1] + w * produce
    return torch.stack([new_pop, new_surf], dim=1)


def _velocity_of(rho, ext, velocity):
    if ext is not None:
        return ext[0], ext[1]
    return velocity(rho)


def screened_fisher_step_reference(f, cfg: CoupledConfig, ext=None,
                                   velocity=None):
    """One screened Fisher step of ``f[9, 1, ny, nx]`` (or ``[9, ny, nx]``,
    returned in its shape), as JAX ``ScreenedFisherWave._make_xla_step``
    (``waves.py:406-421``): stream, density, the velocity (``velocity(rho)
    -> (u, v)`` of this step's post-stream density, or the held planes
    ``ext[2, ny, nx]``), linear feq, BGK + ``w G rho (1 - rho)``."""
    shape = f.shape
    f = stream(f.reshape(9, *shape[-2:]), D2Q9)
    return _screened_fisher_update(f, cfg, ext, velocity).reshape(shape)


def _screened_fisher_update(f, cfg, ext, velocity=None):
    """The screened Fisher step of ``f[9, R, S]`` after the stream."""
    rho = density_in_order(f)
    u, v = _velocity_of(rho, ext, velocity)
    w, cx, cy = _columns(f)
    feq = w * rho * (1.0 + (cx * u + cy * v) / D2Q9.cs2)
    om = _f32(cfg.omega, f)
    react = _f32(cfg.lb_G, f) * rho * (1.0 - rho)
    return f * (1.0 - om) + om * feq + w * react


def surfactant_step_reference(f, cfg: CoupledConfig, ext=None,
                              velocity=None):
    """One surfactant-nutrient step of ``f[9, 2, ny, nx]``, as JAX
    ``SurfactantNutrientWave._make_xla_step`` (``surfactant.py:173-186``):
    stream, densities, the velocity of the population (``velocity`` or
    ``ext``, as :func:`screened_fisher_step_reference`), linear feq, growth
    ``G rho n`` fed to the population and taken from the nutrient, and for
    ``clumpy_surfactant`` the pseudo-force on the population."""
    return _surfactant_update(stream(f, D2Q9), cfg, ext, velocity)


def _surfactant_update(f, cfg, ext, velocity=None, belt=None):
    """The surfactant-nutrient step after the stream; ``belt`` as
    :func:`rocket_yeast_velocity` (the clumpy pseudo-force's sums)."""
    rho = density_in_order(f)
    u, v = _velocity_of(rho[0], ext, velocity)
    feq = coupled_feq(rho, u, v)
    w, cx, cy = _columns(f)
    om, om_n = _f32(cfg.omega, f), _f32(cfg.omega2, f)
    growth = _f32(cfg.lb_G, f) * rho[0] * rho[1]
    new_pop = f[:, 0] * (1 - om) + om * feq[:, 0] + w * growth
    if cfg.physics == "clumpy_surfactant":
        belt = belt or _own_belt(rho)
        force = pseudo_force(psi_shan_chen(rho[0], cfg.rho_o), cfg.G_chen,
                             sums=belt(_psi_pop(cfg)))
        new_pop = new_pop + _force_term(w, cx, cy, force)
    new_nut = f[:, 1] * (1 - om_n) + om_n * feq[:, 1] - w * growth
    return torch.stack([new_pop, new_nut], dim=1)


def coupled_step_reference(f, cfg: CoupledConfig, ext=None):
    """One plain step of ``cfg``'s physics, the spectral velocity held in
    ``ext`` (the step :func:`coupled_sweep` takes ``k`` times)."""
    if cfg.physics.startswith("rocket_yeast"):
        return rocket_yeast_step_reference(f, cfg)
    if cfg.physics == "screened_fisher":
        return screened_fisher_step_reference(f, cfg, ext=ext)
    return surfactant_step_reference(f, cfg, ext=ext)


def coupled_sweep_reference(f, cfg: CoupledConfig, k_steps: int,
                            ext=None):
    """``k_steps`` plain steps of :func:`coupled_step_reference`, the
    velocity planes ``ext`` held (the plain twin of :func:`coupled_sweep`;
    a new tensor)."""
    for _ in range(int(k_steps)):
        f = coupled_step_reference(f, cfg, ext)
    return f


def coupled_reach(cfg: CoupledConfig) -> int:
    """Cells one step of ``cfg``'s physics reaches: 1, or 2 where it reads
    the neighbours' post-stream densities. A sweep of ``k`` steps reads a
    halo of ``k`` times this."""
    return sweep.coupled_reach(cfg.belt)


def coupled_sweep_halo_reference(halo: Halo, ext: torch.Tensor | None,
                                 cfg: CoupledConfig,
                                 k_steps: int) -> torch.Tensor:
    """``k_steps`` plain steps of a halo's shard, ``[9 F, H, W]`` (the plain
    twin of :func:`coupled_sweep_halo`; a new tensor): the plain steps of
    the halo-extended region, the velocity planes cut from the whole-grid
    ``ext[2, ny, nx]`` around it, then the shard's cells. The region's own
    wrap brings garbage in at its edges, one reach deeper per step, so with
    a halo of at least ``k_steps`` reaches the shard equals
    :func:`coupled_sweep_reference` of the whole grid there."""
    hk = halo.width
    P, H, W = halo.f.shape
    if cfg.reads_ext:
        ext = cut_region(ext, halo.y0, halo.x0, H, W, hk)
    f = halo.extended().view(9, P // 9, H + 2 * hk, W + 2 * hk)
    f = coupled_sweep_reference(f, cfg, k_steps, ext)
    return f[..., hk:hk + H, hk:hk + W].reshape(P, H, W)


# -- the kernels --------------------------------------------------------------

def _density_config(fields: int) -> MCKernelConfig:
    """K6's density pass on ``fields`` periodic fields."""
    return MCKernelConfig(fluids=(FluidParams(omega=1.0),) * fields,
                          porous=False, zero_density=0.0)


def coupled_density(f: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Each field's post-stream density of ``f[9, F, ny, nx]`` into
    ``rho[F, ny, nx]``: K6's ``mc_density`` on CUDA (counted there), the
    plain density on the CPU."""
    return mc_density(f, rho, _density_config(f.shape[1]), D2Q9)


def coupled_density_halo(halo: Halo, rho: torch.Tensor) -> torch.Tensor:
    """Each field's post-stream density of a halo's shard (``[9 F, H, W]``)
    into its band of the whole-grid ``rho[F, ny, nx]``: K6h's
    ``mc_density_halo`` on CUDA (counted there), its plain twin on the
    CPU."""
    return mc_density_halo(halo, rho, _density_config(halo.f.shape[0] // 9),
                           D2Q9)


def coupled_density_halo_reference(halo: Halo) -> torch.Tensor:
    """The plain twin of :func:`coupled_density_halo`: the post-stream
    densities of a halo's shard, ``[F, H, W]`` (a new tensor)."""
    return mc_density_halo_reference(
        halo, _density_config(halo.f.shape[0] // 9), D2Q9)


def coupled_params(cfg: CoupledConfig) -> _build.CoupledParams:
    """``cfg``'s constants as K7's by-value struct ``Lb2dCoupledParams``,
    each the float32 rounding of what the plain step multiplies by."""
    f32 = np.float32
    prm = _build.CoupledParams()
    prm.physics = COUPLED_PHYSICS[cfg.physics]
    prm.omega = f32(cfg.omega)
    prm.one_minus_omega = f32(1) - f32(cfg.omega)
    prm.omega2 = f32(cfg.omega2)
    prm.one_minus_omega2 = f32(1) - f32(cfg.omega2)
    prm.lb_G, prm.lb_G2 = f32(cfg.lb_G), f32(cfg.lb_G2)
    prm.neg_epsilon = -cfg.epsilon
    prm.rho_o = cfg.rho_o
    prm.sc_pref = -D2Q9.cs2 * cfg.G_chen
    prm.neg_G_chen = -cfg.G_chen
    prm.c_o, prm.alpha = cfg.c_o, cfg.alpha
    ia = int(cfg.alpha)
    prm.int_alpha = ia if float(ia) == float(cfg.alpha) and 1 <= ia <= 4 \
        else 0
    prm.w[:] = list(D2Q9.w)
    return prm


def coupled_max_k(cfg: CoupledConfig) -> int:
    """The most steps of one K7 launch of ``cfg``'s physics (its rings and
    density rings fit a block's shared memory: 8 for all five)."""
    return sweep.coupled_max_k(cfg.fields, cfg.belt)


def _check_coupled(f_in, f_out, cfg):
    F = cfg.fields
    for name, t in (("f_in", f_in), ("f_out", f_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or tuple(t.shape[:2]) != (9, F):
            raise ValueError(f"{name} must be [9, {F}, ny, nx] for "
                             f"{cfg.physics}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f_out.shape != f_in.shape or f_out.device != f_in.device:
        raise ValueError("f_out must match f_in in shape and device")
    if f_out.data_ptr() == f_in.data_ptr():
        raise ValueError("f_out must be a distinct tensor (the sweep is out "
                         "of place)")


def _check_cell_rho(rho, cfg, ny, nx):
    """The one-step kernel's conditions: a screened family on a grid of at
    least 3 x 3."""
    if not cfg.reads_ext or min(ny, nx) < 3:
        raise ValueError("the one-step kernel takes a screened family on a "
                         f"grid of at least 3 x 3, not {cfg.physics} on "
                         f"{ny} x {nx}")


def _k7(f_in, f_out, rho, ext, k_steps, params, cfg):
    """Launch K7 (the sweep, or with ``rho`` the one-step kernel) and count
    it in ``coupled_sweep.launches``."""
    ny, nx = f_in.shape[2:]
    _launch("lb2d_coupled_sweep", f_in, f_out, rho,
            ext if cfg.reads_ext else None, ny, nx, k_steps,
            params if params is not None else coupled_params(cfg))
    coupled_sweep.launches += 1
    return f_out


@traced_launch
def coupled_sweep(f_in: torch.Tensor, f_out: torch.Tensor,
                  ext: torch.Tensor | None, cfg: CoupledConfig, k_steps: int,
                  params: _build.CoupledParams | None = None) -> torch.Tensor:
    """Write ``k_steps`` steps of ``cfg``'s physics of ``f_in`` (``[9, F,
    ny, nx]`` float32) into ``f_out`` and return ``f_out``. ``ext`` (``[2,
    ny, nx]``) holds the velocity planes ``(u, v)`` for the physics whose
    velocity comes from the spectral solve (``cfg.reads_ext``), held for
    the ``k_steps`` steps. ``params`` is ``coupled_params(cfg)``, packed
    once by a caller that steps one configuration many times; None packs
    it here. ``1 <= k_steps <= coupled_max_k(cfg)``.

    On CUDA tensors this launches K7 (counted in ``coupled_sweep.launches``);
    on CPU tensors it runs :func:`coupled_sweep_reference`.
    """
    _check_coupled(f_in, f_out, cfg)
    k_steps = _check_k(k_steps, coupled_max_k(cfg))
    if cfg.reads_ext:
        _check_plane_stack(ext, "ext", 2, f_in)
    if f_in.device.type == "cpu":
        f_out.copy_(coupled_sweep_reference(f_in, cfg, k_steps, ext))
        return f_out
    return _k7(f_in, f_out, None, ext, k_steps, params, cfg)


coupled_sweep.launches = 0


@traced_launch
def _coupled_cell_step(f_in: torch.Tensor, f_out: torch.Tensor,
                       rho: torch.Tensor, ext: torch.Tensor,
                       cfg: CoupledConfig,
                       params: _build.CoupledParams | None = None
                       ) -> torch.Tensor:
    """One step of a screened family (``cfg.reads_ext``) by K7's one-step
    kernel, one thread a cell: the exact (``stale_velocity=1``) step, where
    the solve's density pass has just written ``rho [F, ny, nx]``, the
    post-stream densities of ``f_in``, which the kernel reads in place of
    computing them (a stale ``rho`` gives a wrong clumpy pseudo-force).
    Faster than a sweep of one step (``PERF.md``, section 6). Otherwise as
    :func:`coupled_sweep` at ``k_steps = 1``, and counted with it."""
    _check_coupled(f_in, f_out, cfg)
    _check_cell_rho(rho, cfg, *f_in.shape[2:])
    _check_plane_stack(ext, "ext", 2, f_in)
    _check_plane_stack(rho, "rho", cfg.fields, f_in)
    if f_in.device.type == "cpu":
        f_out.copy_(coupled_sweep_reference(f_in, cfg, 1, ext))
        return f_out
    return _k7(f_in, f_out, rho, ext, 1, params, cfg)


def _check_halo_sweep(halo, f_out, ext, cfg, k_steps):
    check_pieces(halo, f_out)
    F = cfg.fields
    if halo.f.shape[0] != 9 * F:
        raise ValueError(f"f must be [{9 * F}, H, W] for {cfg.physics}, got "
                         f"{tuple(halo.f.shape)}")
    k_steps = _check_k(k_steps, coupled_max_k(cfg))
    if halo.width < k_steps * coupled_reach(cfg):
        raise ValueError(f"{k_steps} steps of {cfg.physics} need a halo of "
                         f"{k_steps * coupled_reach(cfg)} cells, not "
                         f"{halo.width}")
    if cfg.reads_ext:
        _check_grid_planes(ext, "ext", 2, halo)
    return k_steps


def _k7h(halo, f_out, rho, ext, k_steps, params, cfg):
    """Launch K7h (the sweep, or with ``rho`` the one-step kernel) and count
    it in ``coupled_sweep_halo.launches``."""
    H, W = halo.f.shape[1:]
    with torch.cuda.device(halo.f.device):  # shards may lie on several cards
        _launch("lb2d_coupled_halo_sweep", halo.f, halo.top, halo.bot,
                halo.left, halo.right, f_out, rho,
                ext if cfg.reads_ext else None, H, W, halo.width, halo.y0,
                halo.x0, halo.ny, halo.nx, k_steps,
                params if params is not None else coupled_params(cfg))
    coupled_sweep_halo.launches += 1
    return f_out


@traced_launch
def coupled_sweep_halo(halo: Halo, f_out: torch.Tensor,
                       ext: torch.Tensor | None, cfg: CoupledConfig,
                       k_steps: int,
                       params: _build.CoupledParams | None = None
                       ) -> torch.Tensor:
    """Write ``k_steps`` steps of ``cfg``'s physics of a halo's shard
    (``halo.f`` is ``[9 F, H, W]`` float32, its halo at least ``k_steps *
    coupled_reach(cfg)`` cells) into ``f_out`` and return it. ``ext``
    (``[2, ny, nx]``) holds the whole-grid velocity planes for the physics
    that read them, at the cells' global coordinates. ``params`` as
    :func:`coupled_sweep`.

    On CUDA tensors this launches K7h (counted in
    ``coupled_sweep_halo.launches``); on CPU tensors it runs
    :func:`coupled_sweep_halo_reference`.
    """
    k_steps = _check_halo_sweep(halo, f_out, ext, cfg, k_steps)
    if halo.f.device.type == "cpu":
        f_out.copy_(coupled_sweep_halo_reference(halo, ext, cfg, k_steps))
        return f_out
    return _k7h(halo, f_out, None, ext, k_steps, params, cfg)


coupled_sweep_halo.launches = 0


@traced_launch
def _coupled_cell_step_halo(halo: Halo, f_out: torch.Tensor,
                            rho: torch.Tensor, ext: torch.Tensor,
                            cfg: CoupledConfig,
                            params: _build.CoupledParams | None = None
                            ) -> torch.Tensor:
    """:func:`_coupled_cell_step` on a halo's shard: ``rho [F, ny, nx]``
    the whole-grid post-stream densities (the shard's band, and for the
    clumpy surfactant the belt around it). Otherwise as
    :func:`coupled_sweep_halo` at ``k_steps = 1``, and counted with it."""
    _check_halo_sweep(halo, f_out, ext, cfg, 1)
    _check_cell_rho(rho, cfg, halo.ny, halo.nx)
    _check_grid_planes(rho, "rho", cfg.fields, halo)
    if halo.f.device.type == "cpu":
        f_out.copy_(coupled_sweep_halo_reference(halo, ext, cfg, 1))
        return f_out
    return _k7h(halo, f_out, rho, ext, 1, params, cfg)
