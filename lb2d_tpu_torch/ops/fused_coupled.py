"""One step of the coupled two-field families: K7 and its plain versions
(counterpart of ``lb2d_tpu.ops.fused_coupled``).

The families: rocket yeast (population + surfactant; the velocity is the
surfactant's one-belt gradient, plus a Shan-Chen pseudo-force; or, forces
only, a surface-tension and a pressure force field), the screened Fisher
wave (one field advected by its screened-Poisson velocity) and the
surfactant-nutrient waves (population + nutrient on the screened-Poisson
velocity of the population, growth ``G rho n``; clumpy: plus the
pseudo-force). The state is ``f[9, F, ny, nx]``, K6's layout.

* The plain steps, each exactly the JAX model's XLA step and each its
  model's eager step: :func:`rocket_yeast_step_reference` (both variants),
  :func:`screened_fisher_step_reference` and
  :func:`surfactant_step_reference` (plain and clumpy). The last two take
  the velocity as ``velocity(rho) -> (u, v)`` (solved from this step's
  post-stream density) or as held planes ``ext = [u, v]``. Their stencils
  are the port's copies of the JAX models': :func:`stencil_gradient`,
  :func:`psi_shan_chen`, :func:`psi_sticky_repulsive`, :func:`pseudo_force`.
* :func:`coupled_density` and :func:`coupled_step` (``csrc/coupled_step.cu``,
  K7): one step is K6's density pass (``mc_density`` on F periodic fields,
  the post-stream density the stencils and the spectral solve read) and one
  launch of the coupled kernel, one thread per cell, any grid of at least
  3 x 3. Ports ``make_rocket_yeast_step``, ``make_screened_fisher_step``
  and ``make_surfactant_step`` (``fused_coupled.py:105, 202, 251``); their
  K-step sweeps and density emit are TPU scheduling and are not carried
  over.

* :func:`coupled_density_halo` and :func:`coupled_step_halo` (K7h): the
  same on one shard and its one-cell halo, the densities and velocity
  planes read from whole-grid planes at global coordinates; the plain
  twin is :func:`coupled_step_halo_reference`.

The kernels run only on CUDA tensors; on CPU tensors each wrapper runs the
plain version. :func:`coupled_step` counts its launches in
``coupled_step.launches``, :func:`coupled_step_halo` in its own.
:func:`coupled_params` packs a configuration's constants once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import D2Q9
from . import _build
from .fused import _launch
from .fused_halo import Halo, check_pieces
from .fused_mc import (
    FluidParams,
    MCKernelConfig,
    _check_grid_planes,
    _check_plane_stack,
    gather_shifted,
    mc_density,
    mc_density_halo,
    shard_cells,
    stream_halo,
)
from .stream import stream

__all__ = ["COUPLED_PHYSICS", "CoupledConfig", "stencil_gradient",
           "psi_shan_chen", "psi_sticky_repulsive", "pseudo_force",
           "rocket_yeast_velocity", "coupled_feq",
           "rocket_yeast_step_reference",
           "screened_fisher_step_reference", "surfactant_step_reference",
           "coupled_step_reference", "coupled_step_halo_reference",
           "coupled_density", "coupled_step", "coupled_density_halo",
           "coupled_step_halo", "coupled_params"]

# Lb2dCoupledParams.physics (csrc/coupled_cell.cuh)
COUPLED_PHYSICS = {"rocket_yeast": 0, "rocket_yeast_forces_only": 1,
                   "screened_fisher": 2, "surfactant": 3,
                   "clumpy_surfactant": 4}
_EXT_PHYSICS = ("screened_fisher", "surfactant", "clumpy_surfactant")
_NEIGHBOUR_PHYSICS = ("rocket_yeast", "rocket_yeast_forces_only",
                      "clumpy_surfactant")


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
        """The kernel reads the neighbours' post-stream densities."""
        return self.physics in _NEIGHBOUR_PHYSICS


# -- the plain pieces (in the JAX package: models/surfactant.py,
#    models/rocket_yeast.py) ------------------------------------------------

def _belt_sum(field, lattice):
    """``(sum_j w_j cx_j v(x + c_j), sum_j w_j cy_j v(x + c_j))`` over the
    moving directions, periodic neighbours, in direction order."""
    fx = torch.zeros_like(field)
    fy = torch.zeros_like(field)
    for j in range(1, lattice.q):
        cxj, cyj = lattice.cx[j], lattice.cy[j]
        # v(x + c_j): shift by -c on the array index
        shifted = torch.roll(torch.roll(field, -cyj, dims=-2), -cxj, dims=-1)
        fx = fx + lattice.w[j] * cxj * shifted
        fy = fy + lattice.w[j] * cyj * shifted
    return fx, fy


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
    rho = f.sum(dim=0)
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
    rho = f.sum(dim=0)
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
    rho = f.sum(dim=0)
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
    """The plain version of :func:`coupled_step`: one step of ``cfg``'s
    physics, the spectral velocity held in ``ext``."""
    if cfg.physics.startswith("rocket_yeast"):
        return rocket_yeast_step_reference(f, cfg)
    if cfg.physics == "screened_fisher":
        return screened_fisher_step_reference(f, cfg, ext=ext)
    return surfactant_step_reference(f, cfg, ext=ext)


def coupled_step_halo_reference(halo: Halo, rho: torch.Tensor | None,
                                ext: torch.Tensor | None,
                                cfg: CoupledConfig) -> torch.Tensor:
    """One plain step of ``cfg``'s physics of a halo's shard, ``[9 F, H,
    W]`` (the plain twin of :func:`coupled_step_halo`; a new tensor): the
    stream of the halo-extended region cut back to the shard, then the
    step of :func:`coupled_step_reference` with the one-belt sums read from
    the whole-grid densities ``rho[F, ny, nx]`` and the velocity planes cut
    from the whole-grid ``ext[2, ny, nx]``. Equals
    :func:`coupled_step_reference` of the whole grid at the shard's
    cells."""
    f = stream_halo(halo, _density_config(cfg.fields), D2Q9)
    rows, cols = shard_cells(halo)
    belt = None
    if cfg.reads_neighbours:
        def belt(g):  # _belt_sum of g(rho) at the shard's cells
            field = g(rho)  # the whole grid's, rounded as unsharded
            fx = torch.zeros_like(field[rows, cols])
            fy = torch.zeros_like(fx)
            for j in range(1, D2Q9.q):
                cxj, cyj = D2Q9.cx[j], D2Q9.cy[j]
                shifted = gather_shifted(field, (rows, cols), cxj, cyj)
                fx = fx + D2Q9.w[j] * cxj * shifted
                fy = fy + D2Q9.w[j] * cyj * shifted
            return fx, fy
    if cfg.reads_ext:
        ext = ext[:, rows, cols]
    if cfg.physics.startswith("rocket_yeast"):
        out = _rocket_yeast_update(f, cfg, belt)
    elif cfg.physics == "screened_fisher":
        out = _screened_fisher_update(f[:, 0], cfg, ext)
    else:
        out = _surfactant_update(f, cfg, ext, belt=belt)
    return out.reshape(halo.f.shape)


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
        raise ValueError("f_out must be a distinct tensor (the step is out "
                         "of place)")
    if f_in.device.type == "cuda" and min(f_in.shape[2:]) < 3:
        raise ValueError(f"the coupled kernel needs a grid of at least 3 x 3, "
                         f"not {tuple(f_in.shape[2:])}")


def coupled_step(f_in: torch.Tensor, f_out: torch.Tensor,
                 rho: torch.Tensor | None, ext: torch.Tensor | None,
                 cfg: CoupledConfig,
                 params: _build.CoupledParams | None = None) -> torch.Tensor:
    """Write one step of ``cfg``'s physics of ``f_in`` (``[9, F, ny, nx]``
    float32) into ``f_out`` and return ``f_out``. ``rho`` (``[F, ny,
    nx]``) holds ``f_in``'s post-stream densities (:func:`coupled_density`)
    for the physics that read the neighbours' (``cfg.reads_neighbours``);
    ``ext`` (``[2, ny, nx]``) the velocity planes ``(u, v)`` for those
    whose velocity comes from the spectral solve (``cfg.reads_ext``).
    ``params`` is ``coupled_params(cfg)``, packed once by a caller that
    steps one configuration many times; None packs it here.

    On CUDA tensors this launches K7 (counted in ``coupled_step.launches``);
    on CPU tensors it runs :func:`coupled_step_reference`.
    """
    _check_coupled(f_in, f_out, cfg)
    if cfg.reads_ext:
        _check_plane_stack(ext, "ext", 2, f_in)
    if f_in.device.type == "cpu":
        f_out.copy_(coupled_step_reference(f_in, cfg, ext))
        return f_out
    if cfg.reads_neighbours:
        _check_plane_stack(rho, "rho", cfg.fields, f_in)
    if params is None:
        params = coupled_params(cfg)
    ny, nx = f_in.shape[2:]
    _launch("lb2d_coupled_step", f_in, f_out,
            rho if cfg.reads_neighbours else None,
            ext if cfg.reads_ext else None, ny, nx, params)
    coupled_step.launches += 1
    return f_out


coupled_step.launches = 0


def coupled_step_halo(halo: Halo, f_out: torch.Tensor,
                      rho: torch.Tensor | None, ext: torch.Tensor | None,
                      cfg: CoupledConfig,
                      params: _build.CoupledParams | None = None
                      ) -> torch.Tensor:
    """Write one step of ``cfg``'s physics of a halo's shard (``halo.f`` is
    ``[9 F, H, W]`` float32 with a halo of at least one cell) into
    ``f_out`` and return it. ``rho`` (``[F, ny, nx]``) holds every shard's
    post-stream densities (:func:`coupled_density_halo`) for the physics
    that read the neighbours'; ``ext`` (``[2, ny, nx]``) the whole-grid
    velocity planes for those that read them; both at the cells' global
    coordinates. ``params`` as :func:`coupled_step`.

    On CUDA tensors this launches K7h (counted in
    ``coupled_step_halo.launches``); on CPU tensors it runs
    :func:`coupled_step_halo_reference`.
    """
    check_pieces(halo, f_out)
    F = cfg.fields
    if halo.f.shape[0] != 9 * F:
        raise ValueError(f"f must be [{9 * F}, H, W] for {cfg.physics}, got "
                         f"{tuple(halo.f.shape)}")
    if cfg.reads_ext:
        _check_grid_planes(ext, "ext", 2, halo)
    if cfg.reads_neighbours:
        _check_grid_planes(rho, "rho", F, halo)
    if halo.f.device.type == "cpu":
        f_out.copy_(coupled_step_halo_reference(halo, rho, ext, cfg))
        return f_out
    if min(halo.ny, halo.nx) < 3:
        raise ValueError(f"the coupled kernel needs a grid of at least 3 x "
                         f"3, not {halo.ny} x {halo.nx}")
    if params is None:
        params = coupled_params(cfg)
    H, W = halo.f.shape[1:]
    with torch.cuda.device(halo.f.device):  # shards may lie on several cards
        _launch("lb2d_coupled_halo_step", halo.f, halo.top, halo.bot,
                halo.left, halo.right, f_out,
                rho if cfg.reads_neighbours else None,
                ext if cfg.reads_ext else None, H, W, halo.width, halo.y0,
                halo.x0, halo.ny, halo.nx, params)
    coupled_step_halo.launches += 1
    return f_out


coupled_step_halo.launches = 0
