"""One step of the multicomponent / porous engine: K6 and its plain version
(counterpart of ``lb2d_tpu.ops.fused_mc``).

The step of :class:`~lb2d_tpu_torch.models.multicomponent.SimulationRunner`
is, for ``f[q, C, ny, nx]`` (C fluids, plane ``j * C + i`` when flattened,
the TPU kernel's layout): periodic stream -> zero-gradient edges for the
fluids that have them -> density and momentum per fluid (summed in
direction order) -> the force hooks **in registration order** (constant
force, ``g * rho``, precomputed radial planes, optionally times ``rho``,
the screened-Poisson repulsion of a fluid's density, Shan-Chen interactions
over the D2Q9 first belt or the 24-vector two-belt stencil with periodic or
clamped neighbours) -> Darcy + Forchheimer drag
last (porous runs) -> barycentric velocity -> porosity feq + Guo forcing +
BGK per fluid -> eating / growth collisions on the post-stream density.
The JAX kernel groups the hooks by kind (``fused_mc.py:837-879``); keeping
the plain step's order makes kernel and plain step sum forces alike.

* :func:`mc_step_reference`: the plain PyTorch step, exactly as JAX
  ``SimulationRunner._step`` (``lb2d_tpu/models/multicomponent.py:453-533``)
  composes it; the runner's ``eager`` backend. Its pieces are the port's
  copies of the JAX module's: ``SECOND_BELT_STENCIL``, ``_shift``,
  :func:`get_psi` and ``_zero_gradient_bcs``.
* :func:`mc_density` and :func:`mc_step` (``csrc/mc_step.cu``, K6): one
  step is a launch of each, one thread per cell, on any ``ny x nx`` (at
  least 3 x 3). ``mc_density`` writes each fluid's post-stream density
  ``rho[C, ny, nx]``, which the interactions' neighbour reads need; it runs
  when an interaction or a screened-Poisson hook is registered. A
  screened-Poisson hook's force is an ext plane pair that K8
  (:func:`~lb2d_tpu_torch.ops.spectral.screened_gradients`) writes from
  that density before ``mc_step`` reads it. Ports
  ``_make_halo_kernel`` / ``make_mc_halo_step`` (``fused_mc.py:230,
  704``); its VMEM ring, CH/K tiling, ``nx % 128`` gate and density-emit
  stage are TPU scheduling and are not carried over.

* :func:`mc_density_halo` and :func:`mc_step_halo` (K6h, the same kernels
  on one shard of a domain-decomposed grid, the form JAX's halo kernel
  runs under ``shard_map``): the shard and its halo of the lattice's reach
  (a :class:`~lb2d_tpu_torch.ops.fused_halo.Halo`), with the densities and
  ext planes read from whole-grid planes at global coordinates. Their plain
  twins, :func:`mc_density_halo_reference` and
  :func:`mc_step_halo_reference`, stream the halo-extended region
  (:func:`stream_halo`) and run the plain step's update on the shard.

The kernels run only on CUDA tensors; on CPU tensors each wrapper runs the
plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches``. :func:`mc_params` checks a configuration against
the kernel's limits and packs it once; a caller that steps one
configuration many times passes the result to :func:`mc_step`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import D2Q9, Lattice
from ..utils.tracing import traced_launch
from . import _build
from .boundary import GridCoords
from .fused import _launch
from .fused_halo import Halo, check_pieces
from .spectral import screened_gradients_reference
from .stream import stream

__all__ = ["FluidParams", "MCKernelConfig", "SECOND_BELT_STENCIL", "get_psi",
           "mc_step_reference", "mc_density_reference", "mc_step",
           "mc_density", "stream_halo", "mc_density_halo_reference",
           "mc_step_halo_reference", "mc_density_halo", "mc_step_halo",
           "shard_cells", "lattice_reach", "mc_params", "check_kernel_config",
           "MAX_MC_FLUIDS", "MAX_MC_HOOKS", "MAX_MC_COLLISIONS"]

# what the kernels' by-value struct holds (csrc/mc_cell.cuh, Lb2dMcParams)
MAX_MC_FLUIDS = 4
MAX_MC_HOOKS = 16
MAX_MC_COLLISIONS = 8
_HOOK_KINDS = {"const_force": 0, "const_g": 1, "ext": 2, "screened": 2,
               "interaction": 4}
_EXT_TIMES_RHO = 3


@dataclass(frozen=True)
class FluidParams:
    """Per-fluid constants (``Pourous_Media.__init__``,
    ``single_component.py:46-67``) and whether the fluid has zero-gradient
    edges."""
    omega: float
    epsilon: float = 1.0
    nu_fluid: float = 1.0
    K: float = 1.0
    Fe: float = 1.0
    zero_gradient: bool = False


@dataclass(frozen=True)
class MCKernelConfig:
    """Everything one step needs besides the populations and the ext planes.

    ``hooks`` in registration order, each one of
    ``("const_force", i, fx, fy)`` (``single_component.cl:547-570``),
    ``("const_g", i, gx, gy)`` (force density ``g rho``,
    ``multi.cl:541-566``), ``("ext", i, pair, times_rho)`` (ext planes
    ``2 pair`` and ``2 pair + 1`` as Gx, Gy, times ``rho_i`` for the radial g
    force), ``("screened", i, pair, src, lam2, amplitude)`` (``amplitude``
    times the screened gradients of ``rho_src``, ``multi.py:488-511``, held
    in ext planes ``2 pair``, ``2 pair + 1`` on the kernel path) and
    ``("interaction", i1, i2, G_int, spec, params, belt,
    clamped)`` (``spec`` 0 linear / 1 shan_chen / 2 pow / 3 vdw, belt 1 or 2,
    ``clamped`` for zero-gradient neighbours). ``collisions``:
    ``("eating", i, j, rate)`` or ``("growth", i, lo, hi, rate)``.
    """
    fluids: tuple  # tuple[FluidParams, ...]
    porous: bool
    zero_density: float
    hooks: tuple = ()
    collisions: tuple = ()

    @property
    def interactions(self) -> tuple:
        return tuple(h for h in self.hooks if h[0] == "interaction")

    @property
    def screened(self) -> tuple:
        return tuple(h for h in self.hooks if h[0] == "screened")

    @property
    def num_ext_pairs(self) -> int:
        return sum(1 for h in self.hooks if h[0] in ("ext", "screened"))


# -- the plain pieces (in the JAX package: models/multicomponent.py) ---------

def _second_belt_stencil():
    """The explicit 25-vector two-belt stencil and weights constructed in
    ``single_component.py:533-646`` (pi1 over the first belt, pi2 over the
    second)."""
    pi1, c1 = [], []
    for v in [(1, 0), (0, 1), (-1, 0), (0, -1)]:
        pi1.append(4.0 / 63.0)
        c1.append(v)
    for v in [(1, 1), (-1, 1), (-1, -1), (1, -1)]:
        pi1.append(4.0 / 135.0)
        c1.append(v)
    pi2, c2 = [], []
    for v in [(2, 0), (0, 2), (-2, 0), (0, -2)]:
        pi2.append(1.0 / 180.0)
        c2.append(v)
    for v in [(2, -1), (2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2),
              (1, -2)]:
        pi2.append(2.0 / 945.0)
        c2.append(v)
    for v in [(2, 2), (-2, 2), (-2, -2), (2, -2)]:
        pi2.append(1.0 / 15120.0)
        c2.append(v)
    return list(zip(pi1 + pi2, c1 + c2))


SECOND_BELT_STENCIL = _second_belt_stencil()


def _shift(field, cx, cy, bc):
    """``field(x + c)`` along the last two axes with periodic wrap or
    zero-gradient (clamped-edge) neighbours
    (``single_component.cl:700-716``)."""
    if bc == "periodic":
        out = field
        if cy:
            out = torch.roll(out, -cy, dims=-2)
        if cx:
            out = torch.roll(out, -cx, dims=-1)
        return out
    ny, nx = field.shape[-2:]
    rows = (torch.arange(ny, device=field.device) + cy).clamp(0, ny - 1)
    cols = (torch.arange(nx, device=field.device) + cx).clamp(0, nx - 1)
    return field[..., rows, :][..., cols]


def gather_shifted(field, cells, cx, cy, bc="periodic"):
    """``field(x + c)`` ``[..., H, W]`` at the cells ``(rows, cols)`` (slices)
    of a whole-grid ``field [..., ny, nx]``, with periodic wrap or
    zero-gradient (clamped) neighbours: :func:`_shift` of the whole grid at
    those cells."""
    ny, nx = field.shape[-2:]
    dev = field.device
    rows = torch.arange(cells[0].start, cells[0].stop, device=dev) + cy
    cols = torch.arange(cells[1].start, cells[1].stop, device=dev) + cx
    if bc == "periodic":
        rows, cols = rows % ny, cols % nx
    else:
        rows, cols = rows.clamp(0, ny - 1), cols.clamp(0, nx - 1)
    return field[..., rows, :][..., cols]


def get_psi(specifier, rho_1, rho_2, parameters, zero_density):
    """The 4 pseudopotential forms (``single_component.cl:609-651``)."""
    if specifier == 0:      # linear
        return rho_1, rho_2
    params = [float(p) for p in parameters]
    if specifier == 1:      # shan_chen
        rho_0 = params[0]
        return (rho_0 * (1 - torch.exp(-rho_1 / rho_0)),
                rho_0 * (1 - torch.exp(-rho_2 / rho_0)))
    if specifier == 2:      # pow
        a = params[0]
        return tuple(torch.where(r > zero_density,
                                 torch.clamp(r, min=zero_density) ** a, 0.0)
                     for r in (rho_1, rho_2))
    if specifier == 3:      # vdw (G must be 1); cs from the parameters
        a, b, T, cs = params[:4]
        cs2 = cs * cs
        out = []
        for r in (rho_1, rho_2):
            P = (r * T) / (1 - r * b) - a * r * r
            out.append(torch.sqrt(torch.clamp(2 * (P - cs2 * r) / cs2,
                                              min=0.0)))
        return tuple(out)
    raise ValueError(f"unknown PSI specifier {specifier}")


def _zero_gradient_bcs(f, i, at: GridCoords | None = None):
    """``move_open_bcs`` (``single_component.cl:417-519``): every edge cell of
    fluid ``i`` copies all its populations from the adjacent interior cell,
    corners from the diagonal one; masked selects as the JAX version (rows
    first, then lanes on the row-fixed values). ``at``: the global
    coordinates of ``f``'s cells when ``f`` is a shard (its cells on the
    grid's edges have their interior neighbours inside it); without it,
    the array's edges. Returns a new tensor."""
    fi = f[:, i]
    if at is None:
        ny, nx = fi.shape[-2:]
        row = torch.arange(ny, device=f.device)[:, None]
        lane = torch.arange(nx, device=f.device)[None, :]
    else:
        row, lane, ny, nx = at
    down = torch.roll(fi, -1, dims=-2)   # value at (y+1, x)
    up = torch.roll(fi, 1, dims=-2)      # value at (y-1, x)
    fi = torch.where(row == 0, down, fi)
    fi = torch.where(row == ny - 1, up, fi)
    right = torch.roll(fi, -1, dims=-1)  # value at (y, x+1), post-row-fix
    left = torch.roll(fi, 1, dims=-1)    # value at (y, x-1)
    fi = torch.where(lane == 0, right, fi)
    fi = torch.where(lane == nx - 1, left, fi)
    out = f.clone()
    out[:, i] = fi
    return out


def _stream_bcs(f, cfg, lattice):
    """Periodic stream, then zero-gradient edges per fluid."""
    f = stream(f, lattice)
    for i, fl in enumerate(cfg.fluids):
        if fl.zero_gradient:
            f = _zero_gradient_bcs(f, i)
    return f


def shard_cells(halo: Halo) -> tuple:
    """The rows and columns of a halo's shard in its grid, as slices."""
    H, W = halo.f.shape[1:]
    return (slice(halo.y0, halo.y0 + H), slice(halo.x0, halo.x0 + W))


def stream_halo(halo: Halo, cfg: MCKernelConfig,
                lattice: Lattice = D2Q9) -> torch.Tensor:
    """The post-stream, post-BC populations ``[q, C, H, W]`` of a halo's
    shard (``halo.f`` is ``[q C, H, W]``, its halo at least the lattice's
    reach): the periodic stream of the halo-extended region cut back to
    the shard, then the zero-gradient edges of ``cfg``'s fluids by global
    coordinates. The same values as :func:`_stream_bcs` of the whole grid
    at the shard's cells."""
    q, hk = lattice.q, halo.width
    P, H, W = halo.f.shape
    region = halo.extended().view(q, P // q, H + 2 * hk, W + 2 * hk)
    f = stream(region, lattice)[..., hk:hk + H, hk:hk + W].contiguous()
    dev = halo.f.device
    at = GridCoords((halo.y0 + torch.arange(H, device=dev))[:, None],
                    (halo.x0 + torch.arange(W, device=dev))[None, :],
                    halo.ny, halo.nx)
    for i, fl in enumerate(cfg.fluids):
        if fl.zero_gradient:
            f = _zero_gradient_bcs(f, i, at)
    return f


def _sum_in_order(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def mc_density_reference(f: torch.Tensor, cfg: MCKernelConfig,
                         lattice: Lattice = D2Q9) -> torch.Tensor:
    """Each fluid's post-stream, post-BC density ``[C, ny, nx]``, summed in
    direction order (the plain version of the ``mc_density`` kernel)."""
    f = _stream_bcs(f, cfg, lattice)
    return _sum_in_order([f[j] for j in range(lattice.q)])


def mc_step_reference(f: torch.Tensor, cfg: MCKernelConfig,
                      lattice: Lattice = D2Q9,
                      ext: torch.Tensor | None = None,
                      hold_screened: bool = False) -> torch.Tensor:
    """One multicomponent step of ``f[q, C, ny, nx]`` in plain PyTorch ops
    (returns a new tensor), in the order of JAX ``SimulationRunner._step``
    (``multicomponent.py:453-533``) with its constants as Python floats, so
    float32 and float64 both follow it. ``ext`` holds the planes of the
    ``"ext"`` hooks, ``[2 * pairs, ny, nx]``. A ``"screened"`` hook solves
    its force (in float32, as JAX) from this step's post-stream, post-BC
    density at its place among the hooks; with ``hold_screened`` it reads
    its pair of ``ext`` instead (the kernel path, and ``stale_force``
    sweeps)."""
    # move + move_bcs per fluid (single_component.py:692-699)
    return _mc_update(_stream_bcs(f, cfg, lattice), cfg, lattice, ext,
                      hold_screened)


def _mc_update(f, cfg, lattice, ext, hold_screened, around=None):
    """The step after the stream: ``f`` the post-stream, post-BC
    populations ``[q, C, R, S]``. ``around = (rho, cells)``: the
    interactions read the neighbours' densities from the whole-grid
    ``rho[C, ny, nx]`` at ``cells`` (a shard's rows and columns), not from
    ``f``'s own: the pseudopotential of the whole grid's densities (the
    same values, rounded as the unsharded step rounds them: PyTorch's CPU
    ``pow`` rounds vector lanes and scalar tails apart), gathered at the
    shifted cells (:func:`gather_shifted`)."""
    q, C = lattice.q, f.shape[1]
    like = dict(dtype=f.dtype, device=f.device)
    w = torch.tensor(lattice.w, **like)[:, None, None]
    cx = torch.tensor(lattice.cx, **like)[:, None, None]
    cy = torch.tensor(lattice.cy, **like)[:, None, None]
    cs2 = lattice.cs2
    zd = cfg.zero_density

    # hydro per fluid (single_component.cl:214-274), direction order
    rho = _sum_in_order([f[j] for j in range(q)])          # [C, ny, nx]
    jx = _sum_in_order([cx[j] * f[j] for j in range(q)])
    jy = _sum_in_order([cy[j] * f[j] for j in range(q)])
    good = rho > zd
    safe = torch.where(good, rho, 1.0)
    u = torch.where(good, jx / safe, 0.0)
    v = torch.where(good, jy / safe, 0.0)

    # forces: the hooks in registration order, then the drag last
    Gx = [torch.zeros_like(rho[0]) for _ in range(C)]
    Gy = [torch.zeros_like(rho[0]) for _ in range(C)]
    for hook in cfg.hooks:
        kind = hook[0]
        if kind == "const_force":
            _, i, fx, fy = hook
            Gx[i] = Gx[i] + fx
            Gy[i] = Gy[i] + fy
        elif kind == "const_g":
            _, i, gx, gy = hook
            Gx[i] = Gx[i] + gx * rho[i]
            Gy[i] = Gy[i] + gy * rho[i]
        elif kind == "ext":
            _, i, pair, times_rho = hook
            scale = rho[i] if times_rho else 1.0
            Gx[i] = Gx[i] + ext[2 * pair] * scale
            Gy[i] = Gy[i] + ext[2 * pair + 1] * scale
        elif kind == "screened":
            _, i, pair, src, lam2, amp = hook
            if hold_screened:
                planes = ext[2 * pair:2 * pair + 2]
            else:
                planes = screened_gradients_reference(
                    rho[src].to(torch.float32), lam2,
                    out_scale=amp).to(rho.dtype)
            Gx[i] = Gx[i] + planes[0]
            Gy[i] = Gy[i] + planes[1]
        else:
            _, i1, i2, G_int, spec, params, belt, clamped = hook
            stencil = _belt_stencil(belt)
            bc = "zero_gradient" if clamped else "periodic"
            r1, r2 = rho[i1], rho[i2]
            psi1, psi2 = get_psi(spec, r1, r2, params, zd)
            if around is not None:  # the whole grid's psi, as unsharded
                rho_all, cells = around
                nb1, nb2 = get_psi(spec, rho_all[i1], rho_all[i2], params,
                                   zd)
            fx1 = torch.zeros_like(r1)
            fy1 = torch.zeros_like(r1)
            fx2 = torch.zeros_like(r1)
            fy2 = torch.zeros_like(r1)
            for wgt, (cxj, cyj) in stencil:
                # psi is pointwise: psi of the shifted density is the
                # shifted psi (single_component.cl:700-716)
                if around is None:
                    p1 = _shift(psi1, cxj, cyj, bc)
                    p2 = _shift(psi2, cxj, cyj, bc)
                else:
                    p1 = gather_shifted(nb1, cells, cxj, cyj, bc)
                    p2 = gather_shifted(nb2, cells, cxj, cyj, bc)
                fx1 = fx1 + wgt * cxj * p2
                fy1 = fy1 + wgt * cyj * p2
                fx2 = fx2 + wgt * cxj * p1
                fy2 = fy2 + wgt * cyj * p1
            fx1, fy1 = -G_int * psi1 * fx1, -G_int * psi1 * fy1
            fx2, fy2 = -G_int * psi2 * fx2, -G_int * psi2 * fy2
            # force -> force per density, zero-density guarded
            # (single_component.cl:779-792)
            g1, g2 = r1 > zd, r2 > zd
            safe1 = torch.where(g1, r1, 1.0)
            safe2 = torch.where(g2, r2, 1.0)
            Gx[i1] = Gx[i1] + torch.where(g1, fx1 / safe1, 0.0)
            Gy[i1] = Gy[i1] + torch.where(g1, fy1 / safe1, 0.0)
            Gx[i2] = Gx[i2] + torch.where(g2, fx2 / safe2, 0.0)
            Gy[i2] = Gy[i2] + torch.where(g2, fy2 / safe2, 0.0)
    if cfg.porous:
        # update_forces_pourous (single_component.cl:276-335)
        for i, fl in enumerate(cfg.fluids):
            eps, nuf, K, Fe = fl.epsilon, fl.nu_fluid, fl.K, fl.Fe
            ui, vi = u[i], v[i]
            gx = Gx[i] * eps - (eps * nuf * ui) / K
            gy = Gy[i] * eps - (eps * nuf * vi) / K
            vel_mag = torch.sqrt(ui * ui + vi * vi)
            gx = gx - (eps * Fe * vel_mag * ui) / np.sqrt(K)
            gy = gy - (eps * Fe * vel_mag * vi) / np.sqrt(K)
            Gx[i] = torch.where(good[i], gx, 0.0)
            Gy[i] = torch.where(good[i], gy, 0.0)

    # barycentric velocity (single_component.cl:161-212), no guard on rho_tot
    rho_tot = _sum_in_order([rho[i] for i in range(C)])
    sum_x = (_sum_in_order([jx[i] for i in range(C)])
             + _sum_in_order([rho[i] * Gx[i] / 2.0 for i in range(C)]))
    sum_y = (_sum_in_order([jy[i] for i in range(C)])
             + _sum_in_order([rho[i] * Gy[i] / 2.0 for i in range(C)]))
    u_bary = sum_x / rho_tot
    v_bary = sum_y / rho_tot

    # feq + Guo + BGK per fluid
    cu = cx * u_bary + cy * v_bary
    usq = u_bary * u_bary + v_bary * v_bary
    new_f = []
    for i, fl in enumerate(cfg.fluids):
        eps, omega = fl.epsilon, fl.omega
        # porosity feq (single_component.cl:39-60)
        feq = w * rho[i] * (1.0 + cu / cs2 + cu * cu / (2 * cs2 * cs2 * eps)
                            - usq / (2 * cs2 * eps))
        cF = cx * Gx[i] + cy * Gy[i]
        uF = Gx[i] * u_bary + Gy[i] * v_bary
        if cfg.porous:
            # Guo with rho and porosity (single_component.cl:104-113)
            Fi = w * rho[i] * (1 - 0.5 * omega) * (
                cF / cs2 + cF * cu / (cs2 * cs2 * eps) - uF / (cs2 * eps))
        else:
            # multi.cl:115-126: no rho factor, no porosity
            Fi = w * (1 - 0.5 * omega) * (
                cF / cs2 + cF * cu / (cs2 * cs2) - uF / cs2)
        new_f.append(f[:, i] * (1 - omega) + omega * feq + Fi)
    f = torch.stack(new_f, dim=1)

    # additional collisions, on the post-stream density
    for coll in cfg.collisions:
        if coll[0] == "eating":   # single_component.cl:120-159
            _, ei, ej, rate = coll
            growth = rate * rho[ei] * rho[ej]
            f[:, ei] = f[:, ei] + w * growth
            f[:, ej] = f[:, ej] + -w * growth
        else:                     # multi.cl:182-220
            _, gi, lo, hi, rate = coll
            r = rho[gi]
            grow = torch.where((r > lo) & (r < hi), rate, 0.0)
            f[:, gi] = f[:, gi] + w * grow
    return f


def _belt_stencil(belt):
    """``[(weight, (cx, cy))]``: the D2Q9 moving vectors for belt 1, even on
    D2Q25 (``multi.py:517-529``), or the 24-vector two-belt stencil."""
    if belt == 1:
        return [(D2Q9.w[j], (D2Q9.cx[j], D2Q9.cy[j])) for j in range(1, 9)]
    return SECOND_BELT_STENCIL


# -- the kernels --------------------------------------------------------------

@traced_launch
def mc_density(f: torch.Tensor, rho: torch.Tensor, cfg: MCKernelConfig,
               lattice: Lattice = D2Q9) -> torch.Tensor:
    """Write each fluid's post-stream density of ``f`` into ``rho`` (``[C,
    ny, nx]``, float32) and return ``rho``.

    On CUDA tensors this launches the ``mc_density`` kernel of K6 (counted
    in ``mc_density.launches``); on CPU tensors it runs
    :func:`mc_density_reference`.
    """
    C = _check_mc(f, None, cfg, lattice)
    _check_plane_stack(rho, "rho", C, f)
    if f.device.type == "cpu":
        rho.copy_(mc_density_reference(f, cfg, lattice))
        return rho
    ny, nx = f.shape[2:]
    _launch("lb2d_mc_density", f, rho, ny, nx, lattice.q, C,
            _zero_gradient_mask(cfg))
    mc_density.launches += 1
    return rho


mc_density.launches = 0


@traced_launch
def mc_step(f_in: torch.Tensor, f_out: torch.Tensor,
            rho: torch.Tensor | None, ext: torch.Tensor | None,
            cfg: MCKernelConfig, lattice: Lattice = D2Q9,
            params: _build.McParams | None = None) -> torch.Tensor:
    """Write one multicomponent step of ``f_in`` (``[q, C, ny, nx]``
    float32) into ``f_out`` and return ``f_out``. When ``cfg`` has an
    interaction, ``rho`` (``[C, ny, nx]``) must hold ``f_in``'s post-stream
    densities (:func:`mc_density`); ``ext`` holds the ``[2 * pairs, ny,
    nx]`` planes of its ``"ext"`` hooks. ``params`` is
    ``mc_params(cfg, lattice)``, packed once by a caller that steps one
    configuration many times; None packs it here.

    On CUDA tensors this launches the ``mc_step`` kernel of K6 (counted in
    ``mc_step.launches``), for at most ``MAX_MC_FLUIDS`` fluids,
    ``MAX_MC_HOOKS`` force hooks and ``MAX_MC_COLLISIONS`` collisions; a
    ``"screened"`` hook reads its ext pair, which the caller filled. On CPU
    tensors it runs :func:`mc_step_reference` (which reads no ``rho``) on
    the same held planes.
    """
    C = _check_mc(f_in, f_out, cfg, lattice)
    pairs = cfg.num_ext_pairs
    if pairs:
        _check_plane_stack(ext, "ext", 2 * pairs, f_in)
    if f_in.device.type == "cpu":
        f_out.copy_(mc_step_reference(f_in, cfg, lattice, ext,
                                      hold_screened=True))
        return f_out
    if cfg.interactions:
        _check_plane_stack(rho, "rho", C, f_in)
    if params is None:
        params = mc_params(cfg, lattice)
    ny, nx = f_in.shape[2:]
    _launch("lb2d_mc_step", f_in, f_out, rho if cfg.interactions else None,
            ext if pairs else None, ny, nx, lattice.q, C,
            _zero_gradient_mask(cfg), params)
    mc_step.launches += 1
    return f_out


mc_step.launches = 0


# -- K6h: the same kernels on one shard of a domain-decomposed grid ---------

def mc_density_halo_reference(halo: Halo, cfg: MCKernelConfig,
                              lattice: Lattice = D2Q9) -> torch.Tensor:
    """The post-stream densities ``[C, H, W]`` of a halo's shard (the plain
    twin of :func:`mc_density_halo`): :func:`stream_halo`, summed in
    direction order."""
    f = stream_halo(halo, cfg, lattice)
    return _sum_in_order([f[j] for j in range(lattice.q)])


def mc_step_halo_reference(halo: Halo, rho: torch.Tensor | None,
                           ext: torch.Tensor | None, cfg: MCKernelConfig,
                           lattice: Lattice = D2Q9) -> torch.Tensor:
    """One plain step of a halo's shard, ``[q C, H, W]`` (the plain twin of
    :func:`mc_step_halo`; a new tensor): :func:`stream_halo`, then the step
    of :func:`mc_step_reference` with the interactions' neighbour
    densities read from the whole-grid ``rho[C, ny, nx]`` and the ext
    planes (screened pairs held) cut from the whole-grid ``ext``. Equals
    :func:`mc_step_reference` of the whole grid at the shard's cells."""
    cells = shard_cells(halo)
    if ext is not None:
        ext = ext[:, cells[0], cells[1]]
    out = _mc_update(stream_halo(halo, cfg, lattice), cfg, lattice, ext,
                     True, around=(rho, cells) if cfg.interactions else None)
    return out.reshape(halo.f.shape)


@traced_launch
def mc_density_halo(halo: Halo, rho: torch.Tensor, cfg: MCKernelConfig,
                    lattice: Lattice = D2Q9) -> torch.Tensor:
    """Write the post-stream densities of a halo's shard (``halo.f`` is
    ``[q C, H, W]`` float32, its halo at least the lattice's reach: 1 cell
    for D2Q9, 3 for D2Q25) into its band of the whole-grid ``rho[C, ny,
    nx]`` and return ``rho``. Every shard's pass fills its band; a step
    of :func:`mc_step_halo` reads its neighbours' bands.

    On CUDA tensors this launches K6h's ``mc_density`` (counted in
    ``mc_density_halo.launches``); on CPU tensors it runs
    :func:`mc_density_halo_reference`.
    """
    C = _check_mc_halo(halo, None, cfg, lattice)
    _check_grid_planes(rho, "rho", C, halo)
    if halo.f.device.type == "cpu":
        rows, cols = shard_cells(halo)
        rho[:, rows, cols] = mc_density_halo_reference(halo, cfg, lattice)
        return rho
    with torch.cuda.device(halo.f.device):  # shards may lie on several cards
        _launch("lb2d_mc_halo_density", *_pieces(halo), rho,
                *_geometry(halo), lattice.q, C, _zero_gradient_mask(cfg))
    mc_density_halo.launches += 1
    return rho


mc_density_halo.launches = 0


@traced_launch
def mc_step_halo(halo: Halo, f_out: torch.Tensor, rho: torch.Tensor | None,
                 ext: torch.Tensor | None, cfg: MCKernelConfig,
                 lattice: Lattice = D2Q9,
                 params: _build.McParams | None = None) -> torch.Tensor:
    """Write one multicomponent step of a halo's shard into ``f_out``
    (``[q C, H, W]``) and return it. ``rho`` (``[C, ny, nx]``, when ``cfg``
    has an interaction) holds every shard's post-stream densities
    (:func:`mc_density_halo`); ``ext`` (``[2 pairs, ny, nx]``) the
    whole-grid ext planes, screened pairs included; both are read at the
    cells' global coordinates. ``params`` as :func:`mc_step`.

    On CUDA tensors this launches K6h's ``mc_step`` (counted in
    ``mc_step_halo.launches``); on CPU tensors it runs
    :func:`mc_step_halo_reference`.
    """
    C = _check_mc_halo(halo, f_out, cfg, lattice)
    pairs = cfg.num_ext_pairs
    if pairs:
        _check_grid_planes(ext, "ext", 2 * pairs, halo)
    if cfg.interactions:
        _check_grid_planes(rho, "rho", C, halo)
    if halo.f.device.type == "cpu":
        f_out.copy_(mc_step_halo_reference(halo, rho, ext, cfg, lattice))
        return f_out
    if params is None:
        params = mc_params(cfg, lattice)
    with torch.cuda.device(halo.f.device):
        _launch("lb2d_mc_halo_step", *_pieces(halo), f_out,
                rho if cfg.interactions else None, ext if pairs else None,
                *_geometry(halo), lattice.q, C, _zero_gradient_mask(cfg),
                params)
    mc_step_halo.launches += 1
    return f_out


mc_step_halo.launches = 0


def _pieces(halo):
    return halo.f, halo.top, halo.bot, halo.left, halo.right


def _geometry(halo):
    H, W = halo.f.shape[1:]
    return H, W, halo.width, halo.y0, halo.x0, halo.ny, halo.nx


def _check_mc_halo(halo, f_out, cfg, lattice):
    """Check a shard of ``cfg``'s fluids with a halo of the lattice's reach
    (and its distinct output, unless None); return C."""
    check_pieces(halo, f_out)
    C = len(cfg.fluids)
    if halo.f.shape[0] != lattice.q * C:
        raise ValueError(f"f must hold {lattice.q} x {C} planes, got "
                         f"{tuple(halo.f.shape)}")
    if halo.width < lattice_reach(lattice):
        raise ValueError(f"{lattice.name} needs a halo of "
                         f"{lattice_reach(lattice)} cells, got {halo.width}")
    H, W = halo.f.shape[1:]
    if _zero_gradient_mask(cfg) and (H < 2 or (halo.left is not None
                                               and W < 2)):
        # the edge cell pulls at the cell inside it: reads one cell past
        # the halo of a one-cell shard
        raise ValueError(f"a zero-gradient fluid needs shards of at least "
                         f"2 cells across, not {H}x{W}")
    if halo.f.device.type == "cuda":
        if C > MAX_MC_FLUIDS or lattice.q not in (9, 25):
            check_kernel_config(cfg, lattice)  # raises, naming the limit
        if min(halo.ny, halo.nx) < 3:
            raise ValueError(f"the multicomponent kernel needs a grid of at "
                             f"least 3 x 3, not {halo.ny} x {halo.nx}")
    return C


def _check_grid_planes(t, name, planes, halo):
    want = (planes, halo.ny, halo.nx)
    if t is None or tuple(t.shape) != want:
        raise ValueError(f"{name} must be {want}, got "
                         f"{None if t is None else tuple(t.shape)}")
    if (t.dtype != halo.f.dtype or t.device != halo.f.device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {halo.f.dtype} on "
                         f"{halo.f.device}")


def lattice_reach(lattice: Lattice) -> int:
    """The farthest a population streams in one step: 1 for D2Q9, 3 for
    D2Q25 (the halo a shard's step needs)."""
    return int(max(abs(c) for c in (*lattice.cx, *lattice.cy)))


def check_kernel_config(cfg: MCKernelConfig, lattice: Lattice):
    """Raise ``ValueError`` naming ``backend='eager'`` for a configuration
    that K6's struct does not hold."""
    limits = (("fluids", len(cfg.fluids), MAX_MC_FLUIDS),
              ("force hooks", len(cfg.hooks), MAX_MC_HOOKS),
              ("collision hooks", len(cfg.collisions), MAX_MC_COLLISIONS))
    for what, n, most in limits:
        if n > most:
            raise ValueError(f"the multicomponent kernel takes at most {most} "
                             f"{what}, not {n}; pass backend='eager' to run "
                             "the plain PyTorch step on the card")
    if lattice.q not in (9, 25):
        raise ValueError(f"the multicomponent kernel runs D2Q9 and D2Q25, not "
                         f"{lattice.name}; pass backend='eager'")


def _check_mc(f_in, f_out, cfg, lattice):
    """Check a ``[q, C, ny, nx]`` float32 state of ``cfg``'s fluids (and,
    unless None, its distinct output of the same shape); return C."""
    for name, t in (("f_in", f_in), ("f_out", f_out)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or t.shape[0] != lattice.q:
            raise ValueError(f"{name} must be [{lattice.q}, C, ny, nx], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f_out is not None:
        if f_out.shape != f_in.shape or f_out.device != f_in.device:
            raise ValueError("f_out must match f_in in shape and device")
        if f_out.data_ptr() == f_in.data_ptr():
            raise ValueError("f_out must be a distinct tensor (the step is "
                             "out of place)")
    C = f_in.shape[1]
    if C != len(cfg.fluids):
        raise ValueError(f"f has {C} fluids, the config {len(cfg.fluids)}")
    if f_in.device.type == "cuda":
        if C > MAX_MC_FLUIDS or lattice.q not in (9, 25):
            check_kernel_config(cfg, lattice)  # raises, naming the limit
        if min(f_in.shape[2:]) < 3:
            raise ValueError(f"the multicomponent kernel needs a grid of at "
                             f"least 3 x 3, not {tuple(f_in.shape[2:])}")
    return C


def _check_plane_stack(t, name, planes, f):
    want = (planes, *f.shape[2:])
    if t is None or tuple(t.shape) != want:
        raise ValueError(f"{name} must be {want}, got "
                         f"{None if t is None else tuple(t.shape)}")
    if t.dtype != f.dtype or t.device != f.device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {f.dtype} on "
                         f"{f.device}")


def _zero_gradient_mask(cfg):
    """Bit i set when fluid i has zero-gradient edges."""
    return sum(1 << i for i, fl in enumerate(cfg.fluids) if fl.zero_gradient)


def mc_params(cfg: MCKernelConfig, lattice: Lattice) -> _build.McParams:
    """The constants of ``cfg``'s K6 launches as the kernel's by-value
    struct, ``Lb2dMcParams``, after :func:`check_kernel_config`: each one
    the float32 rounding of the Python double that
    :func:`mc_step_reference` multiplies by, or of the reciprocal of one it
    divides by in feq and Guo (the kernel multiplies there)."""
    check_kernel_config(cfg, lattice)
    prm = _build.McParams()
    cs2 = lattice.cs2
    for i, fl in enumerate(cfg.fluids):
        om, eps = fl.omega, fl.epsilon
        prm.omega[i], prm.one_minus_omega[i] = om, 1 - om
        prm.guo_pref[i] = 1 - 0.5 * om
        prm.inv_feq_cu2[i] = 1 / (2 * cs2 * cs2 * eps)
        prm.inv_feq_usq[i] = 1 / (2 * cs2 * eps)
        prm.inv_guo_cu[i] = 1 / (cs2 * cs2 * eps if cfg.porous else cs2 * cs2)
        prm.inv_guo_uf[i] = 1 / (cs2 * eps if cfg.porous else cs2)
        prm.eps[i] = eps
        prm.drag_lin[i] = eps * fl.nu_fluid
        prm.K[i] = fl.K
        prm.drag_fe[i] = eps * fl.Fe
        prm.sqrt_K[i] = np.sqrt(fl.K)
    prm.w[:lattice.q] = list(lattice.w)
    prm.inv_cs2, prm.zero_density = 1 / cs2, cfg.zero_density
    prm.porous = int(cfg.porous)
    prm.num_hooks, prm.num_collisions = len(cfg.hooks), len(cfg.collisions)
    for h, hook in enumerate(cfg.hooks):
        dst = prm.hooks[h]
        kind = hook[0]
        dst.kind, dst.a = _HOOK_KINDS[kind], hook[1]
        if kind in ("const_force", "const_g"):
            dst.p[0], dst.p[1] = hook[2], hook[3]
        elif kind == "ext":
            dst.ext_pair = hook[2]
            if hook[3]:
                dst.kind = _EXT_TIMES_RHO
        elif kind == "screened":   # its ext pair, written by K8
            dst.ext_pair = hook[2]
        else:
            _, _, i2, G_int, spec, params, belt, clamped = hook
            dst.b, dst.spec, dst.belt = i2, spec, belt
            dst.clamped = int(clamped)
            dst.p[0] = -G_int
            if spec == 3:   # vdw: a, b, T and cs^2 (cs from the parameters)
                a, b, T, cs = params[:4]
                dst.p[1], dst.p[2], dst.p[3], dst.p[4] = a, b, T, cs * cs
            elif spec in (1, 2):   # shan_chen rho_0, pow exponent
                dst.p[1] = params[0]
    for c, coll in enumerate(cfg.collisions):
        dst = prm.coll[c]
        if coll[0] == "eating":
            dst.kind, dst.a, dst.b, dst.rate = 0, coll[1], coll[2], coll[3]
        else:
            dst.kind, dst.a = 1, coll[1]
            dst.lo, dst.hi, dst.rate = coll[2], coll[3], coll[4]
    return prm
