"""The halo kernels' checks that ``chip_smoke.py`` and the CUDA tests
share: for K9 each physics' arguments, a random state, the cuts of a grid
into shards, and K9 on each shard against its plain twin; for K6h
(:func:`compare_mc_halo`) a few steps of the shards against the unsharded
K6 and against the plain twins; for K7h (:func:`compare_coupled_halo`) one
K-step launch per shard against K7's K-step launch on the whole grid,
against the plain twin and against K one-step launches.

The cuts need not divide the grid: K9 takes any shard, so a 254x382 grid
is cut 2x2, 4x1 and 1x4 into shards of unequal edges, each with the halo
a halo exchange would give it (:meth:`~lb2d_tpu_torch.ops.fused_halo.Halo.
cut`). Tolerances: 1e-6 for the flow physics (nvcc's FMA contraction, as
K1/K2), 0 for the diffusion and multifield physics, which round every
operation on their own, as K2/K4.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import D2Q9
from .ops.fused_coupled import (
    coupled_density,
    coupled_params,
    coupled_reach,
    coupled_sweep,
    coupled_sweep_halo,
    coupled_sweep_halo_reference,
    _coupled_cell_step_halo,
)
from .ops.fused_halo import (
    HALO_SWEEP_PHYSICS,
    Halo,
    cut_region,
    temporal_halo_step,
    temporal_halo_step_reference,
)
from .ops.fused_mc import (
    lattice_reach,
    mc_density,
    mc_density_halo,
    mc_params,
    mc_step,
    mc_step_halo,
    mc_step_halo_reference,
)

__all__ = ["HALO_CASES", "HALO_MESHES", "SMALL_HALO_CUTS",
           "halo_case_state", "halo_case_ks",
           "shard_cuts", "compare_halo_case", "halo_tolerance",
           "compare_mc_halo", "compare_coupled_halo"]

_FLOW = dict(omega=1.3, inlet_rho=1.003, outlet_rho=1.0)
_VELOCITY = dict(omega=1.3, u_w=0.05, u_e=0.05, incompressible=False)
_DIFFUSION = dict(omega=1.7, u_lb=0.01, v_lb=-0.02, lb_G=0.01)
_MF = dict(u_lb=0.0021, v_lb=-0.0013)
# label: (physics, its step's arguments, fields, obstacle); the seeds of the
# noisy physics put their keys' high words to use
HALO_CASES = {
    "flow": ("flow", dict(_FLOW, incompressible=False), 1, False),
    "flow incompressible": ("flow", dict(_FLOW, incompressible=True), 1,
                            False),
    "flow obstacle": ("flow", dict(_FLOW, incompressible=False), 1, True),
    "flow incompressible obstacle": ("flow", dict(_FLOW, incompressible=True),
                                     1, True),
    "velocity_inlet zero_gradient": (
        "velocity_inlet", dict(_VELOCITY, outlet="zero_gradient"), 1, False),
    "velocity_inlet velocity": (
        "velocity_inlet", dict(_VELOCITY, outlet="velocity"), 1, False),
    "diffusion": ("diffusion", _DIFFUSION, 1, False),
    "noisy_fisher": ("noisy_fisher", dict(_DIFFUSION, lb_Dg=0.05,
                                          seed=2**40 + 3), 1, False),
    "multifield_fisher": ("multifield_fisher", dict(
        _MF, omegas=np.float32([1.9, 1.95]),
        lb_G=np.float32([1e-4, 2e-4])), 2, False),
    "multifield_expansion": ("multifield_expansion", dict(
        _MF, omegas=np.float32([1.9, 1.95]), omega_nutrient=np.float32(1.95),
        lb_G=np.float32([1e-4, 2e-4]), lb_Dg=np.float32([0.02, 0.03]),
        cutoff=0.01, seed=2**40 + 7), 3, False),
}
HALO_MESHES = ((2, 2), (4, 1), (1, 4))
# small ragged grids and their cuts: shards narrower than one strip, a few
# rows high, x wrapping within the shard (2x1)
SMALL_HALO_CUTS = (((37, 53), (2, 1)), ((37, 53), (1, 3)), ((30, 47), (2, 2)),
                   ((30, 47), (3, 3)))


def halo_tolerance(physics: str) -> float:
    return 1e-6 if physics in ("flow", "velocity_inlet") else 0.0


def halo_case_ks(case: str):
    """The steps per sweep to check: every K up to K9's limit for the
    physics that run K2's row sweep (flow, diffusion, noisy Fisher); 1, 2,
    3 and the K of the physics' sharded path for the others (K9's
    ``HALO_TEMPORAL_K``, the multifield models' own ``FISHER_TEMPORAL_K``
    and ``EXPANSION_TEMPORAL_K``)."""
    from .models.multifield import EXPANSION_TEMPORAL_K, FISHER_TEMPORAL_K
    from .ops.fused_halo import HALO_TEMPORAL_K, halo_max_k

    physics = HALO_CASES[case][0]
    if physics in HALO_SWEEP_PHYSICS:
        return list(range(1, halo_max_k(physics) + 1))
    default = dict(HALO_TEMPORAL_K, multifield_fisher=FISHER_TEMPORAL_K,
                   multifield_expansion=EXPANSION_TEMPORAL_K)
    return sorted({1, 2, 3, default[physics]})


def halo_case_state(case: str, ny: int, nx: int, device):
    """A random state ``[P, ny, nx]`` for ``case`` (numpy seed 5) and, for
    the obstacle cases, a global int32 mask (a block, a wall cell and a
    corner)."""
    physics, _, F, obstacle = HALO_CASES[case]
    rng = np.random.RandomState(5)
    w = np.asarray(D2Q9.w)[:, None, None, None]
    if physics == "multifield_fisher":
        rho = 0.9 * rng.rand(F, ny, nx) / F
    elif physics == "multifield_expansion":
        rho = 0.3 * rng.rand(F, ny, nx) ** 2
        rho[-1] = rng.rand(ny, nx)
    elif physics in ("diffusion", "noisy_fisher"):
        rho = 0.1 + 0.8 * rng.rand(F, ny, nx)
    else:
        rho = np.ones((F, ny, nx))
    f = w * rho * (1.0 + 0.01 * rng.randn(9, F, ny, nx))
    f = torch.tensor(f.reshape(9 * F, ny, nx), dtype=torch.float32,
                     device=device)
    mask = None
    if obstacle:
        m = np.zeros((ny, nx), np.int32)
        m[ny // 3:ny // 2 + 2, nx // 3:nx // 2] = 1
        m[0, nx // 2] = m[-1, -1] = 1
        mask = torch.tensor(m, device=device)
    return f, mask


def shard_cuts(ny: int, nx: int, my: int, mx: int):
    """``(y0, x0, H, W)`` of an ``my x mx`` cut of an ``ny x nx`` grid into
    nearly equal shards."""
    ys = np.linspace(0, ny, my + 1).round().astype(int)
    xs = np.linspace(0, nx, mx + 1).round().astype(int)
    return [(int(ys[i]), int(xs[j]), int(ys[i + 1] - ys[i]),
             int(xs[j + 1] - xs[j])) for i in range(my) for j in range(mx)]


def compare_halo_case(case: str, f: torch.Tensor, mask, cuts, k: int,
                      step0: int = 0) -> float:
    """K9 on each shard of ``cuts`` of the global state ``f`` (halo ``k``
    cells wide) against its plain twin; returns the largest ``|d|``."""
    physics, kw, _, _ = HALO_CASES[case]
    worst = 0.0
    for y0, x0, H, W in cuts:
        halo = Halo.cut(f, y0, x0, H, W, k)
        region = (None if mask is None
                  else cut_region(mask, y0, x0, H, W, k).contiguous())
        got = temporal_halo_step(halo, torch.empty_like(halo.f), k, physics,
                                 mask=region, step0=step0, **kw)
        want = temporal_halo_step_reference(halo, k, physics, mask=region,
                                            step0=step0, **kw)
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"K9 {case}: non-finite populations")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def _max_diff(a, b) -> float:
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("non-finite populations")
    return float((a - b).abs().max())


def _shard_steps(f, cuts, reach, steps, whole_step, shard_density,
                 shard_step, twin):
    """``steps`` steps of the state ``f [q, C, ny, nx]`` whole
    (``whole_step(f) -> f``) and cut into ``cuts`` (each step's halos cut
    from the assembled state, as an exchange gives them; every shard's
    density pass, then every shard's step, ``shard_step(halo, out)``);
    returns max |df| between the two and between each shard's step and
    ``twin(halo)``."""
    P = f.shape[0] * f.shape[1]
    whole, sharded = f.clone(), f.clone()
    d_whole = d_twin = 0.0
    for _ in range(steps):
        flat = sharded.view(P, *f.shape[2:])
        halos = [Halo.cut(flat, y0, x0, H, W, reach)
                 for y0, x0, H, W in cuts]
        for halo in halos:
            shard_density(halo)
        whole = whole_step(whole)
        nxt = torch.empty_like(flat)
        for halo, (y0, x0, H, W) in zip(halos, cuts):
            out = shard_step(halo, torch.empty_like(halo.f))
            d_twin = max(d_twin, _max_diff(out, twin(halo)))
            nxt[:, y0:y0 + H, x0:x0 + W] = out
        sharded = nxt.view(f.shape)
        d_whole = max(d_whole, _max_diff(sharded, whole))
    return d_whole, d_twin


def compare_mc_halo(f, cfg, lattice, ext, cuts, steps=5, solve=None):
    """K6h on the shards ``cuts`` of the state ``f [q, C, ny, nx]`` (CUDA)
    against K6 on the whole grid and against K6h's plain twins, ``steps``
    steps; ``solve(rho, ext)`` fills a screened hook's ext planes from the
    densities. Returns max |df| against K6, against the twins, and max
    |drho| between the two density passes."""
    C = f.shape[1]
    params = mc_params(cfg, lattice)
    rho_w = torch.empty((C, *f.shape[2:]), dtype=f.dtype, device=f.device)
    rho_s = torch.empty_like(rho_w)
    ext_s = None if ext is None else ext.clone()
    d_rho = [0.0]

    def whole_step(g):
        mc_density(g, rho_w, cfg, lattice)
        d_rho[0] = max(d_rho[0], _max_diff(rho_s, rho_w))
        if solve is not None:
            solve(rho_w, ext)
            solve(rho_s, ext_s)
        return mc_step(g, torch.empty_like(g), rho_w, ext, cfg, lattice,
                       params)

    d_whole, d_twin = _shard_steps(
        f, cuts, lattice_reach(lattice), steps, whole_step,
        lambda h: mc_density_halo(h, rho_s, cfg, lattice),
        lambda h, out: mc_step_halo(h, out, rho_s, ext_s, cfg, lattice,
                                    params),
        lambda h: mc_step_halo_reference(h, rho_s, ext_s, cfg, lattice))
    return d_whole, d_twin, d_rho[0]


def compare_coupled_halo(f, cfg, ext, cuts, k):
    """K7h, ``k`` steps in one launch, on the shards ``cuts`` of the state
    ``f [9, F, ny, nx]`` (CUDA) with halos of ``k`` reaches, the velocity
    planes ``ext`` held: returns max |df| against K7's ``k``-step launch on
    the whole grid, against K7h's plain twin (``k`` plain steps of each
    shard's region) and against ``k`` one-step K7h launches (each after a
    one-reach halo cut from the assembled state, as an exchange gives it);
    and, for a screened family, of K7h's one-step kernel on the whole-grid
    densities against K7's one-step sweep (else 0)."""
    params = coupled_params(cfg)
    reach = coupled_reach(cfg)
    flat = f.reshape(-1, *f.shape[2:])
    whole = coupled_sweep(f, torch.empty_like(f), ext, cfg, k, params)

    def sweep(state, steps, width, rho=None):
        out, d_twin = torch.empty_like(state), 0.0
        for y0, x0, H, W in cuts:
            halo = Halo.cut(state, y0, x0, H, W, width)
            got = (coupled_sweep_halo(halo, torch.empty_like(halo.f), ext,
                                      cfg, steps, params) if rho is None
                   else _coupled_cell_step_halo(halo, torch.empty_like(halo.f),
                                                rho, ext, cfg, params))
            d_twin = max(d_twin, _max_diff(
                got, coupled_sweep_halo_reference(halo, ext, cfg, steps)))
            out[:, y0:y0 + H, x0:x0 + W] = got
        return out, d_twin

    swept, d_twin = sweep(flat, k, reach * k)
    stepped = flat
    for _ in range(k):
        stepped = sweep(stepped, 1, reach)[0]
    d_cell = 0.0
    if cfg.reads_ext:
        rho = coupled_density(f, torch.empty((cfg.fields, *f.shape[2:]),
                                             device=f.device))
        one = coupled_sweep(f, torch.empty_like(f), ext, cfg, 1, params)
        d_cell = _max_diff(sweep(flat, 1, reach, rho)[0], one.view(flat.shape))
    return (_max_diff(swept, whole.view(flat.shape)), d_twin,
            _max_diff(swept, stepped), d_cell)
