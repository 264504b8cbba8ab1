"""The K9 checks that ``chip_smoke.py`` and the CUDA tests share: each
physics' arguments, a random state, the cuts of a grid into shards, and K9
on each shard against its plain twin.

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
from .ops.fused_halo import (
    Halo,
    cut_region,
    temporal_halo_step,
    temporal_halo_step_reference,
)

__all__ = ["HALO_CASES", "HALO_MESHES", "halo_case_state", "halo_case_ks",
           "shard_cuts", "compare_halo_case", "halo_tolerance"]

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


def halo_tolerance(physics: str) -> float:
    return 1e-6 if physics in ("flow", "velocity_inlet") else 0.0


def halo_case_ks(case: str):
    """The steps per sweep to check: 1, 2, 3 and the K of the physics'
    unsharded path (``TEMPORAL_K`` and its siblings)."""
    from .models.diffusion import DIFFUSION_TEMPORAL_K, NOISY_TEMPORAL_K
    from .models.multifield import EXPANSION_TEMPORAL_K, FISHER_TEMPORAL_K
    from .models.pipe_flow import TEMPORAL_K

    default = {"flow": TEMPORAL_K, "velocity_inlet": TEMPORAL_K,
               "diffusion": DIFFUSION_TEMPORAL_K,
               "noisy_fisher": NOISY_TEMPORAL_K,
               "multifield_fisher": FISHER_TEMPORAL_K,
               "multifield_expansion": EXPANSION_TEMPORAL_K}
    return sorted({1, 2, 3, default[HALO_CASES[case][0]]})


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
