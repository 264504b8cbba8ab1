"""K6h's and K7h's plain twins against JAX's halo kernels, on the CPU.

JAX's K6 and K7 are themselves halo kernels: ``make_mc_halo_step`` and the
coupled builders step one y-shard from its rows and the CH-row chunks above
and below it (``lb2d_tpu/ops/fused_mc.py:704``, ``fused_coupled.py:105,
202``). Here they run in interpret mode on one 32-row shard of a 128-lane
grid (rows [32, 64)) with CH = 8 chunks, one step, and the port's twins
take the same shard with the chunks' rows next to it as their halo: K6h's
(:func:`~lb2d_tpu_torch.ops.fused_mc.mc_step_halo_reference`) with the
densities of the whole grid, K7h's (:func:`~lb2d_tpu_torch.ops.
fused_coupled.coupled_sweep_halo_reference`) with a halo of one step's
reach (two rows for rocket yeast, whose densities it computes on the
shard's region); so do the wrappers, whose CPU path is the twin. The bar is JAX's kernel-vs-XLA bar, atol 5e-7 and rtol 1e-5. JAX's
K6 takes no zero-gradient edges (its kernel plan sends them to the XLA
step), so the zero-gradient twin, on a shard at the grid's top-right
corner, is held to JAX's XLA step of the whole grid cut to the shard.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lb2d_tpu.models as jax_models
import lb2d_tpu.models.multicomponent as jax_mc
from lb2d_tpu_torch import models as torch_models
from lb2d_tpu_torch.mc_cases import mc_case
from lb2d_tpu_torch.ops.fused_coupled import (
    coupled_reach,
    coupled_sweep_halo,
    coupled_sweep_halo_reference,
)
from lb2d_tpu_torch.ops.fused_halo import Halo
from lb2d_tpu_torch.ops.fused_mc import (
    mc_density_halo,
    mc_density_reference,
    mc_step_halo,
    mc_step_halo_reference,
)

torch.set_num_threads(1)

ATOL, RTOL = 5e-7, 1e-5
Y0, H, CH = 32, 32, 8  # the shard's rows [32, 64) and JAX's chunk rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_pieces(f):
    """The shard of a global ``[P, ny, nx]`` state and JAX's CH-row chunks
    above and below it."""
    ny = f.shape[1]
    return (f[:, Y0:Y0 + H], f[:, Y0 - CH:Y0],
            f[:, np.arange(Y0 + H, Y0 + H + CH) % ny])


def _halo(f, width):
    """The port's halo of the same shard: the chunks' ``width`` rows next
    to it."""
    loc, top, bot = _jax_pieces(f)
    ny, nx = f.shape[1:]
    return Halo(_t(loc), _t(top[:, CH - width:]), _t(bot[:, :width]), None,
                None, Y0, 0, ny, nx)


def test_mc_halo_twin_matches_jax_halo_kernel():
    """Configuration (a) (porous, Shan-Chen, a constant force, eating) at
    96x128: one K6 step of the shard."""
    from lb2d_tpu.core.lattice import D2Q25 as JAX_D2Q25
    from lb2d_tpu.ops.fused_mc import make_mc_halo_step

    jax_sim = mc_case("a", 96, 128, runner=jax_mc.SimulationRunner,
                      fluid=jax_mc.Fluid, d2q25=JAX_D2Q25, backend="kernel")
    sim = mc_case("a", 96, 128, device="cpu")
    cfg, lat = sim.config(), sim.lattice
    f = sim.state_numpy().reshape(18, 96, 128)
    kernel = make_mc_halo_step(H=H, nx=128, cfg=jax_sim._kernel_plan()[0],
                               interpret=True, chunk=CH, k_steps=1)
    want = np.asarray(kernel(*map(jnp.asarray, _jax_pieces(f))))
    halo = _halo(f, 1)
    rho = mc_density_reference(sim.f, cfg, lat)
    got = mc_step_halo_reference(halo, rho, None, cfg, lat)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    rho_w = torch.zeros_like(rho)
    mc_density_halo(halo, rho_w, cfg, lat)  # the CPU path: the twin
    assert torch.equal(rho_w[:, Y0:Y0 + H], rho[:, Y0:Y0 + H])
    launches = mc_step_halo.launches
    out = mc_step_halo(halo, torch.empty_like(halo.f), rho, None, cfg, lat)
    assert torch.equal(out, got) and mc_step_halo.launches == launches


def test_zero_gradient_halo_twin_matches_jax_xla_step():
    """Configuration (e) (zero-gradient fluids, a clamped interaction, the
    radial g force) at 48x64: one step of the top-right 24x32 shard, whose
    edges are the grid's, against JAX's XLA step cut to it."""
    jax_sim = mc_case("e", 48, 64, runner=jax_mc.SimulationRunner,
                      fluid=jax_mc.Fluid, backend="xla")
    sim = mc_case("e", 48, 64, device="cpu")
    cfg, lat = sim.config(), sim.lattice
    want = np.asarray(jax_sim._step(jax_sim.f))[:, :, :24, 32:]
    halo = Halo.cut(sim.f.reshape(18, 48, 64), 0, 32, 24, 32, 1)
    got = mc_step_halo_reference(halo, mc_density_reference(sim.f, cfg, lat),
                                 sim.ext_planes(), cfg, lat)
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["RocketYeast", "ScreenedFisherWave"])
def test_coupled_halo_twin_matches_jax_halo_kernel(name):
    """One K7 step of the shard of a 128^2 model's state: rocket yeast
    (the neighbours' densities), the screened Fisher wave (random velocity
    planes for its ext chunk)."""
    from lb2d_tpu.ops.fused_coupled import (
        make_rocket_yeast_step,
        make_screened_fisher_step,
    )

    kw = {"RocketYeast": dict(Lx=1.0, Ly=1.0, R0=0.2, epsilon=0.05, Gc=2.0,
                              N=128, G_chen=-0.1),
          "ScreenedFisherWave": dict(Lx=1.0, Ly=1.0, vc=1.0, lam=0.5,
                                     R0=0.2, N=128)}[name]
    jm = getattr(jax_models, name)(**kw)
    sim = getattr(torch_models, name)(device="cpu", **kw)
    cfg = sim.coupled_config()
    F = cfg.fields
    f = sim.state.reshape(9 * F, 128, 128).numpy()
    pieces = list(map(jnp.asarray, _jax_pieces(f)))
    ext = None
    if name == "RocketYeast":
        kernel = make_rocket_yeast_step(
            H=H, nx=128, omega=float(jm.omega), omega_c=float(jm.omega_c),
            lb_G=float(jm.lb_G), lb_Gc=float(jm.lb_Gc),
            epsilon=float(jm.epsilon), rho_o=float(jm.rho_o),
            G_chen=float(jm.G_chen), interpret=True, chunk=CH, k_steps=1)
    else:
        kernel = make_screened_fisher_step(
            H=H, nx=128, omega=float(jm.omega), lb_G=float(jm.lb_G),
            interpret=True, chunk=CH, k_steps=1)
        ext = torch.tensor(0.02 * (np.random.RandomState(3).rand(
            2, 128, 128) - 0.5), dtype=torch.float32)
        pieces.append(jnp.asarray(ext[:, Y0:Y0 + H].numpy()))
    want = np.asarray(kernel(*pieces))
    halo = _halo(f, coupled_reach(cfg))
    got = coupled_sweep_halo_reference(halo, ext, cfg, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    launches = coupled_sweep_halo.launches
    out = coupled_sweep_halo(halo, torch.empty_like(halo.f), ext, cfg, 1)
    assert torch.equal(out, got) and coupled_sweep_halo.launches == launches
