"""Each plain PyTorch op of the port against its ``lb2d_tpu.ops`` counterpart.

Both packages get the same float32 numpy input: a perturbed equilibrium
built as ``PipeFlow`` builds its initial state (feq of a linear density
ramp, times ``1 + eps * randn`` from a numpy seed). The perturbation is
larger than the model's so that the velocity terms are exercised.
Tolerance 2e-7: a few float32 ulp at |f| <= 0.45.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lb2d_tpu.core.lattice import D2Q9
from lb2d_tpu.ops import boundary as jbc
from lb2d_tpu.ops import collide as jcol
from lb2d_tpu.ops import equilibrium as jeq
from lb2d_tpu.ops import moments as jmom
from lb2d_tpu.ops.stream import stream as jax_stream
from lb2d_tpu_torch.ops import boundary as tbc
from lb2d_tpu_torch.ops import collide as tcol
from lb2d_tpu_torch.ops import equilibrium as teq
from lb2d_tpu_torch.ops import moments as tmom
from lb2d_tpu_torch.ops.stream import stream as torch_stream

torch.set_num_threads(1)

TOL = 2e-7
INLET_RHO, OUTLET_RHO, OMEGA = 1.0 + 3.1e-4, 1.0, 0.7


def perturbed_equilibrium(ny=24, nx=40, eps=0.02, seed=0):
    rng = np.random.RandomState(seed)
    ramp = INLET_RHO - np.arange(nx) * ((INLET_RHO - OUTLET_RHO) / float(nx))
    rho0 = np.broadcast_to(ramp[None, :], (ny, nx)).astype(np.float32)
    w = np.asarray(D2Q9.w, np.float32)[:, None, None]
    perturb = (1.0 + eps * rng.randn(9, ny, nx)).astype(np.float32)
    return (w * rho0[None]) * perturb


def obstacle(ny=24, nx=40):
    mask = np.zeros((ny, nx), np.int32)
    mask[8:15, 10:22] = 1
    mask[0, 3] = mask[-1, -1] = 1  # also on a wall and a corner
    return mask


def _close(jax_out, torch_out):
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    torch_out = torch_out if isinstance(torch_out, tuple) else (torch_out,)
    assert len(jax_out) == len(torch_out)
    for a, b in zip(jax_out, torch_out):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        d = float(np.abs(a - b).max())
        assert d <= TOL, d


def _hydro_inputs(f):
    """(rho, u, v) for the feq tests, from the JAX moments."""
    return tuple(np.asarray(x) for x in jmom.hydro_compressible(jnp.asarray(f)))


# name -> (JAX function, torch function, how to build arguments from f)
OPS = {
    "stream": (jax_stream, torch_stream, lambda f: (f,)),
    "density": (jmom.density, tmom.density, lambda f: (f,)),
    "momentum": (jmom.momentum, tmom.momentum, lambda f: (f,)),
    "hydro_compressible": (jmom.hydro_compressible, tmom.hydro_compressible,
                           lambda f: (f,)),
    "hydro_incompressible": (jmom.hydro_incompressible,
                             tmom.hydro_incompressible, lambda f: (f,)),
    "feq_quadratic": (jeq.feq_quadratic, teq.feq_quadratic, _hydro_inputs),
    "feq_incompressible": (jeq.feq_incompressible, teq.feq_incompressible,
                           _hydro_inputs),
    "zou_he_pressure_bcs": (jbc.zou_he_pressure_bcs, tbc.zou_he_pressure_bcs,
                            lambda f: (f, INLET_RHO, OUTLET_RHO)),
    "zou_he_pressure_bcs_incompressible": (
        jbc.zou_he_pressure_bcs_incompressible,
        tbc.zou_he_pressure_bcs_incompressible,
        lambda f: (f, INLET_RHO, OUTLET_RHO)),
    "zou_he_velocity_bcs": (jbc.zou_he_velocity_bcs, tbc.zou_he_velocity_bcs,
                            lambda f: (f, 0.05, 0.04)),
    "zou_he_velocity_inlet_open_outlet": (
        jbc.zou_he_velocity_inlet_open_outlet,
        tbc.zou_he_velocity_inlet_open_outlet, lambda f: (f, 0.05)),
    "bounce_back_obstacle": (jbc.bounce_back_obstacle,
                             tbc.bounce_back_obstacle,
                             lambda f: (f, obstacle())),
}


def _to_jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _to_torch(x):
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", list(OPS))
def test_op_matches_jax(name):
    jfn, tfn, make_args = OPS[name]
    args = make_args(perturbed_equilibrium())
    _close(jfn(*map(_to_jax, args)), tfn(*map(_to_torch, args)))


def test_bgk_matches_jax():
    f = perturbed_equilibrium()
    feq = perturbed_equilibrium(seed=1)
    _close(jcol.bgk(jnp.asarray(f), jnp.asarray(feq), OMEGA),
           tcol.bgk(torch.from_numpy(f), torch.from_numpy(feq), OMEGA))


@pytest.mark.parametrize("name", ["zou_he_pressure_bcs",
                                  "zou_he_pressure_bcs_incompressible"])
def test_pressure_bcs_leave_the_input_untouched(name):
    """Snapshot semantics: the BC writes a new tensor and reads only the
    pre-update values."""
    f = torch.from_numpy(perturbed_equilibrium())
    before = f.clone()
    out = getattr(tbc, name)(f, INLET_RHO, OUTLET_RHO)
    assert torch.equal(f, before)
    assert not torch.equal(out, before)
