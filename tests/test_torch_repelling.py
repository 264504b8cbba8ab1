"""The port's RepellingFisherWave against the JAX one, and its three modes.

Parity: each mode (exact, gated by ``reuse_tolerance``, tracking by
``inner_per_step``) at N = 24, the port started from the JAX model's 5-tuple
state through ``load_numpy_state``, both run 4 outer steps, the port on the
CPU through its eager path; tolerance 5e-7 (tests/test_fused.py), each
member of the state. Then the port alone through the cases of
tests/test_waves.py:64, 214 and 238 with their bounds, the host reads each
mode costs, and the two amortization modes excluding each other.
"""

import numpy as np
import pytest
import torch

import lb2d_tpu.models as jax_models
from lb2d_tpu_torch.models import RepellingFisherWave

torch.set_num_threads(1)

TOL = 5e-7
KW = dict(Lx=1.0, Ly=1.0, E=2.0, R0=0.25, N=24, max_inner_iter=60,
          inner_tolerance=1e-4)
MODES = {"exact": {}, "gated": dict(reuse_tolerance=1e-4),
         "tracking": dict(inner_per_step=2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(mode):
    jax_sim = jax_models.RepellingFisherWave(**KW, **MODES[mode])
    sim = RepellingFisherWave(device="cpu", **KW, **MODES[mode])
    start = tuple(np.asarray(a) for a in jax_sim.state)
    # the port's own initial state is the JAX one (tracking's converged
    # potential within the bar: JAX fuses its loop's arithmetic)
    for a, b in zip(start, sim.state_numpy()):
        assert np.abs(a - b).max() < TOL
    sim.load_numpy_state(start)
    jax_sim.run(4)
    sim.run(4)
    for i, (a, b) in enumerate(zip(jax_sim.state, sim.state_numpy())):
        d = float(np.abs(np.asarray(a) - b).max())
        assert d < TOL, (i, d)
    jf, tf = jax_sim.get_fields(), sim.get_fields()
    for name in ("f", "rho", "u", "v"):
        assert np.abs(jf[name] - tf[name]).max() < TOL, name


def test_repelling_fisher_wave_runs():
    """tests/test_waves.py:214-224: growth and a nonzero velocity."""
    sim = RepellingFisherWave(device="cpu", **KW)
    rho0 = sim.get_fields()["rho"]
    sim.run(50)
    fields = sim.get_fields()
    assert np.isfinite(fields["rho"]).all()
    assert fields["rho"].sum() > rho0.sum()
    assert np.abs(fields["u"]).max() + np.abs(fields["v"]).max() > 0


def test_repelling_fisher_reuse_tolerance():
    """tests/test_waves.py:238-259: a tiny tolerance tracks the exact model;
    a huge one freezes the potential after the first solve."""
    exact = RepellingFisherWave(device="cpu", **KW)
    loose = RepellingFisherWave(device="cpu", reuse_tolerance=1e-4, **KW)
    frozen = RepellingFisherWave(device="cpu", reuse_tolerance=1e9, **KW)
    for sim in (exact, loose, frozen):
        sim.run(30)
    re_ = exact.get_fields()["rho"]
    rl = loose.get_fields()["rho"]
    sc = np.abs(re_).max()
    assert np.abs(re_ - rl).max() / sc < 5e-3, np.abs(re_ - rl).max() / sc
    after_1 = RepellingFisherWave(device="cpu", reuse_tolerance=1e9, **KW)
    after_1.run(1)
    assert torch.equal(frozen.state[2], after_1.state[2])


def test_repelling_fisher_tracking_mode():
    """tests/test_waves.py:262-287: tracking's drift against the exact
    nested solve stays bounded, and a larger budget tracks tighter."""
    kw = dict(KW, max_inner_iter=200, inner_tolerance=1e-5)
    exact = RepellingFisherWave(device="cpu", **kw)
    track1 = RepellingFisherWave(device="cpu", inner_per_step=1, **kw)
    track4 = RepellingFisherWave(device="cpu", inner_per_step=4, **kw)
    for sim in (exact, track1, track4):
        sim.run(40)
    re_ = exact.get_fields()["rho"]
    sc = np.abs(re_).max()
    d1 = np.abs(re_ - track1.get_fields()["rho"]).max() / sc
    d4 = np.abs(re_ - track4.get_fields()["rho"]).max() / sc
    assert d1 < 5e-3, d1
    assert d4 < 2e-3, d4
    assert d4 <= d1 + 1e-7, (d1, d4)


def test_amortization_modes_exclude_each_other():
    with pytest.raises(ValueError, match="mutually exclusive"):
        RepellingFisherWave(device="cpu", inner_per_step=1,
                            reuse_tolerance=1e-4, **KW)
    with pytest.raises(ValueError):
        RepellingFisherWave(device="cpu", inner_per_step=0, **KW)


def test_host_reads_per_outer_step():
    """Exact: one read per block of the solve, ceil(iterations / 10);
    gated: one more for the drift test (the first step solves: the drift
    reference starts at -1); tracking: none, and no converge loop."""
    modes = {"exact": {}, "gated": dict(reuse_tolerance=1e-2),
             "tracking": dict(inner_per_step=2)}
    for mode, kw in modes.items():
        sim = RepellingFisherWave(device="cpu", **KW, **kw)
        for step in range(3):
            reads, iters = sim.host_reads, sim.inner_iterations
            sim.run(1)
            it = sim.inner_iterations - iters
            want = {"exact": -(-it // 10), "gated": 1 + -(-it // 10),
                    "tracking": 0}[mode]
            assert sim.host_reads - reads == want, (mode, step)
            if mode == "exact":
                assert 1 <= it <= KW["max_inner_iter"]
            if mode == "gated" and step == 0:
                assert it > 0
            if mode == "tracking":
                assert it == 0
