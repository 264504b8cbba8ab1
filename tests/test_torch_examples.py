"""The port's examples (``examples_torch/``) on the CPU.

``poiseuille_verification.run(10)`` (999 steps on 21 x 11) is held to the
JAX script's ``run(10)`` (``examples/poiseuille_verification.py``, loaded
by path): mean profiles within 1e-5 of max|u|. Every other script's
``main`` runs at its smallest size for a few steps on ``device="cpu"`` and
must return finite numbers; ``zoo_drive.main`` must return every row
``ok`` and raise when a model fails. Without matplotlib (as on the GPU
machine) the plotting scripts draw nothing and still return their numbers.
"""

import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from examples_torch import (
    backend_comparison,
    karman_street,
    live_view,
    poiseuille_verification,
    porous_poisson,
    spinodal_decomposition,
    vortex_shedding,
    zoo_drive,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PROFILE_TOL = 1e-5  # of max|u|


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _finite(value):
    """Every number in a nested result is finite."""
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return math.isfinite(value)
    return True


def test_poiseuille_run_matches_the_jax_example():
    jax_sim, jax_y, jax_u = _jax_example("poiseuille_verification").run(10)
    sim, y, mean_u = poiseuille_verification.run(10, device="cpu")
    assert (sim.ny, sim.nx) == (11, 21) and sim.steps_taken == 999
    assert jax_sim.steps_taken == 999
    np.testing.assert_allclose(y, jax_y, rtol=1e-12)
    scale = float(np.abs(np.asarray(jax_u)).max())
    d = float(np.abs(mean_u - np.asarray(jax_u)).max())
    assert d <= PROFILE_TOL * scale, (d, scale)


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["plot", "no-matplotlib"])
def test_poiseuille_main_returns_its_rows(matplotlib, tmp_path, monkeypatch,
                                          capsys):
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "p.png"
    rows = poiseuille_verification.main(str(out), Ns=(6,), device="cpu")
    assert [(r["N"], r["steps"], r["backend"]) for r in rows] == [
        (6, 360, "eager")]
    assert _finite(rows) and rows[0]["mlups"] > 0
    assert out.exists() == matplotlib
    if not matplotlib:
        assert "no plot drawn" in capsys.readouterr().out


def test_backend_comparison_main():
    result = backend_comparison.main(steps=2, device="cpu", N=5, native_N=4)
    assert result["reference"] == backend_comparison.REFERENCE
    assert result["grid"] == [51, 151] and result["backend"] == "eager"
    assert "native_error" not in result
    assert len(result["rows"]) == 2 and _finite(result)
    assert all(v > 0 for v in result["rows"].values())


def test_karman_street_main(tmp_path):
    result = karman_street.main(str(tmp_path), num_frames=2, device="cpu",
                                lx=40, ly=20, d=6, steps_per_frame=3)
    assert result["steps"] == 6 and result["finite"] and _finite(result)
    assert all(pathlib.Path(p).read_bytes()[:4] == b"\x89PNG"
               for p in result["frames"])


def test_vortex_shedding_main(tmp_path):
    result = vortex_shedding.main(str(tmp_path), num_frames=2, device="cpu",
                                  N=6, steps_per_frame=3)
    assert result["steps"] == 6 and result["finite"] and _finite(result)
    assert len(result["frames"]) == 2


@pytest.mark.parametrize("sink", ["html", "terminal"])
def test_live_view_main(sink, tmp_path):
    import io

    out = io.StringIO()
    html = str(tmp_path / "v.html") if sink == "html" else None
    result = live_view.main(html, num_frames=2, device="cpu", ny=16, nx=32,
                            steps_per_frame=2, out=out)
    assert result["steps"] == 4 and _finite(result)
    if html:
        assert result["bytes"] > 0
    else:
        assert "frame 2/2" in out.getvalue()


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["plot", "no-matplotlib"])
def test_spinodal_main(matplotlib, tmp_path, monkeypatch):
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "s.png"
    rows = spinodal_decomposition.main(str(out), n=16, snapshots=(0, 3, 6),
                                       device="cpu")
    assert [r["step"] for r in rows] == [0, 3, 6]
    assert all(r["finite"] for r in rows) and _finite(rows)
    assert rows[-1]["mass"] == pytest.approx(rows[0]["mass"], rel=1e-5)
    assert out.exists() == matplotlib


def test_porous_poisson_main():
    result = porous_poisson.main(size=32, steps=3, device="cpu")
    assert result["mesh"] == [4, 1] and result["devices"] == ["cpu"] * 4
    assert result["finite"] and _finite(result) and result["mlups"] > 0
    assert result["mass0"] == pytest.approx(0.525 * 32 * 32, rel=2e-2)


def test_zoo_drive_every_row_ok():
    rows = zoo_drive.main(steps=2, device="cpu", tiny=True)
    assert len(rows) == len(zoo_drive.zoo(tiny=True)) + 3
    assert all(row[3].startswith("ok") for row in rows), rows
    assert all(row[2] is None or math.isfinite(row[2]) for row in rows)


def test_zoo_drive_raises_when_a_model_fails(monkeypatch, capsys):
    def broken(**kwargs):
        raise FloatingPointError("made to fail")

    monkeypatch.setattr(zoo_drive.M, "Diffusion", broken)
    with pytest.raises(RuntimeError, match="Diffusion"):
        zoo_drive.main(steps=1, device="cpu", tiny=True)
    out = capsys.readouterr().out
    assert "FAIL: FloatingPointError: made to fail" in out
    assert "21/22 families ok" in out  # the rest was still driven
