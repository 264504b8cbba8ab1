"""The benchmark's ``velocity_inlet`` configuration against its plain
reference (``lbbench/configs/velocity_inlet.py``,
``lbbench/reference/velocity_inlet.py``): the port's
``PipeFlowVelocityInlet`` from the configuration's seeded start at the
cell's CPU size (``lbbench/tests/tiny/``), the reference's grid, mask and
scalars against the port's, each fault of ``lbbench/faults/
velocity_inlet.py`` and the bfloat16 control in the program's place through
``harness.run_cell``, and the reference's imports.

The cases marked ``cuda`` skip without a CUDA device; on the card they run
K2's 32 x 32 tiles with their obstacle branch (``velocity_tile_kernel``).
The file imports no JAX.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbbench import check, faults, harness
from lbbench.faults import velocity_inlet as velocity_faults
from lbbench.tests import _tiny

CELL = "velocity_inlet.cylinder_401"
CONFIG = harness.load_config("velocity_inlet")
REF = harness.load_reference("velocity_inlet")
REPO = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [_tiny.SEED, 7, 2**31 + 99]
FAULTS = sorted(name for name, f in faults.FAULTS.items()
                if f["config"] == "velocity_inlet")

pytestmark = pytest.mark.filterwarnings("ignore:Max Mach number")


def _gaps_after_three_intervals(device, seed):
    """The cell at its CPU size from its seeded start, three intervals of
    the port against the reference in float64: the gap of ``f`` and of each
    group of snapshot fields the benchmark compares (``rho``; ``u`` and
    ``v`` together, against the larger of their magnitudes)."""
    mix = _tiny.mix(CELL)
    cell = CONFIG.Cell(mix, seed, torch.device(device))
    f = REF.initial_state(mix, cell.inputs, torch.float64, device)
    assert check.rel_gap(cell.state(), f) < 1e-6
    for _ in range(3):
        cell.run()
    f = REF.advance(f, mix, 3 * cell.steps_per_interval)
    got = cell.snapshot_buffers()
    cell.snapshot(got)
    want = REF.snapshot(f, mix)
    gaps = {"f": check.rel_gap(cell.state(), f)}
    gaps.update({name: check.rel_gap_many([(got[k], want[k]) for k in group])
                 for name, group in REF.SNAPSHOT_GROUPS.items()})
    return cell, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_the_ports_cpu_path_follows_the_reference(seed):
    cell, gaps = _gaps_after_three_intervals("cpu", seed)
    assert cell.backend == "eager"
    assert set(gaps) == {"f", "rho_win", "uv_win"}
    assert max(gaps.values()) <= 2e-6, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tiles_follow_the_reference_on_the_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lb2d_tpu_torch.ops import fused

    before = fused.temporal_velocity_step.launches
    cell, gaps = _gaps_after_three_intervals("cuda", seed)
    assert cell.backend == "temporal"
    assert cell.cells <= fused.VELOCITY_TILE_MAX_CELLS   # the tiles
    assert cell.sim.obstacle_mask.any()
    assert fused.temporal_velocity_step.launches - before == 3 * 2  # K = 4
    assert max(gaps.values()) <= 2e-6, gaps


@pytest.mark.parametrize("size", ["cell", "tiny"])
def test_the_references_grid_mask_and_scalars_are_the_ports(size):
    spec = harness.cell_spec(CELL)
    mix = harness.load_mix(spec["traffic"])
    if size == "tiny":
        mix = _tiny.mix(CELL)
    sim = CONFIG.Cell(mix, 3, torch.device("cpu")).sim
    u = REF.units(mix)
    assert (u["ny"], u["nx"]) == (sim.ny, sim.nx)
    assert np.array_equal(u["mask"], sim.obstacle_mask.numpy())
    assert u["omega"] == sim.omega and u["u_w"] == sim.u_w
    assert sim.outlet == "zero_gradient" and not sim._incompressible
    d = mix["obstacle"]["diameter"]
    assert u["mask"].sum() == pytest.approx(np.pi * d * d / 4, rel=0.1)
    if size == "cell":
        assert (sim.ny, sim.nx) == (401, 401)
        nu = (1.0 / sim.omega - 0.5) / 3.0
        assert sim.u_w * d / nu == pytest.approx(23.5, abs=0.05)


def run_in_place(name) -> dict:
    """One run of the cell at its CPU size with ``name`` in the program's
    place: a fault of the configuration (the float32 reference with its
    step broken), ``"bfloat16_control"`` or ``"float32_reference"`` (the
    reference in that dtype)."""
    if name in FAULTS:
        planted = faults.FAULTS[name]["program"]
    else:
        dtype = {"bfloat16_control": torch.bfloat16,
                 "float32_reference": torch.float32}[name]
        planted = velocity_faults.reference_in_place(dtype)
    result, _ = _tiny.run(CELL, fault=planted)
    return {"correct": result["correct"],
            "failing": _tiny.failing(result["checks"])}


# the run in a process of its own: the benchmark refuses to measure in a
# process that has loaded JAX, as the tests' conftest does
CHILD = ("import json, sys, warnings\n"
         "sys.path.insert(0, 'tests')\n"
         "warnings.simplefilter('ignore')\n"
         "import test_torch_velocity_inlet_config as t\n"
         "print(json.dumps(t.run_in_place(sys.argv[1])))\n")


def _child(code, *args):
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", FAULTS + ["bfloat16_control"])
def test_a_fault_or_the_control_in_the_programs_place_is_not_correct(fault):
    got = _child(CHILD, fault)
    assert not got["correct"]
    assert got["failing"]
    if fault in faults.FAULTS:
        assert set(faults.FAULTS[fault]["fails"]) & set(got["failing"])


def test_the_float32_reference_in_the_programs_place_is_correct():
    got = _child(CHILD, "float32_reference")
    assert got["correct"], got


def test_the_reference_loads_nothing_of_the_port_or_jax():
    top = set(_child("import json, sys\n"
                     "import lbbench.reference.velocity_inlet\n"
                     "print(json.dumps(sorted({m.split('.')[0] "
                     "for m in sys.modules})))\n"))
    assert "lbbench" in top
    assert not top & {"jax", "jaxlib", "flax", "lb2d_tpu", "lb2d_tpu_torch"}
