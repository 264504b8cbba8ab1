"""The benchmark loads neither JAX nor the JAX package, and reads nothing
of the JAX package's benchmark (``benchmarks/``, ``bench.py``) or of
``chip_smoke.py``; its plain reference loads nothing of the port.

Module names are compared by their whole top-level name, the part before
the first dot: the port, ``lb2d_tpu_torch``, begins with ``lb2d_tpu``.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from lbbench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]

RUN_CELL = r"""
import json, sys, warnings
opened = []
sys.addaudithook(lambda event, args: event == "open" and opened.append(str(args[0])))
warnings.simplefilter("ignore")
from lbbench.tests import _tiny
result, _ = _tiny.run(sys.argv[1], seconds=0.05, trace=True)
print(json.dumps({"correct": result["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def _child(code, *args):
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_no_jax_and_reads_no_jax_benchmark(workload):
    got = _child(RUN_CELL, workload)
    assert got["correct"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "lb2d_tpu"}
    assert "lb2d_tpu_torch" in got["top"]
    for path in got["opened"]:
        p = pathlib.Path(path).resolve()
        if REPO in p.parents:
            rel = p.relative_to(REPO).as_posix()
            assert not rel.startswith(("benchmarks/", "lb2d_tpu/")), rel
            assert rel not in ("bench.py", "chip_smoke.py"), rel


REFERENCE = r"""
import json, sys
import lbbench.check, lbbench.reference.pipe_flow, lbbench.reference.porous_two_fluid
print(json.dumps({"top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_the_reference_loads_nothing_of_the_port():
    top = set(_child(REFERENCE)["top"])
    assert not top & {"lb2d_tpu_torch", "lb2d_tpu", "jax", "jaxlib"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lb2d_tpu_torch_like", None)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lb2d_tpu.models", None)
    monkeypatch.setitem(sys.modules, "jaxlib", None)
    assert harness.forbidden_modules() == ["jaxlib", "lb2d_tpu"]


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """On the card: one short run of the smallest cell, correct, with the
    card's name in its line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = harness.run_cell("pipe_flow.poiseuille_32x256", 99, 1.0)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
