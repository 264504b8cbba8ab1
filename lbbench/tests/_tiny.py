"""Each cell at a size a CPU test run holds: the same configuration and
traffic with a smaller grid and fewer steps per interval. A cell's size is
``tests/tiny/<workload>.json``, found by name as ``limits/<workload>.json``
is: the keys of the traffic mix that it replaces."""

import math
from pathlib import Path

from lbbench import harness

TINY = Path(__file__).resolve().parent / "tiny"
SEED = 2**31 + 4321   # more than 32 signed bits hold


def path(workload) -> Path:
    return TINY / f"{workload}.json"


def size(workload) -> dict:
    """The cell's traffic keys at its CPU size."""
    return harness.load_json(path(workload))


def limits(workload, card_only=False):
    """The cell's limits, without those of the numbers that only the card's
    path gives unless ``card_only``: the planes the program holds (the
    reference's ``HELD_GROUPS``). Config 5's runner on the CPU solves the
    screened-Poisson force inside its eager step and holds none."""
    lim = harness.load_limits(workload)
    if card_only:
        return lim
    ref = harness.load_reference(harness.cell_spec(workload)["config"])
    held = getattr(ref, "HELD_GROUPS", {})
    return {k: v for k, v in lim.items() if k not in held}


def run(workload, seed=SEED, seconds=0.0, trace=False, fault=None,
        card_only=False):
    return harness.run_cell(workload, seed, seconds, trace=trace,
                            device="cpu", mix_override=size(workload),
                            fault=fault, limits=limits(workload, card_only))


def mix(workload):
    spec = harness.cell_spec(workload)
    return dict(harness.load_mix(spec["traffic"]), **size(workload))


def failing(checks):
    """The names of the numbers over their limits."""
    return sorted(k for k, c in checks.items()
                  if not (math.isfinite(c["value"]) and c["value"] <= c["limit"]))
