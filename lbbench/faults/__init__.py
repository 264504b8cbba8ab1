"""Faults planted in the timed path, to read at a cell's own size on the
card that the check fails them (``lbbench/calibrate.py --faults``).

Each configuration's faults sit in ``faults/<config>.py``, found by name,
as a dict ``FAULTS`` from a fault's name to the fault. A fault breaks
either the program (``program(cell)``, given to ``harness.run_cell`` as
its ``fault``) or the plain reference put in the program's place
(``reference(ref)``, a context in which the reference's step is broken;
``check.control_outputs`` in float32 then stands for the program). Its
``fails`` lists the numbers compared of which it has to fail one. The CPU
tests read each reference fault at a tiny size, and plant faults of their
own there.

``FAULTS`` here gathers every module's, each with its ``config``, the
module's name. Fault names are one namespace across the modules.
"""

import importlib
from pathlib import Path


def _gather() -> dict:
    out = {}
    for path in sorted(Path(__file__).parent.glob("*.py")):
        if path.stem.startswith("_"):
            continue
        module = importlib.import_module(f"{__name__}.{path.stem}")
        for name, fault in module.FAULTS.items():
            if name in out:
                raise ValueError(f"fault {name!r} is both "
                                 f"{out[name]['config']}'s and {path.stem}'s")
            out[name] = dict(fault, config=path.stem)
    return out


FAULTS = _gather()
