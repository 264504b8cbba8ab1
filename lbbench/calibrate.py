"""The readings the limits of ``lbbench/limits/<workload>.json`` are set
from, on the card at the cell's own size, in one process:

* the program's numbers (``lbbench/check.py``) on each of ``--seeds``: the
  warm-up interval and the window's intervals up to the checked one, as a
  run makes them, without timing;
* the control's on each of ``--control-seeds``: the plain reference in
  bfloat16 put in the program's place (``check.control_outputs``), the
  nearest precision below the configuration's float32 (no matrix product
  runs, so TF32 changes nothing);
* each of ``--faults`` (``lbbench/faults.py``) on each of
  ``--fault-seeds``: the program with the fault planted, or the reference
  in float32 in the program's place with its step broken, and whether
  the cell's limits find it not correct.

    python3 lbbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--faults a,b --fault-seeds 7,8,9] \\
        [--out <file.json>]

Prints one JSON line per run and, last, each number's largest program
reading and smallest control and fault readings. A limit lies above the
first and below the second (``PERF.md`` gives both for each limit).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lbbench import check, faults, harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--faults", type=lambda t: [f for f in t.split(",") if f],
                   default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    spec = harness.cell_spec(args.workload)
    mix = harness.load_mix(spec["traffic"])
    cfg = harness.load_config(spec["config"])
    ref = harness.load_reference(spec["config"])
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        values = {}
        harness.run_cell(args.workload, seed, 0.0, device=device,
                         readings=values)
        rows.append({"side": "program", "seed": seed, "values": values,
                     "seconds": time.time() - t0})
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control_seeds:
        t0 = time.time()
        j = harness.check_interval(seed, mix)
        inputs = cfg.inputs(mix, seed, device)
        out = check.control_outputs(ref, mix, inputs, j, device)
        values = check.readings(ref, mix, inputs, out, device)
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append({"side": "control", "seed": seed, "values": values,
                     "seconds": time.time() - t0})
        print(json.dumps(rows[-1]), flush=True)
    limits = harness.load_limits(args.workload)
    for name in args.faults:
        fault = faults.FAULTS[name]
        if fault["config"] != spec["config"]:
            raise ValueError(f"{name} is a fault of {fault['config']}")
        for seed in args.fault_seeds:
            t0 = time.time()
            values = {}
            if "program" in fault:
                result, _ = harness.run_cell(args.workload, seed, 0.0,
                                             device=device,
                                             fault=fault["program"],
                                             readings=values)
                correct = result["correct"]
            else:
                j = harness.check_interval(seed, mix)
                inputs = cfg.inputs(mix, seed, device)
                with fault["reference"](ref):
                    out = check.control_outputs(ref, mix, inputs, j, device,
                                                dtype=torch.float32)
                values = check.readings(ref, mix, inputs, out, device)
                del out
                correct, _ = check.verdict(values, limits)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            rows.append({"side": f"fault:{name}", "seed": seed,
                         "values": values, "correct": bool(correct),
                         "seconds": time.time() - t0})
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    sides = ["program", "control"] + [f"fault:{n}" for n in args.faults]
    for side in sides:
        pick = max if side == "program" else min
        got = [r["values"] for r in rows if r["side"] == side]
        if got:
            summary[side] = {k: pick(v[k] for v in got) for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "rows": rows,
                       "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
