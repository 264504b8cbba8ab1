"""The comparison that decides ``correct``.

What the timed path produced is held to the plain reference of its
configuration (``lbbench/reference/<config>.py``), worked out in float64:

* ``f_warm``: the populations after the first interval (the warm-up, the
  same ``run(M)`` and readouts as every interval of the window), against
  the reference's M steps from its own initial state, made from the same
  seeded inputs;
* the readouts of interval ``j`` of the window, drawn from the seed: the
  snapshot's fields (one number per group of the reference's
  ``SNAPSHOT_GROUPS``) and the monitoring readout (``mon_win``), against
  the reference's M steps from the program's state before that interval.
  The reference follows the program from the program's own state there;
  ``f_warm`` checks the start, from the reference's own state;
* where the reference has ``HELD_GROUPS``, the planes the program holds
  after interval ``j`` (config 5: the screened-Poisson force K8 wrote at
  the interval's last step), against the reference's own, worked out from
  its state after M - 1 of those steps (``force_win``).

Each number is the widest gap over the cells, ``max |got - want|`` over
``max |want|``. Those compared have a limit of their own
(``lbbench/limits/<workload>.json``), set from the program's readings
over a dozen seeds and the control's (the reference in bfloat16 in the
program's place); a number whose two readings do not separate has none.
"""

import math

import numpy as np
import torch

REF_DTYPE = torch.float64


def rel_gap(got, want) -> float:
    """``max |got - want| / max |want|``, in float64, plane by plane of
    the leading axis so that a large state needs one plane of room."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        den = float(np.max(np.abs(want)))
        return float(np.max(np.abs(got - want))) / den if den else math.inf
    return rel_gap_many([(got, want)])


def rel_gap_many(pairs) -> float:
    """The widest gap over several fields compared together, against the
    largest magnitude among their references."""
    num = den = 0.0
    for got, want in pairs:
        got = got.reshape(-1, *got.shape[-2:]) if got.dim() > 2 else got[None]
        want = (want.reshape(-1, *want.shape[-2:]) if want.dim() > 2
                else want[None])
        for g, w in zip(got, want):
            w = w.to(REF_DTYPE)
            g = g.to(device=w.device, dtype=REF_DTYPE)
            num = max(num, float((g - w).abs().max()))
            den = max(den, float(w.abs().max()))
    return num / den if den else math.inf


def readings(ref, mix, inputs, out, device) -> dict:
    """The numbers compared, for the outputs ``out`` of one run: ``warm``
    (the state after the warm-up interval), ``pre`` (the state before the
    checked interval), ``snap`` (that interval's snapshot), ``mon`` (its
    monitoring readout) and, where the reference has ``HELD_GROUPS``,
    ``held`` (the planes held after it)."""
    M = int(mix["steps_per_interval"])
    values = {}
    f = ref.advance(ref.initial_state(mix, inputs, REF_DTYPE, device), mix, M)
    values["f_warm"] = rel_gap(out["warm"], f)
    del f
    f = ref.advance(out["pre"].to(device=device, dtype=REF_DTYPE), mix, M - 1)
    if out.get("held"):
        want = ref.held(f, mix)
        for name, fields in ref.HELD_GROUPS.items():
            values[name] = rel_gap_many([(out["held"][k], want[k])
                                         for k in fields])
        del want
    f = ref.advance(f, mix, 1)
    want = ref.snapshot(f, mix)
    for name, fields in ref.SNAPSHOT_GROUPS.items():
        values[name] = rel_gap_many([(out["snap"][k], want[k])
                                     for k in fields])
    values["mon_win"] = rel_gap(out["mon"], ref.monitor(f, mix))
    return values


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number that has a limit beside it; a
    number that is missing, not finite or over its limit fails. A reading
    without a limit is not compared (``PERF.md`` says why for each)."""
    checks = {}
    ok = True
    for name in sorted(limits):
        value = values.get(name, math.nan)
        checks[name] = {"value": value, "limit": limits[name]}
        ok = ok and math.isfinite(value) and value <= limits[name]
    return ok, checks


def control_outputs(ref, mix, inputs, j, device, dtype=torch.bfloat16):
    """The control in the program's place: the reference in ``dtype`` from
    the same inputs, through the warm-up interval and the window's
    intervals up to ``j``, with that interval's readouts and held planes
    in ``dtype``."""
    M = int(mix["steps_per_interval"])
    f = ref.advance(ref.initial_state(mix, inputs, dtype, device), mix, M)
    warm = f.clone()
    f = ref.advance(f, mix, j * M)
    pre = f.clone()
    f = ref.advance(f, mix, M - 1)
    held = ref.held(f, mix) if hasattr(ref, "HELD_GROUPS") else {}
    f = ref.advance(f, mix, 1)
    snap = {k: v.float().cpu() for k, v in ref.snapshot(f, mix).items()}
    return {"warm": warm, "pre": pre, "snap": snap, "mon": ref.monitor(f, mix),
            "held": held}
