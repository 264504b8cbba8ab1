"""A new configuration and its cell enter the benchmark as new files and
new entries of ``BENCHMARK.json`` alone. In a copy of ``lbbench/`` and
``BENCHMARK.json``, a made-up configuration, ``toy_flow`` (the pipe-flow
channel under another name), brings its configuration, its reference, a
traffic mix, limits, a CPU size and its faults; ``BENCHMARK.json`` gains
its configuration, its cell, and the cell's name in the lists of the
per-layer metrics it reports. The benchmark's own tests then pass on the
toy cell, with as many cases as any cell has, and no file that the copy
had was changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from lbbench import harness

CONFIG, TRAFFIC = "toy_flow", "toy_channel"
CELL = f"{CONFIG}.{TRAFFIC}"
TWIN = "pipe_flow.open_4096"   # the cell whose mix, limits and size it takes

SOURCES = {
    f"lbbench/configs/{CONFIG}.py": (
        '"""A made-up configuration: ``pipe_flow`` under another name."""\n'
        "from lbbench.configs.pipe_flow import (  # noqa: F401\n"
        "    ASSUMED, SOURCE, Cell, inputs, work)\n"),
    # the same module, so that a fault that breaks its step breaks advance
    f"lbbench/reference/{CONFIG}.py": (
        '"""The plain reference of ``toy_flow``: ``pipe_flow``\'s."""\n'
        "import sys\n\n"
        "from lbbench.reference import pipe_flow\n\n"
        "sys.modules[__name__] = pipe_flow\n"),
    f"lbbench/faults/{CONFIG}.py": (
        '"""Faults of ``toy_flow``: ``pipe_flow``\'s velocity faults."""\n'
        "from lbbench.faults.pipe_flow import FAULTS as _PIPE_FLOW\n\n"
        'FAULTS = {"toy_" + name: fault for name, fault in '
        "_PIPE_FLOW.items()}\n"),
}


def _digests(root):
    """Every file under ``root`` by its relative path, with its SHA-256."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _add_toy_cell(copy):
    """The toy's files and ``BENCHMARK.json`` entries; returns the names
    of the per-layer metrics whose lists it joined."""
    for rel, text in SOURCES.items():
        with open(copy / rel, "x") as fh:
            fh.write(text)
    bench = harness.load_json(copy / "BENCHMARK.json")
    twin = harness.cell_spec(TWIN, bench)
    data = {f"lbbench/traffic/{TRAFFIC}.json": f"traffic/{twin['traffic']}",
            f"lbbench/limits/{CELL}.json": f"limits/{TWIN}",
            f"lbbench/tests/tiny/{CELL}.json": f"tests/tiny/{TWIN}"}
    for rel, src in data.items():
        with open(copy / rel, "x") as fh:
            json.dump(harness.load_json(copy / "lbbench" / f"{src}.json"), fh)
    bench["configs"].append({
        "name": CONFIG, "source": next(
            c["source"] for c in bench["configs"] if c["name"] == "pipe_flow"),
        "file": f"lbbench/configs/{CONFIG}.py", "reduced": [],
        "why": "a made-up configuration: pipe_flow under another name"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
        "why": f"a made-up cell: {TWIN}'s mix under another name"})
    joined = []
    for m in bench["per_layer"]:
        if TWIN in m.get("workloads", ()):
            m["workloads"].append(CELL)
            joined.append(m["name"])
    with open(copy / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh, indent=2)
    return joined


def _without_toy(bench, joined):
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    for m in bench["per_layer"]:
        if m["name"] in joined:
            assert m["workloads"][-1] == CELL, m["name"]
            m["workloads"].pop()
    return bench


def _pytest(copy, *args):
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "lbbench/tests", "-q",
         "-p", "no:cacheprovider", *args],
        cwd=copy, env=env, capture_output=True, text=True, timeout=600)


def _cases(node_ids, cell):
    """The node ids whose parameters name ``cell``."""
    return [n for n in node_ids if "[" in n and cell in n.split("[", 1)[1]]


def test_a_new_configuration_enters_as_files(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(harness.BENCH, copy / "lbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy2(harness.ROOT / name, copy / name)
    (copy / "lb2d_tpu_torch").symlink_to(harness.ROOT / "lb2d_tpu_torch")
    before = _digests(copy / "lbbench")
    bench_before = harness.load_json(copy / "BENCHMARK.json")

    joined = _add_toy_cell(copy)
    report = tmp_path / "report.xml"
    run = _pytest(copy, "-k", "toy or contract or span_metrics",
                  f"--junitxml={report}")
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]

    suites = ET.parse(report).getroot().iter("testcase")
    ran = [f"{c.get('classname')}::{c.get('name')}" for c in suites
           if not any(x.tag in ("failure", "error", "skipped") for x in c)]
    toy = _cases(ran, CELL)
    collected = _pytest(copy, "--collect-only").stdout.splitlines()
    assert len(toy) == len(_cases(collected, CELL))
    for w in bench_before["workloads"]:
        assert len(toy) >= len(_cases(collected, w["name"])), w["name"]
    assert any("contract" in n for n in ran)
    assert any("span_metrics" in n for n in ran)

    after = _digests(copy / "lbbench")
    assert {k: after[k] for k in before} == before
    assert _without_toy(harness.load_json(copy / "BENCHMARK.json"),
                        joined) == bench_before
