"""BENCHMARK.json and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose file is given
in ``configs``, and a traffic mix, read from ``benchmark/traffic/<traffic>
.json``.  A per-layer metric ``<name>`` is read by the module
``benchmark/metrics/<name>.py``.  Adding a cell, a mix or a metric adds
files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec(path=SPEC_FILE):
    with open(path) as f:
        return json.load(f)


def workload(spec, name):
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(spec, name):
    """The configuration's file, as it is run."""
    for c in spec["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name):
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def end_to_end_metrics(spec, cell):
    """The end-to-end metrics the cell reports (``workloads`` absent: all
    cells)."""
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_metrics(spec, cell):
    """The per-layer metrics the cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end_metrics(spec, cell)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in moved:
            out.append(m)
    return out


def metric_reader(name):
    """The module ``benchmark/metrics/<name>.py`` (names may hold dots, so
    it is loaded from its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
