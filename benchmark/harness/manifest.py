"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) joins a configuration file
(`benchmark/configs/<config>.json`), a traffic mix
(`benchmark/traffic/<traffic>.json`, whose `driver` names
`benchmark/drivers/<driver>.py`) and the limits its correctness check holds
the program to (`benchmark/limits/<workload>.json`). Each per-layer metric
is read by `benchmark/metrics/<metric>.py`. Adding a cell, a configuration,
a mix or a metric adds files and entries; no file here changes.
"""

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, workload):
    """Whether a metric entry covers the workload: named in its
    `workloads`, or every cell where it has none."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name, root=ROOT):
    """The cell `name` with its files read."""
    man = load(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bench = Path(root) / "benchmark"
    cfg = _read(bench / "configs" / f"{entry['config']}.json")
    traffic = _read(bench / "traffic" / f"{entry['traffic']}.json")
    limits = _read(bench / "limits" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    per_layer = [m for m in man["per_layer"] if reports(m, name)]
    return Cell(name=name, chips=entry["chips"], config=cfg,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def load_module(kind, name, root=ROOT):
    """benchmark/<kind>/<name>.py as a module (a name may hold dots)."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    key = f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(c: Cell, root=ROOT):
    return load_module("drivers", c.traffic["driver"], root)


def metric_reader(name, root=ROOT):
    return load_module("metrics", name, root)
