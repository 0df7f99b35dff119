"""BENCHMARK.json against the benchmark's contract: every cell,
configuration, mix, limit and metric resolves by name; names, units and
texts keep to their characters and lengths."""

import json
import re

import pytest

from benchmark.harness import manifest
from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert all(text_ok(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in MAN["configs"]] + \
        [w["name"] for w in MAN["workloads"]] + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MAN["workloads"]:
        assert text_ok(w["why"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert text_ok(c["why"]) and text_ok(c["source"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in MAN["per_layer"]:
        assert text_ok(m["layer"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        mine = [m for m in MAN["end_to_end"]
                if manifest.reports(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert manifest.reports(moved, w), (m["name"], w)
    for w in MAN["workloads"]:
        assert any(manifest.reports(m, w["name"]) for m in MAN["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves(workload):
    cell = manifest.cell(workload)
    entry = next(w for w in MAN["workloads"] if w["name"] == workload)
    conf = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert cell.config["source"] == conf["source"]
    assert cell.config["reduced"] == conf["reduced"]
    manifest.driver(cell)
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]).read)
    assert cell.traffic["trace_units"] >= 1


def test_every_config_and_file_is_used():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/")


def test_file_names_are_made_of_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
