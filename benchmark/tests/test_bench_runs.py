"""Whole runs of every cell at a tiny size on the CPU (the harness's look
for a card skipped): the result line's keys, the check passing on the
program and failing on every fault the cell can have and on the control."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import manifest, runner
from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
FAULTS = [(w["name"], f) for w in MAN["workloads"]
          for f in manifest.driver(manifest.cell(w["name"])).FAULTS]
SEED = 2 ** 31 + 4321


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_result_line(tiny_root, workload):
    cell = manifest.cell(workload, tiny_root)
    out = runner.run(cell, seed=SEED, seconds=0.5, trace=False,
                     device="cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(tiny_root, workload, fault):
    cell = manifest.cell(workload, tiny_root)
    out = runner.run(cell, seed=SEED, seconds=0.3, trace=False,
                     device="cpu", fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_control_is_not_correct(tiny_root, workload):
    cell = manifest.cell(workload, tiny_root)
    program = manifest.driver(cell).Program(cell, SEED, "cpu")
    records, _, _, _, _ = runner.run_window(program, 0.3, device="cpu")
    value = program.control(records)
    values = value if isinstance(value, dict) else \
        {"embedding_rel_gap_max": value}
    assert any(v > cell.limits[k] for k, v in values.items()), values


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         MAN["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


LOOKS = [w["name"] for w in MAN["workloads"]
         if hasattr(manifest.driver(manifest.cell(w["name"])).Program, "look")]


@pytest.mark.parametrize("workload", LOOKS)
def test_look_sets_the_program_beside_its_witnesses(tiny_root, workload):
    """On the CPU the program runs in f32 and agrees with the f32
    reference; the witness that keeps its state in bf16 departs from the
    f32 reference by far more, and the look names every A slot."""
    cell = manifest.cell(workload, tiny_root)
    program = manifest.driver(cell).Program(cell, SEED, "cpu")
    records, _, _, _, _ = runner.run_window(program, 0.2, device="cpu")
    out = program.look(records)
    worst = out["detail"]["change_worst"][1]
    assert out["values"]["change_norm_gap_median"] < 1e-4
    assert out["state_bf16"]["witness_vs_f32"][1][1] > 100 * worst
    assert out["moments_bf16"]["program"][0] >= 0
    assert all(n.endswith("/A") for n in out["a_slots_step2"])
    assert len(out["a_slots_step2"]) == 6
