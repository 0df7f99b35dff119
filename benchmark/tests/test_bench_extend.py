"""A cell, a configuration, a mix and a per-layer metric are added by new
files and new entries alone: a throwaway cell in a copy of the benchmark,
with no file that was there changed, runs on the CPU and reports its new
metric."""

import hashlib
import json

from benchmark.harness import manifest, runner
from conftest import make_tiny_root

METRIC = '''"""Proteins a call in the traced calls (a throwaway metric)."""


def read(ctx):
    return sum(r["proteins"] for r in ctx.traced) / len(ctx.traced)
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_by_new_files(tmp_path):
    root = make_tiny_root(tmp_path)
    before = digests(root)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "esm2-3b-bf16.json").read_text())
    cfg.update(name="esm2-toy", num_hidden_layers=3)
    (bench / "configs" / "esm2-toy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "index-l512.json").read_text())
    mix.update(proteins=5, max_protein_len=30)
    (bench / "traffic" / "index-short.json").write_text(json.dumps(mix))
    (bench / "limits" / "esm2-toy.index-short.json").write_text(
        json.dumps({"sample": 4, "embedding_rel_gap_max": 1e-3}))
    (bench / "metrics" / "proteins_per_call.toy.py").write_text(METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "esm2-toy", "source": "a test",
                           "file": "benchmark/configs/esm2-toy.json",
                           "reduced": ["num_hidden_layers"], "why": "test"})
    man["workloads"].append({"name": "esm2-toy.index-short",
                             "config": "esm2-toy", "traffic": "index-short",
                             "chips": 1, "why": "test"})
    man["end_to_end"][0]["workloads"].append("esm2-toy.index-short")
    man["per_layer"].append({"name": "proteins_per_call.toy", "unit":
                             "proteins", "better": "higher",
                             "source": "program_counter", "layer": "test",
                             "moves": "proteins_per_s",
                             "workloads": ["esm2-toy.index-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    after = digests(root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == ["BENCHMARK.json"]
    cell = manifest.cell("esm2-toy.index-short", root)
    program = manifest.driver(cell).Program(cell, 99, "cpu")
    records, seconds, _, _, _ = runner.run_window(program, 0.2, device="cpu")
    ctx = runner.Context(cell, records, seconds, records[:1], None)
    reader = manifest.load_module("metrics", "proteins_per_call.toy", root)
    assert reader.read(ctx) == 5
    out = runner.run(cell, seed=99, seconds=0.2, trace=False, device="cpu")
    assert out["correct"] and "proteins_per_s" in out["metrics"]
