"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
with tiny configurations and mixes (a few layers of width 64, proteins of
tens of residues), which the harness runs on the CPU in f32."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=256, max_position_embeddings=130)
TINY_LENGTHS = {"median": 50, "sigma": 0.7, "min": 10, "max": 300}


def make_tiny_root(dest):
    """A checkout-like tree at dest: BENCHMARK.json and benchmark/, the
    configurations cut to TINY_MODEL, every mix to TINY_LENGTHS and to chunks
    of 62 or 126 residues, the index mixes to 12 proteins a call."""
    dest = Path(dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY_MODEL)
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["lengths"] = TINY_LENGTHS
        mix["max_protein_len"] = 62 if mix["max_protein_len"] < 1000 \
            else 126
        if mix["driver"] == "index":
            mix["proteins"] = 12
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def workloads():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in man["workloads"]]
