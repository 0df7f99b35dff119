"""No module a run imports is JAX's or the JAX package's, by top-level name
compared whole (the port's name, procyon_tpu_torch, begins with the JAX
package's); the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

from benchmark.harness import env
from conftest import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from pathlib import Path
from benchmark.harness import env, manifest, runner
import benchmark.calibrate, benchmark.run
for kind in ("drivers", "metrics"):
    for p in sorted((Path({root!r}) / "benchmark" / kind).glob("*.py")):
        manifest.load_module(kind, p.stem)
from conftest import make_tiny_root
import tempfile
with tempfile.TemporaryDirectory() as d:
    root = make_tiny_root(d)
    man = json.loads((root / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        cell = manifest.cell(w["name"], root)
        runner.run(cell, seed=7, seconds=0.2, trace=False, device="cpu")
print(json.dumps(sorted(sys.modules)))
"""


def test_forbidden_names_compare_whole():
    assert env.forbidden_modules(["procyon_tpu_torch.ops", "numpy"]) == []
    assert env.forbidden_modules(["procyon_tpu.models", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "procyon_tpu"]


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(ROOT), tests=str(ROOT / "benchmark" /
                                                  "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert env.forbidden_modules(modules) == []
    assert "procyon_tpu_torch" in {m.split(".")[0] for m in modules}


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("math", "torch"), (path, n)
