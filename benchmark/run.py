"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic mix, driver, limits and per-layer metrics are files under
benchmark/ found by name (harness/manifest.py). With --trace 0 the line
holds the cell's end-to-end metrics, with --trace 1 its per-layer metrics,
read from a profiler trace of the mix's `trace_units` units run before the
window and from the window's records. The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device (and breakdown with --trace 1), then `checks`, each number the
correctness check compared beside its limit; the same numbers are the last
lines of standard error.

Exits 2, printing no result, without a CUDA device or with fewer than the
cell asks for, and 3 when a module of JAX or of the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env
    env.prepare(ROOT)
    from benchmark.harness import manifest, runner
    cell = manifest.cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    out = runner.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), start=START)
    found = env.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    runner.print_checks(out["checks"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
