"""Readings for a cell's correctness limits, in one process on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults half_batch,...] \
        [--fault-seeds 7,8,9] [--look-seeds 4,5,6] [--seconds 10]

For each of --seeds: set-up, a window of --seconds, and the check's numbers
(the program's readings, which set the lower end of each limit). For each
of --control-seeds: the check's numbers with the reference one precision
step below in the program's place (the control). For each fault and each of
--fault-seeds: the run with that fault planted under the timed path. For
each of --look-seeds, where the driver has one: its `look`, the readings
behind the choice of a number compared. One JSON line a reading;
benchmark/run.py never runs this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=ints, default=[])
    ap.add_argument("--look-seeds", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env
    env.prepare(ROOT)
    from benchmark.harness import manifest, runner
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload, ROOT)
    drv = manifest.driver(cell)

    def emit(kind, seed, values, **extra):
        print(json.dumps({"kind": kind, "seed": seed, "values": values,
                          **extra}), flush=True)

    def sound_or_faulty(kind, seed, fault=None):
        program = drv.Program(cell, seed, "cuda", fault=fault)
        records, window_s, _, _, _ = runner.run_window(program, args.seconds)
        checks = program.judge(records)
        emit(kind, seed, {n: v for n, v, _ in checks},
             metrics=program.end_to_end(records, window_s),
             detail=getattr(program, "detail", None))

    for seed in args.seeds:
        sound_or_faulty("program", seed)
    for seed in args.control_seeds:
        program = drv.Program(cell, seed, "cuda")
        records, _, _, _, _ = runner.run_window(program, args.seconds)
        value = program.control(records)
        emit("control", seed, value if isinstance(value, dict)
             else {"embedding_rel_gap_max": value},
             detail=getattr(program, "detail", None))
        del program
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds:
            sound_or_faulty(f"fault:{fault}", seed, fault)
    for seed in args.look_seeds:
        program = drv.Program(cell, seed, "cuda")
        records, _, _, _, _ = runner.run_window(program, args.seconds)
        emit("look", seed, **program.look(records))
        del program
    found = env.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
