"""One run of one cell: set-up, the measured window, the correctness check,
and the result line.

A driver module (benchmark/drivers/<name>.py) gives `Program(cell, seed,
device, fault=None)`, whose construction is the set-up (weights, the
program's own preparation, the warm-up units). Then:
  * `program.first_unit`: the index of the window's first unit;
  * `program.unit(i)`: unit i (a call, a step), ended when its result is
    on the host; returns its record;
  * `program.end_to_end(records, seconds)`: the end-to-end metrics;
  * `program.judge(records)`: frees the program's state and compares what
    the window produced with the reference: [(name, value, limit)].

The window runs units until `seconds` have passed and counts whole units:
its time is from the first unit's start to the last one's end. With
trace=True, `trace_units` units (the mix's) run under the profiler before
the window; the per-layer metrics are read from that trace, its units'
records and the window's.
"""

import gc
import sys
import time

import torch

from benchmark.harness import manifest, trace as tracing

PLATFORM = "gpu"


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def _launch_counts():
    from procyon_tpu_torch.ops import launch_counts
    return launch_counts()


class Context:
    """What a per-layer metric reader sees: the cell, the window's records
    and time, the traced units' records and their trace."""

    def __init__(self, cell, records, seconds, traced, table):
        self.cell = cell
        self.records = records
        self.seconds = seconds
        self.traced = traced
        self.table = table


def run_window(program, seconds, *, trace_units=0, device="cuda"):
    """(records, window seconds, traced records, table, launches in the
    traced units). With trace_units, that many units run under the profiler
    first; the window proper starts after them."""
    i = program.first_unit
    traced, table, launches = [], None, None
    if trace_units:
        from torch.profiler import record_function
        before = _launch_counts()
        with tracing.profiled() as prof:
            with record_function(tracing.WINDOW_SPAN):
                for _ in range(trace_units):
                    traced.append(program.unit(i))
                    i += 1
        after = _launch_counts()
        launches = {k: after[k] - before[k] for k in after}
    records = []
    _sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        records.append(program.unit(i))
        i += 1
    window_s = time.perf_counter() - t0
    if trace_units:
        table = tracing.read(prof)
    return records, window_s, traced, table, launches


def check_kernels(cell, table, launches):
    """Every per-layer metric that reads kernels (its KERNELS: the
    program's launch counter -> the kernel symbols one launch runs) finds
    in the trace one device event of each symbol for each launch the
    program counted in the traced units."""
    for m in cell.per_layer:
        kernels = getattr(manifest.metric_reader(m["name"]), "KERNELS", {})
        for counter, symbols in kernels.items():
            n = launches.get(counter, 0)
            for s in symbols:
                _, seen = table.matching([s])
                if seen != n:
                    raise RuntimeError(
                        f"{m['name']}: {seen} device events of {s} in the "
                        f"trace, {n} launches of {counter}")


def device_fields(device, count, peak):
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    return {"platform": PLATFORM if device != "cpu" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(peak)}


def run(cell, *, seed, seconds, trace, device="cuda", fault=None,
        start=None):
    """The result line's object for one run. start: the process's start on
    the perf_counter clock, so that set-up counts the imports too."""
    t0 = time.perf_counter() if start is None else start
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    drv = manifest.driver(cell)
    program = drv.Program(cell, seed, device, fault=fault)
    _sync(device)
    setup_s = time.perf_counter() - t0
    records, window_s, traced, table, launches = run_window(
        program, seconds,
        trace_units=cell.traffic["trace_units"] if trace else 0,
        device=device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        check_kernels(cell, table, launches)
        ctx = Context(cell, records, window_s, traced, table)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = program.end_to_end(records, window_s)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    attempted, failed = program.attempted(traced + records)
    checks = program.judge(traced + records)
    del program
    gc.collect()
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": device_fields(device, cell.chips, peak)}
    if trace:
        out["device"]["busy_s"] = table.busy_s
        out["device"]["window_s"] = table.window_s
        out["breakdown"] = {"device_ops": table.top_ops(),
                            "idle_gaps": table.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def print_checks(checks, stream=sys.stderr):
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=stream)
