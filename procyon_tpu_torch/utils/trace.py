"""Read a torch.profiler chrome trace (written by utils/profiling.trace)
into a per-kernel device-time table (counterpart of
procyon_tpu/utils/trace.py, which reads a jax.profiler trace's TPU
tracks; here the rows are the trace's CUDA kernel events, `cat` "kernel")."""
import glob
import gzip
import json
import os

# the range utils/profiling.profiled launches its leading kernels in
LEAD_SPAN = "profiling.lead"


def _newest_trace(trace_dir):
    paths = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(
        os.path.join(trace_dir, "*.json.gz"))
    return max(paths, key=os.path.getmtime) if paths else None


def _launches(events):
    """The host's kernel launches in a trace."""
    return [e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "LaunchKernel" in e.get("name", "")]


def _corr(e):
    return e.get("args", {}).get("correlation")


def device_op_table(trace_dir):
    """Return (total_ms, rows) where rows = [(ms, count, name, long_name)]
    sorted by descending device time, aggregated over every kernel event of
    the newest trace in trace_dir (long_name: the launch's grid and block).
    Kernels on several streams may overlap, so the total can exceed the
    wall time: compare kernels, not the total, against it. The leading
    kernels utils/profiling launches inside LEAD_SPAN are left out. Raises
    when a kernel of the block, launched in the trace, has no device event
    in it (the tracer lost it), rather than hand back a table without
    it."""
    path = _newest_trace(trace_dir)
    if path is None:
        return 0.0, []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == LEAD_SPAN]
    lead = {_corr(e) for e in _launches(events)
            if any(a <= e["ts"] <= b for a, b in spans)}
    launched = {_corr(e) for e in _launches(events)} - lead
    kernels = [e for e in events
               if e.get("cat") == "kernel" and _corr(e) not in lead]
    lost = launched - {_corr(e) for e in kernels}
    if lost:
        raise RuntimeError(
            f"{path}: {len(lost)} kernel launches without a device event "
            f"({len(kernels)} kernel events): the trace lost them")
    seen = {}
    for e in kernels:
        nm = e.get("name", "?")
        if nm not in seen:
            args = e.get("args", {})
            seen[nm] = [0.0, 0, f"grid {args.get('grid')} block "
                                f"{args.get('block')}"
                        if "grid" in args else ""]
        seen[nm][0] += e.get("dur", 0) / 1e3
        seen[nm][1] += 1
    total = sum(v[0] for v in seen.values())
    rows = sorted(((d, c, nm, ln) for nm, (d, c, ln) in seen.items()),
                  key=lambda r: -r[0])
    return total, rows


def print_op_table(trace_dir, top=24, long_name_chars=180, header=""):
    total, rows = device_op_table(trace_dir)
    if not rows:
        print("no trace found")
        return
    print(f"total ({header or 'kernels'}): {total:.1f} ms")
    for d, c, nm, ln in rows[:top]:
        print(f"{d:9.2f} ms x{c:4d} {nm}")
        if ln:
            print(f"      {ln[:long_name_chars]}")
