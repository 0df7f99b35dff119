"""The traced window: torch.profiler around the window's first units, read
back into device operations.

Two ways a trace was seen to lose kernels on an H100, and what `profiled`
does about each (the program's utils/profiling.py found them):
  * a session drops the device records of its first few kernel launches,
    more of them the older the process: LEAD_LAUNCHES trivial kernels go
    first, inside a LEAD_SPAN range that `read` leaves out;
  * a kernel's timestamp, mapped onto the host clock, now and then lands
    milliseconds early, and a device event is kept only when it starts
    inside the session: WINDOW_PAD_S of margin on both sides.
`read` raises when a kernel launched inside the session has no device
event: a table without it would read fast.
"""

import contextlib
import json
import os
import tempfile
import time

import torch

WINDOW_PAD_S = 0.1
LEAD_LAUNCHES = 256
LEAD_SPAN = "benchmark.lead"
WINDOW_SPAN = "benchmark.window"
# device operations: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled():
    """Profile the block on the CPU and the card, after the lead kernels
    and the margin. Yields the profiler; `read` it after the block."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(LEAD_SPAN):
            for _ in range(LEAD_LAUNCHES):
                torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)


def _launches(events):
    return [e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "LaunchKernel" in e.get("name", "")]


def _corr(e):
    return e.get("args", {}).get("correlation")


def _union_s(intervals, lo, hi):
    """Seconds of [lo, hi] covered by the (start, end) microsecond
    intervals."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e6


class Table:
    """The device operations of the traced window.

    kernels: [(name, start_us, dur_us)] of every kernel but the lead ones;
    by_name: {name: [ms, count]}; window_s: the WINDOW_SPAN range's length;
    busy_s: the part of it in which some device operation ran."""

    def __init__(self, events):
        host_ranges = [e for e in events
                       if e.get("cat") == "user_annotation"]
        spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in host_ranges
                 if e.get("name") == LEAD_SPAN]
        lead = {_corr(e) for e in _launches(events)
                if any(a <= e["ts"] <= b for a, b in spans)}
        launched = {_corr(e) for e in _launches(events)} - lead
        device = [e for e in events if e.get("cat") in DEVICE_CATS
                  and _corr(e) not in lead]
        kernels = [e for e in device if e.get("cat") == "kernel"]
        lost = launched - {_corr(e) for e in kernels}
        if lost:
            raise RuntimeError(
                f"{len(lost)} kernel launches without a device event "
                f"({len(kernels)} kernel events): the trace lost them")
        # the host's range (the card's copy of it is "gpu_user_annotation")
        windows = [e for e in host_ranges if e.get("name") == WINDOW_SPAN]
        if len(windows) != 1:
            raise RuntimeError(f"{len(windows)} {WINDOW_SPAN} ranges in the "
                               "trace, expected 1")
        lo = windows[0]["ts"]
        hi = lo + windows[0]["dur"]
        self.window_s = (hi - lo) / 1e6
        self.busy_s = _union_s([(e["ts"], e["ts"] + e.get("dur", 0))
                                for e in device], lo, hi)
        self.kernels = [(e.get("name", "?"), e["ts"], e.get("dur", 0))
                        for e in kernels]
        self.by_name = {}
        for name, _, dur in self.kernels:
            row = self.by_name.setdefault(name, [0.0, 0])
            row[0] += dur / 1e3
            row[1] += 1
        self._device = device
        self._host = [e for e in events if e.get("cat") in
                      ("cpu_op", "user_annotation", "python_function")]
        self._lo, self._hi = lo, hi

    def matching(self, symbols):
        """(seconds, count) of the kernels whose name holds one of the
        symbols (a kernel's name is its demangled signature)."""
        ms, n = 0.0, 0
        for name, (t, c) in self.by_name.items():
            if any(s in name for s in symbols):
                ms += t
                n += c
        return ms / 1e3, n

    def top_ops(self, k=10):
        rows = sorted(self.by_name.items(), key=lambda r: -r[1][0])[:k]
        return [[name, t / 1e3] for name, (t, _) in rows]

    def idle_gaps(self, k=10):
        """The k longest stretches of the window with no device
        operation, each named by the host operation running at its
        start."""
        ivs = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                     for e in self._device)
        gaps, end = [], self._lo
        for a, b in ivs + [(self._hi, self._hi)]:
            if a > end:
                gaps.append((end, min(a, self._hi)))
            end = max(end, b)
            if end >= self._hi:
                break
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for a, b in gaps:
            host = [e for e in self._host
                    if e["ts"] <= a < e["ts"] + e.get("dur", 0)]
            # the innermost host range holding the gap's start
            name = min(host, key=lambda e: e.get("dur", 0))["name"] \
                if host else "host"
            out.append([name, (b - a) / 1e6])
        return out


def read(prof):
    """The profiler's trace as a Table (written to the run's temporary
    directory, read and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    return Table(events)
