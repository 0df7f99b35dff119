"""Profiling / observability utilities (counterpart of
procyon_tpu/utils/profiling.py, on PyTorch).

The reference has no tracing hooks (SURVEY.md §5: per-step wall time prints
+ pynvml GPU memory only, trainIT.py:556,691-702). Here:
  * profiled(): torch.profiler around a block, arranged so that the trace
    keeps every kernel of the block
  * trace(): the same, writing a chrome trace into a directory, which
    utils/trace.device_op_table reads
  * span(): a named range of the host timeline, recorded only while a
    profiler records, so that a trace shows which phase of a call or step
    the host was in beside the kernels it launched
  * count() / counters(): host-side counts that are always kept (tokens a
    call fed to the encoder, and how many of them were not padding)
  * device_memory_stats(): each card's memory in use and its size (the
    pynvml logging equivalent)
"""

import contextlib
import os
import time
from typing import Dict

import torch

from procyon_tpu_torch.utils.trace import LEAD_SPAN


# Two ways a trace lost kernels on an H100 (scripts/probe_trace_window.py).
# (1) A session drops the device records of its first few kernel launches,
# and the few grow with the process's age, about one more every 15 s:
# every kernel of a short block, late in a long run. The cause inside the
# tracer is not known; counted in launches, not in device time, it is met
# by LEAD_LAUNCHES trivial kernels launched first in every session, inside
# a LEAD_SPAN range, which utils/trace leaves out of its table. (2) The
# kernels' timestamps, mapped onto the host clock, now and then land
# milliseconds early, and Kineto keeps a device event only when it starts
# inside the session's window: a margin on both sides of the block.
WINDOW_PAD_S = 0.1
LEAD_LAUNCHES = 256
LEAD_KERNEL = "spin_kernel"                # torch.cuda._sleep's kernel


@contextlib.contextmanager
def profiled(activities=None):
    """torch.profiler.profile around the block (CPU activities, and CUDA
    ones where a card is present, unless `activities` says otherwise).
    With CUDA activities the session first launches LEAD_LAUNCHES trivial
    kernels (LEAD_KERNEL, inside a LEAD_SPAN range), so that the records
    it drops are theirs; then WINDOW_PAD_S of margin, the block, a
    synchronize and WINDOW_PAD_S more. Yields the profiler; read it after
    the block, and leave LEAD_KERNEL out of what it reports."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    on_card = torch.cuda.is_available() \
        and ProfilerActivity.CUDA in activities
    with profile(activities=activities) as prof:
        if on_card:
            with record_function(LEAD_SPAN):
                for _ in range(LEAD_LAUNCHES):
                    torch.cuda._sleep(1000)
        time.sleep(WINDOW_PAD_S)
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (`profiled`) and write its chrome trace to
    `log_dir/trace-<pid>-<ns>.json`, the newest of which
    utils/trace.device_op_table reads."""
    os.makedirs(log_dir, exist_ok=True)
    with profiled() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def span(name: str):
    """A `torch.profiler.record_function(name)` range while a profiler
    records, else one shared null context: with no profiler the cost is a
    flag check, where record_function would cost tens of microseconds. A
    span reads nothing from the device and never synchronizes."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1):
    """Add the host value n to the counter `name` (kept for the process's
    life, with or without a profiler)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of every counter's total."""
    return dict(_COUNTS)


def device_memory_stats() -> Dict[str, float]:
    """Per-card memory in GiB (pynvml logging equivalent,
    trainIT.py:171-172): `cuda:<i>/bytes_in_use_gib` (the caching
    allocator's live bytes) and `cuda:<i>/bytes_limit_gib` (the card's
    size). {} without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}/bytes_in_use_gib"] = \
            stats.get("allocated_bytes.all.current", 0) / 2 ** 30
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}/bytes_limit_gib"] = total / 2 ** 30
    return out
