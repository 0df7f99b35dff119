"""Which kernels a torch.profiler trace loses on the card, and whether
utils/profiling's session keeps them all.

torch.profiler (Kineto, over CUPTI) writes one device event a kernel into
its chrome trace. On an H100 some go missing. This probe launches the
flash forward (csrc/flash_attention_fwd.cu) at the training shape (B2 x
S2048, 32 query and 8 kv heads, D128, causal) `--launches` times a trace
and matches each launch to its kernel's event by correlation id.

The default run traces `--rounds` times in each of four cases: a bare
session (the block straight after the profiler's start, a synchronize,
the stop) and utils/profiling.trace, each with the card idle at the start
and behind a backlog of 50 bf16 8192^3 products queued unsynchronized.
`--watch SECONDS` keeps the card busy with products and every `--every`
seconds traces five ways: bare (with `--wide` seconds of margin on both
sides, so that a kernel whose timestamp lands early stays in the window),
after a throwaway session of one launch, in the active step after a
warm-up step of one launch (torch.profiler's schedule), behind one leading
kernel of about 20 ms in the session, and through utils/profiling.trace.

    python -m procyon_tpu_torch.scripts.probe_trace_window [--rounds 25
        --launches 20]
    python -m procyon_tpu_torch.scripts.probe_trace_window --watch 400
        [--every 20 --wide 0.1]

It prints a JSON line a trace (each launch's kernel start less its launch,
in us, or null where the trace has no event for it) and a summary line.
It needs a card.
"""

import argparse
import glob
import json
import math
import os
import sys
import tempfile
import time

import torch

from procyon_tpu_torch.ops import flash_attention as fa
from procyon_tpu_torch.utils import profiling


def window_summary(path):
    """Kernel and launch counts of a chrome trace, the first kernel's start
    less the first launch's (us), and the kernels' margins to the window's
    start and end (us; the window is the trace's "Trace" span)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    span = [e for e in events if e.get("cat") == "Trace"]
    out = {"kernels": len(kernels), "launches": len(launches)}
    if kernels and launches:
        out["kernel_less_launch_us"] = kernels[0]["ts"] - launches[0]["ts"]
    if kernels and span:
        w0 = span[0]["ts"]
        w1 = w0 + span[0].get("dur", 0)
        out["margin_start_us"] = kernels[0]["ts"] - w0
        out["margin_end_us"] = w1 - kernels[-1]["ts"] - kernels[-1]["dur"]
    return out


def kernel_offsets(path):
    """For each launch of a chrome trace in order: its kernel's start less
    the launch's (us), or None where the trace has no device event for it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    start = {e.get("args", {}).get("correlation"): e["ts"] for e in events
             if e.get("cat") == "kernel" and e.get("ph") == "X"}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    out = []
    for e in launches:
        c = e.get("args", {}).get("correlation")
        out.append(round(start[c] - e["ts"]) if c in start else None)
    return out


def bare_trace(tmp, block, pad_s=0.0, lead_cycles=0):
    """A plain torch.profiler session (CPU and CUDA activities) around the
    block: optionally one leading kernel of `lead_cycles`, `pad_s` of
    margin, the block, a synchronize, `pad_s` more; its chrome trace in
    tmp."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        time.sleep(pad_s)
        block()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    prof.export_chrome_trace(os.path.join(tmp, "t.json"))


def repaired_trace(tmp, block):
    with profiling.trace(tmp):
        block()


def block_losses(tmp, n):
    """(the block's last n launches without a device event, the leading
    launches before them without one, the block's offsets)."""
    offsets = kernel_offsets(glob.glob(os.path.join(tmp, "*.json"))[0])
    lead = len(offsets) - n
    return (sum(o is None for o in offsets[lead:]),
            sum(o is None for o in offsets[:lead]), offsets[lead:])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=25)
    p.add_argument("--launches", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--watch", type=float, default=0.0,
                   help="seconds of the watch instead of the four cases")
    p.add_argument("--every", type=float, default=20.0)
    p.add_argument("--wide", type=float, default=0.1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_trace_window needs a card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v = (torch.randn((2, 2048, H, 128), generator=g, device=dev)
               .to(torch.bfloat16) for H in (32, 8, 8))
    ints = fa.mask_inputs(q, k, None, None, None, None)
    a = torch.randn((8192, 8192), generator=g, device=dev).to(torch.bfloat16)

    def kernel():
        fa.flash_fwd(q, k, v, *ints, causal=True,
                     sm_scale=1.0 / math.sqrt(128), bounded=True,
                     want_lse=True)

    def block():
        for _ in range(args.launches):
            kernel()

    kernel()
    torch.cuda.synchronize()
    if args.watch:
        return watch(args, block, kernel, a)

    def backlog():
        for _ in range(50):
            a @ a

    cases = {"bare, idle": (bare_trace, None),
             "bare, backlog": (bare_trace, backlog),
             "utils/profiling.trace, idle": (repaired_trace, None),
             "utils/profiling.trace, backlog": (repaired_trace, backlog)}
    summary = {name: {"traces": 0, "short": 0, "kernels_lost": 0,
                      "least_kernel_less_launch_us": None}
               for name in cases}
    for _ in range(args.rounds):
        for name, (tracer, before) in cases.items():
            if before is None:
                torch.cuda.synchronize()
            else:
                before()
            with tempfile.TemporaryDirectory() as tmp:
                tracer(tmp, block)
                lost, _, offsets = block_losses(tmp, args.launches)
                res = window_summary(glob.glob(os.path.join(tmp,
                                                            "*.json"))[0])
            print(json.dumps({"case": name, "lost": lost, **res}),
                  flush=True)
            s = summary[name]
            s["traces"] += 1
            s["short"] += lost > 0
            s["kernels_lost"] += lost
            kept = [o for o in offsets if o is not None]
            if kept:
                least = s["least_kernel_less_launch_us"]
                s["least_kernel_less_launch_us"] = min(kept) \
                    if least is None else min(least, min(kept))
    print(json.dumps({"probe_trace_window": summary,
                      "launches_a_trace": args.launches,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


def watch(args, block, kernel, a):
    """The watch: the card kept busy with products (a synchronize every
    ten) between rounds `--every` seconds apart; a round traces the block
    five ways (see the module's docstring). Prints each trace's per-launch
    offsets and the leading launches lost, then the losses by case."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def bare(tmp):
        bare_trace(tmp, block, pad_s=args.wide)

    def warmed(tmp):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            kernel()
            torch.cuda.synchronize()
        bare(tmp)

    def scheduled(tmp):
        def ready(prof):
            prof.export_chrome_trace(os.path.join(tmp, "t.json"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     on_trace_ready=ready,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            kernel()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(args.wide)
            block()
            torch.cuda.synchronize()
            time.sleep(args.wide)
            prof.step()

    def led(tmp):
        bare_trace(tmp, block, pad_s=args.wide, lead_cycles=34_000_000)

    cases = (("bare", bare), ("after a throwaway session", warmed),
             ("a warm-up step first", scheduled),
             ("one 20 ms leading kernel", led),
             ("utils/profiling.trace",
              lambda tmp: repaired_trace(tmp, block)))
    t0 = time.perf_counter()
    lost = {name: {"traces": 0, "short": 0, "kernels_lost": 0}
            for name, _ in cases}
    while time.perf_counter() - t0 < args.watch:
        t = time.perf_counter()
        while time.perf_counter() - t < args.every:
            for _ in range(10):
                a @ a
            torch.cuda.synchronize()
        for name, fn in cases:
            with tempfile.TemporaryDirectory() as tmp:
                fn(tmp)
                n_lost, lead_lost, offsets = block_losses(tmp, args.launches)
            s = lost[name]
            s["traces"] += 1
            s["short"] += n_lost > 0
            s["kernels_lost"] += n_lost
            print(json.dumps({"case": name, "at_s": round(
                time.perf_counter() - t0, 1), "lost": n_lost,
                "leading_lost": lead_lost, "offsets_us": offsets}),
                flush=True)
    print(json.dumps({"probe_trace_window_watch": lost,
                      "every_s": args.every, "margin_s": args.wide,
                      "launches_a_trace": args.launches,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
