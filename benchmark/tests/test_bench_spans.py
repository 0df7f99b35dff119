"""The device's idle time charged to the program's phases (harness/spans.py
and the idle_share.* metrics) on made-up traces: nested and overlapping
spans, a backward's span on another thread, each family's shares adding up
to the device's idle share; the padding share read from the program's
counters; and, on the CPU, the spans the program itself records in a tiny
cell's unit read back through the harness's trace."""

import json

import pytest

from benchmark.harness import manifest, runner, spans
from benchmark.harness import trace as tracing
from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
INDEX_METRICS = [f"idle_share.index.{p}" for p in
                 ("prep", "rotary", "encoder", "to_host", "outside")]
MLM_METRICS = [f"idle_share.mlm.{p}" for p in
               ("to_device", "forward", "backward", "optimizer", "outside")]
LO, HI = 1000, 2000


def host(name, ts, end, *, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "tid": tid}


def table(kernels, ranges):
    """A Table over the window [LO, HI] (us): device kernels at the
    (start, end) intervals, each launched from the host, and the host
    ranges given."""
    ev = [host(tracing.LEAD_SPAN, 0, 100),
          host(tracing.WINDOW_SPAN, LO, HI)]
    for i, (a, b) in enumerate(kernels):
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": a - 5, "dur": 1, "args": {"correlation": i}},
               {"ph": "X", "cat": "kernel", "name": "k", "ts": a,
                "dur": b - a, "args": {"correlation": i}}]
    return tracing.Table(ev + ranges)


def read_all(t, names):
    ctx = runner.Context(None, [], 1.0, [{}], t)
    return {n.rsplit(".", 1)[1]: manifest.metric_reader(n).read(ctx)
            for n in names}


def test_interval_arithmetic():
    xs = spans.merge([(5, 9), (0, 2), (1, 3), (9, 10), (12, 12)])
    assert xs == [(0, 3), (5, 10)]
    assert spans.intersect(xs, [(2, 6), (8, 20)]) == [(2, 3), (5, 6),
                                                       (8, 10)]
    assert spans.subtract(xs, [(1, 2), (4, 6), (9, 30)]) == [
        (0, 1), (2, 3), (6, 9)]
    assert spans.length(xs) == 8


def test_nested_and_overlapping_spans_take_their_idle_time():
    # busy 1000-1100, 1300-1400, 1600-1700: 700 us idle
    t = table([(1000, 1100), (1300, 1400), (1600, 1700)], [
        host("index.call", 1050, 1900),
        host("index.tokenize", 1060, 1150),
        host("index.to_device", 1140, 1200),      # overlaps the tokenize
        host("esm2.rotary", 1250, 1350),          # half of it busy
        host("aten::mul", 1260, 1280, cat="cpu_op"),
        host("index.to_host", 1700, 1800),
    ])
    got = read_all(t, INDEX_METRICS)
    want = {"prep": 100, "rotary": 50, "to_host": 100,
            "encoder": 50 + 200 + 100, "outside": 100}
    assert got == pytest.approx({k: v / 10 for k, v in want.items()})


def test_backward_span_on_another_thread_takes_its_interval():
    t = table([(1000, 1200), (1450, 1500), (1800, 1850)], [
        host("train.to_device", 1000, 1050),
        host("train.step", 1060, 1900),
        host("train.forward", 1060, 1300),
        host("esm2.rotary", 1210, 1230),
        # the backward's range recorded on the autograd engine's thread,
        # an op of it on a third
        host("train.backward", 1300, 1700, tid=7),
        host("MmBackward0", 1350, 1450, tid=8, cat="cpu_op"),
        host("train.optimizer", 1700, 1880),
    ])
    got = read_all(t, MLM_METRICS)
    want = {"to_device": 0, "forward": 100, "backward": 150 + 200,
            "optimizer": 100 + 30 + 20, "outside": 100}
    assert got == pytest.approx({k: v / 10 for k, v in want.items()})


@pytest.mark.parametrize("names,idle", [
    (INDEX_METRICS, "device_idle_share.index"),
    (MLM_METRICS, "device_idle_share.mlm")])
def test_each_family_adds_up_to_the_idle_share(names, idle):
    kernels = [(LO + 37 * i, LO + 37 * i + 11 + i % 5) for i in range(27)]
    ranges = [host(n, 1000 + 13 * i, 1000 + 13 * i + 90 + 7 * (i % 4))
              for i, n in enumerate(
                  ["index.call", "index.tokenize", "esm2.rotary",
                   "index.to_device", "index.to_host", "index.call",
                   "train.step", "train.forward", "train.to_device",
                   "train.backward", "train.optimizer", "train.step"] * 6)]
    t = table(kernels, ranges)
    got = read_all(t, names)
    ctx = runner.Context(None, [], 1.0, [{}], t)
    total = manifest.metric_reader(idle).read(ctx)
    assert min(got.values()) >= 0 and total > 50
    assert sum(got.values()) == pytest.approx(total, abs=1e-6)


def test_a_program_without_spans_reads_nothing():
    t = table([(1000, 1100)], [host("aten::mul", 1200, 1300,
                                    cat="cpu_op")])
    assert set(read_all(t, INDEX_METRICS + MLM_METRICS).values()) == {None}


def test_padding_share_reads_the_counters(monkeypatch):
    from procyon_tpu_torch.utils import profiling
    reader = manifest.metric_reader("padding_share.index")
    monkeypatch.setattr(profiling, "counters", lambda: {
        "index.tokens": 229376, "index.tokens_real": 136095})
    assert reader.read(None) == pytest.approx(100 * (1 - 136095 / 229376))
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert reader.read(None) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(None) is None


def test_new_entries_resolve():
    entries = {m["name"]: m for m in MAN["per_layer"]}
    for family, names in ((spans.INDEX, INDEX_METRICS),
                          (spans.MLM, MLM_METRICS)):
        phases = [p for p, _ in family[1]] + ["outside"]
        assert sorted(n.rsplit(".", 1)[1] for n in names) == sorted(phases)
    for name in INDEX_METRICS + MLM_METRICS + ["padding_share.index"]:
        m = entries[name]
        assert callable(manifest.metric_reader(name).read)
        assert m["unit"] == "%" and m["better"] == "lower"
    for name in INDEX_METRICS + ["padding_share.index"]:
        assert entries[name]["workloads"] == \
            entries["device_idle_share.index"]["workloads"]
    for name in MLM_METRICS:
        assert entries[name]["workloads"] == \
            entries["device_idle_share.mlm"]["workloads"]


@pytest.mark.parametrize("workload,names", [
    ("esm2-650m-w8a8.index-l512", INDEX_METRICS),
    ("esm2-3b-bf16.mlm-lora-l1024", MLM_METRICS)])
def test_the_programs_own_spans_on_the_cpu(tiny_root, workload, names):
    """One unit of a tiny cell under a CPU profiler, read back by the
    harness: no device operation, so the whole window is idle, and every
    phase of the program holds some of it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cell = manifest.cell(workload, tiny_root)
    program = manifest.driver(cell).Program(cell, 11, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.LEAD_SPAN):
            pass
        with record_function(tracing.WINDOW_SPAN):
            program.unit(program.first_unit)
    got = read_all(tracing.read(prof), names)
    assert sum(got.values()) == pytest.approx(100.0, abs=1e-6)
    assert all(v > 0 for k, v in got.items() if k != "outside"), got
