"""roofline.gelu_erf.index on a made-up trace: the bytes it counts for a
call (every row the forward holds, filler rows included, read and written
once in bf16, and the bias), 100% at that least time and 50% at twice it,
and nothing to read without the kernel's launches or the program's
counters."""

import pytest

from benchmark.harness import manifest, peaks, runner
from benchmark.harness import trace as tracing
from benchmark.models.esm2 import dims
from test_bench_metrics import CFG_B, Cell, made_up

NAME = "roofline.gelu_erf.index"
# a call of 124 chunk rows of the 3B index mix, bucketed to 128 x 1,026
UNIT = {"rows": [1026] * 100 + [600] * 24, "width": 1026, "proteins": 112}
REAL = sum(UNIT["rows"])
COUNTERS = {"index.tokens": 3 * 128 * 1026, "index.tokens_real": 3 * REAL}


@pytest.fixture
def counters(monkeypatch):
    from procyon_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTERS))


def test_bytes_of_a_call_count_every_row_held():
    reader = manifest.metric_reader(NAME)
    m = dims(CFG_B)
    assert reader.tokens_held(UNIT, COUNTERS) == pytest.approx(128 * 1026)
    per_layer = 128 * 1026 * 10240 * 4 + 10240 * 2
    assert reader.least_time(128 * 1026, m) == pytest.approx(
        36 * per_layer / peaks.HBM_BYTES_PER_S)


def test_reads_100_at_least_time_and_50_at_twice(counters):
    reader = manifest.metric_reader(NAME)
    m = dims(CFG_B)
    least_us = reader.least_time(128 * 1026, m) / m["layers"] * 1e6
    for factor, want in ((1, 100.0), (2, 50.0)):
        t = tracing.Table(made_up(
            [("void gelu_erf_fwd_kernel<__nv_bfloat16, 8>", factor
              * least_us)] * (2 * m["layers"])
            + [("void gelu_erf_bwd_kernel<__nv_bfloat16, 8>", 5.0)]))
        ctx = runner.Context(Cell(CFG_B), [UNIT], 1.0, [UNIT] * 2, t)
        assert reader.read(ctx) == pytest.approx(want, rel=1e-6)


def test_reads_nothing_without_launches_or_counters(counters, monkeypatch):
    reader = manifest.metric_reader(NAME)
    t = tracing.Table(made_up([("flash_fwd_kernel", 10.0)]))
    ctx = runner.Context(Cell(CFG_B), [UNIT], 1.0, [UNIT], t)
    assert reader.read(ctx) is None
    from procyon_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", dict)
    t = tracing.Table(made_up([("gelu_erf_fwd_kernel", 10.0)]))
    ctx = runner.Context(Cell(CFG_B), [UNIT], 1.0, [UNIT], t)
    assert reader.read(ctx) is None


def test_kernel_check_counts_forward_launches_alone():
    cell = Cell(CFG_B)
    cell.per_layer = [{"name": NAME}]
    t = tracing.Table(made_up([("gelu_erf_fwd_kernel", 5.0)] * 3
                              + [("gelu_erf_bwd_kernel", 5.0)] * 2))
    runner.check_kernels(cell, t, {"gelu_erf": 3, "gelu_erf_bwd": 2})
    with pytest.raises(RuntimeError, match="launches"):
        runner.check_kernels(cell, t, {"gelu_erf": 2})
