"""The trace's arithmetic and the per-layer metrics on a made-up trace: the
lead kernels left out, a lost kernel refused, busy and idle time, and every
share of a roofline or of the peak at most 100% when the kernels run at
their least time."""

import pytest

from benchmark.harness import manifest, peaks, runner
from benchmark.harness import trace as tracing
from benchmark.models.esm2 import dims


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def made_up(kernels, *, lead=3, start=1000.0):
    """A trace: `lead` lead kernels in their range, then a window range
    holding the given (name, dur_us) kernels back to back with 10 us gaps,
    each launched from the host."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.LEAD_SPAN,
           "ts": 0, "dur": 100}]
    for i in range(lead):
        ev += [launch(i, -1 - i), kernel("spin_kernel", 200 + i, 1, -1 - i)]
    t = start
    for i, (name, dur) in enumerate(kernels):
        ev += [launch(t - 5, i), kernel(name, t, dur, i)]
        t += dur + 10
    ev.append({"ph": "X", "cat": "user_annotation",
               "name": tracing.WINDOW_SPAN, "ts": start, "dur": t - start})
    return ev


def test_table_leaves_out_lead_and_measures_busy():
    t = tracing.Table(made_up([("a_kernel", 100), ("b_kernel", 300)]))
    assert set(t.by_name) == {"a_kernel", "b_kernel"}
    assert t.window_s == pytest.approx(420e-6)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.matching(["a_"]) == (pytest.approx(1e-4), 1)
    assert t.top_ops()[0][0] == "b_kernel"
    assert len(t.idle_gaps()) == 2


def test_table_refuses_a_lost_kernel():
    ev = made_up([("a_kernel", 100)])
    ev.append(launch(1500, 99))
    with pytest.raises(RuntimeError, match="lost"):
        tracing.Table(ev)


class Cell:
    def __init__(self, config, traffic=None):
        self.config = config
        self.traffic = traffic or {}
        self.per_layer = []


CFG_A = {"hidden_size": 1280, "num_hidden_layers": 33,
         "num_attention_heads": 20, "intermediate_size": 5120,
         "vocab_size": 33, "layer_norm_eps": 1e-5,
         "max_position_embeddings": 1026,
         "layout": {"weights": "w8a8"}, "projector": {"retrieval_dim": 1024}}
CFG_B = dict(CFG_A, hidden_size=2560, num_hidden_layers=36,
             num_attention_heads=40, intermediate_size=10240,
             layout={"weights": "bf16"})
ROWS = [512] * 3 + [300, 120, 40]
UNIT = {"rows": ROWS, "width": 512, "proteins": 5}


@pytest.mark.parametrize("name,cfg,symbol,per_unit", [
    ("roofline.rowblock_attention", CFG_A, "rowblock_attention_kernel", 1),
    ("roofline.flash_attention_fwd.index", CFG_B, "flash_fwd_kernel", 1),
    ("roofline.flash_attention_bwd.mlm", CFG_B, "flash_bwd_dq_kernel", 1),
    ("roofline.fused_ln_mlp_int8", CFG_A, "mlp_up_kernel", 1),
])
def test_roofline_at_least_time_reads_100(name, cfg, symbol, per_unit):
    reader = manifest.metric_reader(name)
    m = dims(cfg)
    args = (ROWS, 512, m) if "fused" not in name else (ROWS, m)
    least_us = reader.least_time(*args) * 1e6
    layers = m["layers"]
    # the least time, split over one launch a layer for two units
    t = tracing.Table(made_up([(symbol, least_us)] * (2 * layers)))
    ctx = runner.Context(Cell(cfg), [UNIT] * 2, 1.0, [UNIT] * 2, t)
    assert reader.read(ctx) == pytest.approx(100.0, rel=1e-6)
    # twice as slow reads half
    t2 = tracing.Table(made_up([(symbol, 2 * least_us)] * (2 * layers)))
    ctx2 = runner.Context(Cell(cfg), [UNIT] * 2, 1.0, [UNIT] * 2, t2)
    assert reader.read(ctx2) == pytest.approx(50.0, rel=1e-6)


def test_roofline_reads_nothing_without_its_kernel():
    reader = manifest.metric_reader("roofline.rowblock_attention")
    t = tracing.Table(made_up([("other_kernel", 10.0)]))
    ctx = runner.Context(Cell(CFG_A), [UNIT], 1.0, [UNIT], t)
    assert reader.read(ctx) is None


def test_mfu_index_at_peak_reads_100():
    reader = manifest.metric_reader("mfu.index")
    for cfg in (CFG_A, CFG_B):
        least = reader.least_time(UNIT, cfg)
        ctx = runner.Context(Cell(cfg), [UNIT] * 3, 3 * least, [], None)
        assert reader.read(ctx) == pytest.approx(100.0)
        assert least > 0


def test_mfu_mlm_at_peak_reads_100():
    reader = manifest.metric_reader("mfu.mlm")
    lora = {"rank": 8, "targets": "default"}
    ops = reader.step_ops(UNIT, CFG_B, lora)
    seconds = 4 * ops / peaks.BF16_FLOPS
    ctx = runner.Context(Cell(CFG_B, {"lora": lora}), [UNIT] * 4, seconds,
                         [], None)
    assert reader.read(ctx) == pytest.approx(100.0)


def test_idle_and_kernel_counts():
    t = tracing.Table(made_up([("a_kernel", 100), ("b_kernel", 300)]))
    ctx = runner.Context(Cell(CFG_A), [UNIT], 1.0, [UNIT, UNIT], t)
    idle = manifest.metric_reader("device_idle_share.index").read(ctx)
    assert idle == pytest.approx(100 * 20 / 420)
    assert manifest.metric_reader("kernels_per_protein.index").read(
        ctx) == pytest.approx(2 / 10)
    assert manifest.metric_reader("kernels_per_step.mlm").read(ctx) == 1.0


def test_kernel_check_holds_launches_to_the_trace():
    cell = Cell(CFG_A)
    cell.per_layer = [{"name": "roofline.fused_ln_mlp_int8"}]
    names = ["ln_quant_rows_kernel", "mlp_up_kernel", "mlp_down_kernel"]
    t = tracing.Table(made_up([(n, 5.0) for n in names * 2]))
    runner.check_kernels(cell, t, {"fused_ln_mlp_int8": 2})
    with pytest.raises(RuntimeError, match="launches"):
        runner.check_kernels(cell, t, {"fused_ln_mlp_int8": 3})
