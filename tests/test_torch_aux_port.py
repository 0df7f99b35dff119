"""The port's small host modules against the JAX package's on the CPU:
utils/baselines (the same denominators and fields), data/context (the
same context strings, and the port's collator with a port provider giving
the JAX collator's input_ids), data/dataset_tracker (the same `sample`
sequence from the same seed, the to_dict round trip), utils/profiling
(device_memory_stats without a card, trace's chrome trace) and
utils/trace (device_op_table on a chrome trace written here)."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from procyon_tpu.data import collators as jcoll
from procyon_tpu.data import context as jctx
from procyon_tpu.data import datasets as jdata
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.dataset_tracker import DatasetTracker as JTracker
from procyon_tpu.data.text_tokenizer import WordTokenizer as JWordTokenizer
from procyon_tpu.utils import baselines as jbase
from procyon_tpu_torch.data import collators as tcoll
from procyon_tpu_torch.data import context as tctx
from procyon_tpu_torch.data import datasets as tdata
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data.dataset_tracker import DatasetTracker
from procyon_tpu_torch.data.text_tokenizer import WordTokenizer
from procyon_tpu_torch.utils import baselines, profiling, trace


@pytest.mark.parametrize("n_params,batch,rate,serving", [
    (8.03e9, 16, 412.5, True), (6.74e9, 16, 300.0, False),
    (0.9e9, 4, 12.25, False), (5.58e9, 1, 33.0, True)])
def test_baseline_fields_equal_the_references(n_params, batch, rate,
                                              serving):
    assert baselines.baseline_fields(n_params, batch, rate,
                                     serving=serving) == \
        jbase.baseline_fields(n_params, batch, rate, serving=serving)
    assert baselines.a100_decode_tok_per_sec(n_params, batch) == \
        jbase.a100_decode_tok_per_sec(n_params, batch)


def _providers(mod):
    onto = mod.OntologyAncestorContext(
        parents={5: [3, 4], 3: [1], 4: [1, 2], 1: [0]},
        names={3: "kinase activity", 4: "transferase activity",
               1: "catalytic activity", 2: "binding", 0: "molecular"},
        max_ancestors=4)
    desc = mod.EntityDescriptionContext({7: "a rare disease", 5: "x"})
    return [onto, desc, mod.ComposedContext([desc, onto]),
            mod.NullContextProvider()]


@pytest.mark.parametrize("idx", [0, 1, 3, 5, 7, 99])
def test_context_strings_equal_the_references(idx):
    for got, want in zip(_providers(tctx), _providers(jctx)):
        assert got.context("go", idx) == want.context("go", idx)


def test_collator_with_context_gives_the_references_input_ids():
    """After tests/test_context_ppi.py's collator case: the port's QA
    collator with a port provider and the JAX collator with the JAX
    provider give the same input_ids, and the marker is there."""
    text = "distinctivecontextmarker progressive weakness"
    out = []
    for coll, ctx, data, inst, tok_cls in (
            (tcoll, tctx, tdata, tinstruct, WordTokenizer),
            (jcoll, jctx, jdata, jinstruct, JWordTokenizer)):
        store = data.SyntheticStore(embed_dim=32)
        cfg = coll.CollatorConfig(max_text_len=256, protein_embed_dim=32)
        tok = tok_cls()
        task = inst.TaskLibrary().get("omim_all_qa")
        prompt = inst.get_prompt(task, num_examples=1)
        c = coll.QACollator(cfg, tok, store, task,
                            context_provider=ctx.EntityDescriptionContext(
                                {11: text}))
        ids = np.asarray(c([(5, 11, True)], prompt)["input_ids"])
        assert tok.encode("distinctivecontextmarker")[0] in ids[0].tolist()
        out.append(ids)
    np.testing.assert_array_equal(out[0], out[1])


def test_tracker_samples_the_references_sequence():
    budgets = {"go": 120, "reactome": 40, "omim": 7, "empty": 0}
    got, want = DatasetTracker(budgets=dict(budgets)), JTracker(
        budgets=dict(budgets))
    g_rng, w_rng = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(60):
        a, b = got.sample(g_rng), want.sample(w_rng)
        assert a == b
        if a is not None:
            got.record(a, 3)
            want.record(b, 3)
        assert got.probabilities() == want.probabilities()
    assert got.to_dict() == want.to_dict()


def test_tracker_round_trip_and_exhaustion():
    tr = DatasetTracker(budgets={"a": 10, "b": 5}, world_size=4)
    tr.record("a", 3)
    back = DatasetTracker.from_dict(json.loads(json.dumps(tr.to_dict())))
    assert back.to_dict() == tr.to_dict() == JTracker.from_dict(
        tr.to_dict()).to_dict()
    assert back.remaining("a") == 7 and back.world_size == 4
    back.record("a", 7)
    back.record("b", 9)
    assert back.exhausted()
    picks = {DatasetTracker(budgets={"a": 100, "b": 0}).sample(
        np.random.default_rng(0)) for _ in range(20)}
    assert picks == {"a"}


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    # CPU work only: no device kernel in it
    assert trace.device_op_table(str(tmp_path)) == (0.0, [])


def _event(name, dur, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": 0, "dur": dur, "args": args}


@pytest.mark.parametrize("gz", [False, True])
def test_device_op_table_reads_kernel_events(tmp_path, capsys, gz):
    events = [_event("flash_fwd_kernel<128>", 100.0, grid=[132, 1, 1],
                     block=[256, 1, 1]),
              _event("flash_fwd_kernel<128>", 140.0, grid=[132, 1, 1],
                     block=[256, 1, 1]),
              _event("ampere_bf16_gemm", 1000.0),
              _event("aten::mm", 5000.0, cat="cpu_op"),
              {"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}}]
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"traceEvents": [_event("stale", 9.0)]}))
    os.utime(old, (0, 0))
    path = tmp_path / ("new.json.gz" if gz else "new.json")
    blob = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(blob)
    else:
        path.write_text(blob)
    total, rows = trace.device_op_table(str(tmp_path))
    assert total == pytest.approx(1.24)
    assert [(r[1], r[2]) for r in rows] == [(1, "ampere_bf16_gemm"),
                                            (2, "flash_fwd_kernel<128>")]
    assert rows[1][0] == pytest.approx(0.24)
    assert rows[1][3] == "grid [132, 1, 1] block [256, 1, 1]"
    trace.print_op_table(str(tmp_path), top=1)
    out = capsys.readouterr().out
    assert "ampere_bf16_gemm" in out and "flash" not in out
    assert trace.device_op_table(str(tmp_path / "none")) == (0.0, [])


@pytest.mark.parametrize("kept", [(1, 2, 3), (1, 3), ()])
def test_device_op_table_raises_on_lost_kernels(tmp_path, kept):
    """Every launch of the block must have its kernel's device event: a
    trace that lost one raises, and one that holds all is read. The
    profiler's leading kernels (launched inside trace.LEAD_SPAN) may be
    lost and are left out of the table."""
    lead = [dict(_event(trace.LEAD_SPAN, 100.0, cat="user_annotation"),
                 ts=850)]
    lead += [dict(_event("cudaLaunchKernel", 5.0, cat="cuda_runtime",
                         correlation=c), ts=10 * c) for c in (90, 91, 92)]
    lead += [_event("at::cuda::spin_kernel(long)", 1.0, correlation=92)]
    launches = [dict(_event("cudaLaunchKernel", 5.0, cat="cuda_runtime",
                            correlation=c), ts=1000 + c) for c in (1, 2, 3)]
    kernels = [_event("flash_fwd_kernel<128>", 100.0, correlation=c)
               for c in kept]
    (tmp_path / "t.json").write_text(json.dumps(
        {"traceEvents": lead + launches + kernels}))
    if len(kept) == 3:
        total, rows = trace.device_op_table(str(tmp_path))
        assert total == pytest.approx(0.3)
        assert [(r[1], r[2]) for r in rows] == [(3, "flash_fwd_kernel<128>")]
    else:
        with pytest.raises(RuntimeError, match=f"{3 - len(kept)} kernel "
                                               "launches without"):
            trace.device_op_table(str(tmp_path))


def test_probe_trace_window_reads_the_window(tmp_path):
    """scripts/probe_trace_window's reading of a chrome trace: kernels and
    launches counted, the kernels' margins to the "Trace" span's ends, the
    first kernel's start less its launch's, each launch's offset (None
    where its kernel is missing); without a card its main refuses to
    run."""
    from procyon_tpu_torch.scripts import probe_trace_window as probe
    events = [dict(_event("PyTorch Profiler (0)", 1000.0, cat="Trace"),
                   ts=100),
              dict(_event("cudaLaunchKernel", 5.0, cat="cuda_runtime",
                          correlation=1), ts=300),
              dict(_event("cudaLaunchKernel", 5.0, cat="cuda_runtime",
                          correlation=2), ts=320),
              dict(_event("cudaLaunchKernel", 5.0, cat="cuda_runtime",
                          correlation=3), ts=340),
              dict(_event("flash_fwd_kernel<128>", 200.0, correlation=2),
                   ts=250),
              dict(_event("flash_fwd_kernel<128>", 200.0, correlation=3),
                   ts=450)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert probe.window_summary(str(path)) == {
        "kernels": 2, "launches": 3, "kernel_less_launch_us": -50,
        "margin_start_us": 150, "margin_end_us": 450}
    assert probe.kernel_offsets(str(path)) == [None, -70, 110]
    assert probe.block_losses(str(tmp_path), 2) == (0, 1, [-70, 110])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a card"):
            probe.main(["--rounds", "1"])
