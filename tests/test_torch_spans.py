"""The port's spans and counters (utils/profiling.span / count) on the CPU
with tiny configs: the phases a profiler sees inside
training/evaluation.all_protein_target_embeddings and inside an MLM train
step, the padding counters against the bucketed batch they count, and a
span with no profiler costing no record_function."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from procyon_tpu_torch.data.datasets import SyntheticStore
from procyon_tpu_torch.data.protein_tokenizer import (
    PAD_IDX, batch_encode, bucket_protein_batch, mask_for_mlm)
from procyon_tpu_torch.models import esm2, unified
from procyon_tpu_torch.models import lora as lora_mod
from procyon_tpu_torch.training import evaluation
from procyon_tpu_torch.training import optimizer as opt_mod
from procyon_tpu_torch.training import train_step as ts
from procyon_tpu_torch.utils import profiling
from torch_cpu_common import one_torch_thread  # noqa: F401

MAX_LEN = 30                         # residues a row: width 32
N_PROTEINS, BATCH = 10, 6            # two calls: 6 and 4 proteins
INDEX_SPANS = ("index.tokenize", "index.to_device", "esm2.rotary",
               "index.to_host")


def spans_of(prof, names):
    """[(name, start_us, end_us)] of the profiler's ranges named in
    `names`, in order of start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in names]
    return sorted(out, key=lambda s: s[1])


def index_setup():
    esm_cfg = esm2.tiny_config(attn_backend="ref", remat=False)
    cfg = unified.UnifiedConfig(llama=None, esm=esm_cfg, retrieval_dim=16,
                                dtype=torch.float32)
    params = unified.init_params(0, cfg, device="cpu")
    store = SyntheticStore(n_proteins=N_PROTEINS, min_len=10, max_len=80)
    return cfg, params, store


def embed(cfg, params, store):
    return evaluation.all_protein_target_embeddings(
        params, cfg, store, list(range(N_PROTEINS)), batch=BATCH,
        max_protein_len=MAX_LEN, device="cpu")


def test_index_call_holds_its_phases_in_order():
    cfg, params, store = index_setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb = embed(cfg, params, store)
    assert emb.shape == (N_PROTEINS, 16)
    calls = spans_of(prof, ("index.call",))
    assert len(calls) == -(-N_PROTEINS // BATCH)
    inner = spans_of(prof, INDEX_SPANS)
    for _, lo, hi in calls:
        mine = [s for s in inner if lo <= s[1] and s[2] <= hi]
        assert [s[0] for s in mine] == list(INDEX_SPANS)
        # one phase ends before the next starts
        assert all(a[2] <= b[1] for a, b in zip(mine, mine[1:]))
    assert len(inner) == len(INDEX_SPANS) * len(calls)


def test_index_counters_count_the_bucketed_rows():
    cfg, params, store = index_setup()
    seqs = [store.protein_sequence(i) for i in range(N_PROTEINS)]
    assert max(len(s) for s in seqs) > MAX_LEN        # a split protein
    want_all = want_real = real_rows = 0
    for i in range(0, N_PROTEINS, BATCH):
        pb = bucket_protein_batch(batch_encode(seqs[i:i + BATCH],
                                               max_len=MAX_LEN),
                                  width=MAX_LEN + 2)
        want_all += pb.tokens.shape[0] * pb.tokens.shape[1]
        valid = pb.row_valid > 0
        want_real += int((pb.tokens[valid] != PAD_IDX).sum())
        real_rows += int(valid.sum())
    # the 64-row buckets leave empty filler rows, counted as padding
    assert real_rows * (MAX_LEN + 2) < want_all
    before = profiling.counters()
    embed(cfg, params, store)
    after = profiling.counters()

    def added(k):
        return after[k] - before.get(k, 0)
    assert added("index.tokens") == want_all
    assert added("index.tokens_real") == want_real
    # every residue, and a CLS and an EOS a chunk row
    assert want_real == sum(len(s) + 2 * -(-len(s) // MAX_LEN)
                            for s in seqs)


def mlm_setup(accumulation_steps):
    lora = lora_mod.LoRAConfig(rank=2, alpha=2.0, num_experts=2,
                               dtype=torch.float32)
    esm_cfg = esm2.tiny_config(attn_backend="ref", remat=False, lora=lora)
    cfg = unified.tiny_config(esm=esm_cfg)
    opt = opt_mod.build_optimizer(opt_mod.OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=8))
    params = {"esm": esm2.init_params(0, esm_cfg, device="cpu")}
    state = ts.init_train_state(
        params, opt, trainable_predicate=ts.lora_trainable_predicate)
    step = ts.make_train_step(cfg, opt, "mlm", frozen_base=True,
                              accumulation_steps=accumulation_steps)
    store = SyntheticStore(n_proteins=4, min_len=10, max_len=20)
    pb = batch_encode([store.protein_sequence(i) for i in range(4)],
                      max_len=20)
    toks, labels = mask_for_mlm(pb.tokens, np.random.default_rng(0))
    batch = {"protein_tokens": toks, "mlm_labels": labels}
    if accumulation_steps > 1:
        batch = ts.stack_microbatches([batch] * accumulation_steps)
    return state, step, batch


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_train_step_holds_forward_backward_optimizer(accumulation_steps):
    state, step, host = mlm_setup(accumulation_steps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = ts.batch_to_device(host, "cpu")
        state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    names = ("train.to_device", "train.step", "train.forward",
             "train.backward", "train.optimizer")
    seen = spans_of(prof, names)
    (_, to_lo, to_hi), = [s for s in seen if s[0] == "train.to_device"]
    (_, lo, hi), = [s for s in seen if s[0] == "train.step"]
    assert to_hi <= lo
    inner = [s for s in seen if s[0] not in ("train.to_device",
                                             "train.step")]
    assert all(lo <= a and b <= hi for _, a, b in inner)
    order = ["train.forward", "train.backward"] * accumulation_steps + \
        ["train.optimizer"]
    assert [s[0] for s in inner] == order


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("index.call"), profiling.span("train.step")
    assert a is b
    with a:
        with b:
            pass


def test_span_under_a_profiler_records_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("index.call"):
            torch.ones(4) + 1
    assert [s[0] for s in spans_of(prof, ("index.call",))] == ["index.call"]
    # the profiler's flag is down again after the session
    assert profiling.span("index.call") is profiling.span("x")


def test_counters_add_host_values_and_return_a_copy():
    before = profiling.counters().get("test.counter", 0)
    profiling.count("test.counter")
    profiling.count("test.counter", np.int64(4))
    got = profiling.counters()
    assert got["test.counter"] == before + 5
    got["test.counter"] = -1
    assert profiling.counters()["test.counter"] == before + 5
