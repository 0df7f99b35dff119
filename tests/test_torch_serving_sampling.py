"""Sampled serving, held to the model's own distribution (another random
generator than JAX's, so no token parity), and the batcher's invariants:
the constructor's refusals, a request over max_ctx, reset, the bucket
rule, no position bound read from the device, one host read a round, and
the wave forward's missing pad rows. Builders:
tests/torch_serving_common.py."""

import numpy as np
import pytest

from procyon_tpu.inference import serving as jserving
from procyon_tpu_torch import parallel
from procyon_tpu_torch.inference import serving as tserving
from procyon_tpu_torch.models import llama as tllama
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_serving_common import (
    make_model, make_small_vocab, make_prompts, submit_all, plain_reqs,
    shared_prefix_reqs, mixed_reqs, TEMP, exact_joint)


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def small_vocab():
    return make_small_vocab()


@pytest.mark.parametrize("spec_k", [0, 2], ids=["plain", "speculative"])
def test_sampled_distribution_matches_model(small_vocab, spec_k):
    """Temperature sampling on the device, plain and through the
    rejection-sampling verify with an adversarial constant draft: the joint
    of the first two tokens over N seeded runs against the model's exact
    probabilities. E[TV] is about 3.2 / sqrt(N) = 0.083 at N = 1500 over 64
    cells; a missing correction lands near the draft's acceptance mass,
    0.3 or more."""
    pair = small_vocab
    prompt = [5, 1, 6, 2, 7]
    exact = exact_joint(pair, prompt)
    V = pair.tcfg.vocab_size
    _, tb = pair.batchers(pool=dict(slots=1), spec_k=spec_k,
                          temperature=TEMP)
    kw = dict(draft_fn=lambda history, k, **_: [5] * k) if spec_k else {}
    counts = np.zeros((V, V), np.int64)
    N, accepted_any = 1500, False
    for i in range(N):
        tb.reset(seed=50_000 + i)
        rid = tb.submit(prompt, max_new=3, **kw)
        out = tb.run()[rid]
        counts[out[0], out[1]] += 1
        accepted_any |= tb.spec_stats["emitted"] > tb.spec_stats["rounds"]
    tv = 0.5 * np.abs(counts / N - exact).sum()
    assert tv < 0.17, (tv, counts)
    assert accepted_any == bool(spec_k)


def test_constructor_refusals(model):
    _, tp = model.pcfgs()
    make = lambda **kw: tserving.ContinuousBatcher(
        model.tparams, model.tcfg, tp, device="cpu", **kw)
    with pytest.raises(ValueError, match="spec_quantum=1 only"):
        make(spec_k=3, spec_quantum=2, temperature=0.7)
    with pytest.raises(ValueError, match="prefill_batch needs"):
        make(prefill_batch=2)
    with pytest.raises(ValueError, match="greedy-plain-decode only"):
        make(async_rounds=True, temperature=0.5)
    with pytest.raises(ValueError, match="greedy-plain-decode only"):
        make(async_rounds=True, spec_k=2)
    # a one-rank mesh (no process group) takes the one-process path
    assert make(mesh=parallel.create_mesh()).mesh is None
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tserving.ContinuousBatcher(model.tparams, model.tcfg, tp)  # no card


def test_oversized_request_refused(model):
    jb, tb = model.batchers(pool=dict(max_pages_per_seq=2))   # max_ctx 8
    for b in (jb, tb):
        b.submit(list(range(4, 10)), max_new=8)
        with pytest.raises(ValueError, match="max_ctx"):
            b.run()


def test_reset_clears_state_and_reseeds(model):
    _, tb = model.batchers(prefix_cache=True, temperature=0.8, seed=3)
    reqs = shared_prefix_reqs(41)
    first = [tb.run()[r] for r in [submit_all(tb, reqs)] for r in r]
    tb.reset(seed=3)
    assert not tb.done and not tb.pcache.meta \
        and len(tb.alloc.free) == tb.pcfg.n_pages - 1
    assert not tb.pool["k"].any() and not tb.pool["seq_len"].any()
    rids = submit_all(tb, reqs)
    out = tb.run()
    assert [out[r] for r in rids] == first        # the same seed, again


def test_bucket_is_the_reference_rule():
    for n in (1, 16, 17, 33, 64, 200):
        assert tserving._bucket(n) == jserving._bucket(n)


def test_run_never_reads_a_position_bound_from_the_device(model,
                                                          monkeypatch):
    """The batcher knows every live slot's length on the host and passes
    the bound into every prefill, decode step, verify block and trip:
    paged_forward's read of the device must never run under it."""
    def read_from_device(start, T):
        raise AssertionError("paged_forward read its position bound from "
                             "the device")

    monkeypatch.setattr(tllama, "_position_bound_from_device",
                        read_from_device)
    calls = []
    forward = tllama.paged_forward

    def counting(*a, **kw):
        calls.append(kw.get("max_position"))
        return forward(*a, **kw)

    monkeypatch.setattr(tserving.llama, "paged_forward", counting)
    reqs = mixed_reqs(23) + shared_prefix_reqs(41)
    for kw in ({}, dict(step_quantum=3),
               dict(prefill_chunk=4, prefill_batch=2, prefix_cache=True),
               dict(async_rounds=True, step_quantum=2),
               dict(spec_k=3), dict(spec_k=3, spec_quantum=2),
               dict(temperature=0.7), dict(spec_k=2, temperature=0.7)):
        _, tb = model.batchers(pool=dict(n_pages=96), **kw)
        rids = submit_all(tb, reqs)
        out = tb.run()
        assert all(len(out[r]) == m for r, (_, m, _) in zip(rids, reqs))
    assert calls and all(isinstance(c, int) for c in calls)
    # and the bound is tight enough to mean something: no request here
    # reaches position 48 (max_ctx), far under max_seq_len
    assert max(calls) < 48


def test_one_host_read_per_round_and_wave(model, monkeypatch):
    """A run reads the device once per round (or trip) and once per
    admission wave: every read goes through `_to_host` or, with
    async_rounds, through the round's own event."""
    reads = []
    to_host = tserving.ContinuousBatcher._to_host
    monkeypatch.setattr(tserving.ContinuousBatcher, "_to_host",
                        lambda self, t: reads.append(tuple(t.shape))
                        or to_host(self, t))
    reqs = plain_reqs(3, (5, 11, 3), (6, 5, 7))
    _, tb = model.batchers(step_quantum=2)
    submit_all(tb, reqs)
    tb.run()
    waves = [r for r in reads if len(r) == 1]
    rounds = [r for r in reads if r == (2, 3)]
    assert len(waves) == 1 and waves[0] == (3,)       # one admission wave
    assert len(rounds) == len(reads) - 1 and len(rounds) == 3
    reads.clear()
    _, tb = model.batchers(spec_k=3, spec_quantum=2)
    submit_all(tb, reqs)
    tb.run()
    assert all(r in ((3,), (2, 3, 5)) for r in reads)


def test_wave_forward_has_no_pad_rows_to_overwrite_a_live_slot(model):
    """The reference pads a wave to a power-of-two width and parks the pad
    rows on a slot outside the group. When that slot is live and within a
    chunk of a full page table, the pad rows' writes wrap onto its last
    page and change its tokens (shown here on the reference itself). The
    port's wave is as wide as its group: the live request keeps its solo
    tokens."""
    pool = dict(page_size=8, max_pages_per_seq=2, slots=4)     # max_ctx 16
    kw = dict(prefill_chunk=8, prefill_batch=4)
    rng = np.random.default_rng(0)
    a = make_prompts(rng, [4])[0]
    others = make_prompts(rng, [3, 3, 3])

    def run(b, disturb):
        rid = b.submit(a, max_new=12)          # 16 tokens: the whole table
        if disturb:
            for _ in range(6):                 # a is in its last page now
                b.tick()
            for o in others:                   # a wave of 3: 4 wide there
                b.submit(o, max_new=2)
        return b.run()[rid]

    solo = [run(b, False) for b in model.batchers(pool=pool, **kw)]
    assert solo[0] == solo[1]
    jb, tb = model.batchers(pool=pool, **kw)
    assert run(tb, True) == solo[1]
    assert run(jb, True) != solo[0]            # the reference's fault
