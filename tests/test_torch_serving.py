"""The port's ContinuousBatcher against procyon_tpu's on the same bridged
weights: f32 on the CPU, greedy, tokens equal request by request in every
serving mode, with equal `waste`, `spec_stats` and page accounting. One
parametrised case per mode. Sampled decoding has no token parity with JAX
(another random generator): it is held to the model's own distribution.

Also: the constructor's refusals, and that a whole run never reads a
position bound back from the device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.inference import serving as jserving
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import lora as jlora
from procyon_tpu_torch import bridge
from procyon_tpu_torch.inference import kv_pool as tkv
from procyon_tpu_torch.inference import serving as tserving
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import lora as tlora


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    if jcfg.lora is not None:
        fields["lora"] = tlora.LoRAConfig(
            rank=jcfg.lora.rank, alpha=jcfg.lora.alpha,
            num_experts=jcfg.lora.num_experts, dtype=torch.float32)
    return tllama.LlamaConfig(**fields)


class Pair:
    """One model in both packages, and batchers over it."""

    def __init__(self, jcfg, params):
        self.jcfg, self.params = jcfg, params
        self.tcfg = _port_cfg(jcfg)
        self.tparams = bridge.to_torch(params)

    def pcfgs(self, **kw):
        base = dict(n_layers=self.jcfg.n_layers,
                    n_kv_heads=self.jcfg.n_kv_heads,
                    head_dim=self.jcfg.head_dim, page_size=4, n_pages=64,
                    max_pages_per_seq=12, slots=3)
        base.update(kw)
        return (jkv.PagedConfig(dtype=jnp.float32, **base),
                tkv.PagedConfig(dtype=torch.float32, **base))

    def batchers(self, pool=None, **kw):
        jp, tp = self.pcfgs(**(pool or {}))
        return (jserving.ContinuousBatcher(self.params, self.jcfg, jp, **kw),
                tserving.ContinuousBatcher(self.tparams, self.tcfg, tp,
                                           device="cpu", **kw))


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False)
    return Pair(jcfg, jllama.init_params(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def lora_model():
    jcfg = jllama.tiny_config(
        attn_backend="ref", remat=False,
        lora=jlora.LoRAConfig(rank=4, num_experts=3, dtype=jnp.float32))
    params = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(67)       # B starts at 0: make it count
    for name in ("lora_wq", "lora_wv"):
        b = params["layers"][name]["B"]
        params["layers"][name]["B"] = jnp.asarray(
            rng.standard_normal(b.shape) * 0.1, b.dtype)
    return Pair(jcfg, params)


@pytest.fixture(scope="module")
def int4_model():
    """Wide enough for int4 groups of 64 (dim 256), quantized in JAX and
    bridged, so both sides hold the same bytes."""
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False, dim=256,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              vocab_size=384)
    params = jllama.init_params(jax.random.PRNGKey(8), jcfg)
    return Pair(jcfg, jllama.quantize_params(params, jcfg, bits=4, group=64))


def _prompts(rng, lengths, vocab=256):
    return [list(map(int, rng.integers(4, vocab, n))) for n in lengths]


def _embeds(rng, n, dim=64):
    return rng.standard_normal((n, dim)).astype(np.float32) * 0.3


def _submit(b, reqs):
    """reqs: (prompt or embeds, max_new, kwargs)."""
    rids = []
    for what, max_new, kw in reqs:
        if isinstance(what, np.ndarray):
            rids.append(b.submit_fused(what, max_new=max_new, **kw))
        else:
            rids.append(b.submit(what, max_new=max_new, **kw))
    return rids


def _assert_same_state(jb, tb):
    assert tb.waste == jb.waste
    assert tb.spec_stats == jb.spec_stats
    assert sorted(tb.alloc.free) == sorted(jb.alloc.free)
    assert not tb.live and not tb.queue and not tb._inflight
    if jb.pcache is not None:
        assert tb.pcache.stats == jb.pcache.stats
        assert sorted(tb.pcache.meta) == sorted(jb.pcache.meta)
    # dead slots sit on the null row with length 0, as in the reference
    np.testing.assert_array_equal(tb.pool["seq_len"].numpy(),
                                  np.asarray(jb.pool["seq_len"]))
    np.testing.assert_array_equal(tb.pool["page_table"].numpy(),
                                  np.asarray(jb.pool["page_table"]))


def _run_both(pair, reqs, pool=None, **kw):
    jb, tb = pair.batchers(pool=pool, **kw)
    jr, tr = _submit(jb, reqs), _submit(tb, reqs)
    jo, to = jb.run(), tb.run()
    assert len(to) == len(reqs)
    for a, b in zip(jr, tr):
        assert to[b] == jo[a], (b, to[b], jo[a])
    _assert_same_state(jb, tb)
    return [to[r] for r in tr], jb, tb


def _plain(seed, lengths, max_new):
    rng = np.random.default_rng(seed)
    return [(p, m, {}) for p, m in zip(_prompts(rng, lengths), max_new)]


def _shared_prefix(seed, prefix_len=13, tails=(4, 7, 2, 5),
                   max_new=(5, 3, 6, 4)):
    rng = np.random.default_rng(seed)
    prefix = _prompts(rng, [prefix_len])[0]
    return [(prefix + t, m, {})
            for t, m in zip(_prompts(rng, tails), max_new)]


def _mixed(seed):
    rng = np.random.default_rng(seed)
    reqs = [(p, m, {}) for p, m in zip(_prompts(rng, (8, 3, 9, 5)),
                                       (6, 7, 4, 5))]
    return reqs + [(_embeds(rng, 7), 5, {})]


def _fused_shared(seed):
    rng = np.random.default_rng(seed)
    prefix = _embeds(rng, 9)
    return [(np.concatenate([prefix, _embeds(rng, t)]), 5, {})
            for t in (3, 6, 2)]


def _eviction_reqs(seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(3):
        prefix = _prompts(rng, [9])[0]
        for t in (3, 5):
            reqs.append((prefix + _prompts(rng, [t])[0], 4, {}))
    return reqs


# mode -> (requests, pool overrides, batcher options)
MODES = {
    "solo_vs_batched": (_plain(0, (5, 11, 3), (6, 6, 6)), {}, {}),
    "staggered_admission": (_plain(1, (7, 4, 9, 5), (3, 8, 5, 4)),
                            dict(slots=2, n_pages=16), {}),
    "step_quantum_2": (_plain(3, (5, 11, 3), (6, 5, 7)), {},
                       dict(step_quantum=2)),
    "step_quantum_4": (_plain(3, (5, 11, 3), (6, 5, 7)), {},
                       dict(step_quantum=4)),
    "small_pool_many_requests": (
        _plain(11, (3, 9, 11, 4, 7, 5, 10, 6, 8, 3),
               (2, 7, 3, 6, 5, 4, 2, 7, 3, 5)),
        dict(slots=2, n_pages=24), dict(step_quantum=3)),
    "kv8_pool": (_plain(13, (6, 10, 4), (9, 6, 5)),
                 dict(quantize_kv=True), {}),
    "chunked": (_mixed(23), {}, dict(prefill_chunk=4)),
    "bucketed": (_mixed(23), {}, {}),
    "long_prompt_flash_route": (_plain(25, (21, 18, 5), (4, 5, 3)), {}, {}),
    "wave_prefill": (_mixed(83), dict(slots=4), dict(prefill_chunk=4,
                                                     prefill_batch=3)),
    "wave_prefix_same_wave_duplicates": (
        [(_prompts(np.random.default_rng(97), [11])[0], 4, {})] * 3,
        dict(slots=2, n_pages=48),
        dict(prefill_chunk=4, prefill_batch=2, prefix_cache=True)),
    "wave_with_quantum": (_plain(101, (7, 5, 10), (5, 5, 5)), {},
                          dict(prefill_chunk=4, prefill_batch=3,
                               step_quantum=2)),
    "prefix_cache_tokens": (_shared_prefix(41), dict(slots=2, n_pages=48),
                            dict(prefix_cache=True)),
    "prefix_cache_chunked": (_shared_prefix(41), dict(slots=2, n_pages=48),
                             dict(prefix_cache=True, prefill_chunk=4)),
    "prefix_cache_fused": (_fused_shared(43), dict(slots=2, n_pages=48),
                           dict(prefix_cache=True)),
    "prefix_cache_kv8": (_shared_prefix(47, max_new=(4, 5, 3, 6)),
                         dict(slots=2, n_pages=48, quantize_kv=True),
                         dict(prefix_cache=True)),
    "prefix_cache_eviction": (
        _eviction_reqs(59),
        dict(slots=2, n_pages=12, max_pages_per_seq=6),
        dict(prefix_cache=True)),
    "prefix_cache_spec": (_shared_prefix(53, tails=(4, 6), max_new=(6, 7)),
                          dict(slots=2, n_pages=48),
                          dict(prefix_cache=True, spec_k=3)),
    "async_rounds_q1": (_plain(103, (6, 4, 9, 5, 7), (4, 9, 3, 6, 5)),
                        dict(slots=2, n_pages=32), dict(async_rounds=True)),
    "async_rounds_q3": (_plain(103, (6, 4, 9, 5, 7), (4, 9, 3, 6, 5)),
                        dict(slots=2, n_pages=32),
                        dict(async_rounds=True, step_quantum=3)),
    "async_kv8": (_plain(104, (6, 4, 9), (5, 8, 4)),
                  dict(slots=2, n_pages=32, quantize_kv=True),
                  dict(async_rounds=True, step_quantum=2)),
    "async_wave_prefix": (
        _shared_prefix(109, prefix_len=9, tails=(4, 7, 3),
                       max_new=(5, 5, 5)),
        dict(slots=2, n_pages=48),
        dict(async_rounds=True, step_quantum=2, prefix_cache=True,
             prefill_chunk=4, prefill_batch=2)),
    "async_waste_churn": (_plain(11, (5,) * 6, (2, 5, 3, 4, 5, 2)),
                          dict(slots=2),
                          dict(async_rounds=True, step_quantum=4)),
    "sync_waste_churn": (_plain(11, (5,) * 6, (2, 5, 3, 4, 5, 2)),
                         dict(slots=2), dict(step_quantum=4)),
    "spec_k_host_drafts": (_plain(5, (6, 11, 4, 9), (8, 5, 12, 7)),
                           dict(slots=2), dict(spec_k=3)),
    "spec_k_kv8": (_plain(13, (6, 10), (9, 6)), dict(quantize_kv=True),
                   dict(spec_k=3)),
    "spec_k_fused": ([(_embeds(np.random.default_rng(9), n), 7, {})
                      for n in (5, 9)], {}, dict(spec_k=3)),
    "spec_quantum_2": (_plain(41, (6, 11, 4, 9), (8, 5, 12, 7)),
                       dict(slots=2), dict(spec_k=3, spec_quantum=2)),
    "spec_quantum_4": (_plain(41, (6, 11, 4, 9), (8, 5, 12, 7))
                       + [(_embeds(np.random.default_rng(42), 7), 6, {})],
                       dict(slots=2), dict(spec_k=3, spec_quantum=4)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_equal_reference(model, mode):
    reqs, pool, kw = MODES[mode]
    out, jb, tb = _run_both(model, reqs, pool=pool, **kw)
    if kw.get("prefix_cache"):
        assert tb.pcache.stats["hit_tokens"] > 0
    if kw.get("spec_k"):
        assert tb.spec_stats["emitted"] >= tb.spec_stats["rounds"] > 0
    if mode.endswith("waste_churn"):
        assert tb.waste["dropped"] > 0
    if mode == "wave_prefix_same_wave_duplicates":
        assert out[0] == out[1] == out[2]
    if mode == "prefix_cache_eviction":
        assert tb.pcache.stats["evicted"] > 0 or len(tb.pcache.meta) <= 6
        assert all(m["ref"] == 0 for m in tb.pcache.meta.values())


def test_chunked_equals_bucketed_and_wave(model):
    """The port's three prefill modes against each other (the chunk
    boundaries and the wave grouping are the reference's)."""
    outs = []
    for kw in ({}, dict(prefill_chunk=4),
               dict(prefill_chunk=4, prefill_batch=3)):
        _, tb = model.batchers(pool=dict(slots=4), **kw)
        rids = _submit(tb, _mixed(23))
        out = tb.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1] == outs[2]


def test_int4_weights_tokens_equal_reference(int4_model):
    """Every matmul of the decoder on packed int4 leaves (the plain version
    of the kernel on the port's side, the dequantize route on the
    reference's), through plain rounds and speculative rounds."""
    rng = np.random.default_rng(19)
    reqs = [(p, m, {}) for p, m in zip(_prompts(rng, (6, 19, 4), vocab=384),
                                       (7, 5, 9))]
    plain, _, _ = _run_both(int4_model, reqs, step_quantum=2)
    spec, _, _ = _run_both(int4_model, reqs, spec_k=3)
    assert spec == plain


def test_eos_stops_early(model):
    probe, _, _ = _run_both(model, [([5, 6, 7], 1, {})])
    eos = probe[0][0]
    for kw in ({}, dict(step_quantum=2, async_rounds=True)):
        out, _, _ = _run_both(model, [([5, 6, 7], 16, dict(eos_id=eos))],
                              **kw)
        assert out[0] == [eos]


@pytest.mark.parametrize("kw", [dict(spec_k=4),
                                dict(spec_k=2, spec_quantum=3)],
                         ids=["round", "trip"])
def test_spec_eos_mid_accept(model, kw):
    plain, _, _ = _run_both(model, [([5, 6, 7], 10, {})])
    eos = plain[0][3]
    want = plain[0][:plain[0].index(eos) + 1]
    out, _, _ = _run_both(model, [([5, 6, 7], 10, dict(eos_id=eos))], **kw)
    assert out[0] == want


def test_churn_mid_flight(model):
    """Requests joining and leaving mid-flight, driven tick by tick on both
    sides with the same arrival schedule."""
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, (6, 4, 9, 5, 7))
    lens = [4, 9, 3, 6, 5]
    arrive = [0, 0, 2, 3, 6]
    for kw in ({}, dict(step_quantum=2, async_rounds=True)):
        jb, tb = model.batchers(pool=dict(slots=2, n_pages=32), **kw)
        rids = {}
        for tick in range(200):
            for i, at in enumerate(arrive):
                if at == tick:
                    rids[i] = (jb.submit(prompts[i], max_new=lens[i]),
                               tb.submit(prompts[i], max_new=lens[i]))
            jb.tick()
            tb.tick()
            assert sorted(tb.live) == sorted(jb.live)
            assert sorted(tb.done) == sorted(jb.done)
            if len(tb.done) == len(prompts) and not tb._inflight:
                break
        else:
            pytest.fail("the serving loop did not converge")
        for i in range(len(prompts)):
            assert tb.done[rids[i][1]] == jb.done[rids[i][0]]
        assert tb.waste == jb.waste


def test_oracle_drafts_accept_in_full(model):
    """A per-request draft_fn that proposes the true continuation: every
    verify round accepts all K+1 tokens; an always-wrong one emits exactly
    one a round. Both equal plain greedy."""
    prompt = [5, 9, 13, 21]
    plain, _, _ = _run_both(model, [(prompt, 13, {})])
    G = plain[0]

    def true_oracle(history, k, **kw):
        e = len(history) - len(prompt)
        return (G[e:e + k] + [0] * k)[:k]

    def wrong_oracle(history, k, **kw):
        return [(t + 1) % 256 for t in true_oracle(history, k)]

    out, _, tb = _run_both(model, [(prompt, 13, dict(draft_fn=true_oracle))],
                           spec_k=3)
    assert out[0] == G and tb.spec_stats == {"rounds": 3, "emitted": 12}
    out, _, tb = _run_both(model,
                           [(prompt, 13, dict(draft_fn=wrong_oracle))],
                           spec_k=3)
    assert out[0] == G and tb.spec_stats == {"rounds": 12, "emitted": 12}


LORA_MODES = {
    "mixed_experts": (dict(slots=4), {}, (5, 7, 4, 6), (0, 1, 2, 1)),
    "quantum": ({}, dict(step_quantum=3), (6, 4, 8), (2, 0, 1)),
    "spec": ({}, dict(spec_k=2), (6, 4, 8), (2, 0, 1)),
    "spec_trip": ({}, dict(spec_k=2, spec_quantum=2), (6, 4, 8), (2, 0, 1)),
    "wave": ({}, dict(prefill_chunk=4, prefill_batch=3), (7, 5, 10),
             (1, 2, 0)),
    "slot_reuse_resets_expert": (dict(slots=1), {}, (5, 7), (2, 0)),
}


@pytest.mark.parametrize("mode", sorted(LORA_MODES))
def test_lora_experts_equal_reference(lora_model, mode):
    pool, kw, lengths, experts = LORA_MODES[mode]
    rng = np.random.default_rng(71)
    reqs = [(p, 5, dict(lora_expert=e))
            for p, e in zip(_prompts(rng, lengths), experts)]
    out, _, _ = _run_both(lora_model, reqs, pool=pool, **kw)
    # each request equals its solo run under its own expert
    for (p, m, rkw), got in zip(reqs, out):
        _, tb = lora_model.batchers(pool=pool)
        rid = tb.submit(p, max_new=m, **rkw)
        assert tb.run()[rid] == got


def test_lora_prefix_cache_isolates_experts(lora_model):
    prompt = _prompts(np.random.default_rng(83), [13])[0]
    reqs = [(prompt, 6, dict(lora_expert=e)) for e in (1, 2, 1)]
    out, _, tb = _run_both(lora_model, reqs, pool=dict(slots=1, n_pages=48),
                           prefix_cache=True)
    assert out[0] == out[2]
    # only the same-expert repeat may hit the cached chain
    assert tb.pcache.stats["hit_tokens"] == 12


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
    with pytest.raises(NotImplementedError, match="mesh"):
        make(mesh=object())
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
    reqs = _shared_prefix(41)
    first = [tb.run()[r] for r in [_submit(tb, reqs)] for r in r]
    tb.reset(seed=3)
    assert not tb.done and not tb.pcache.meta \
        and len(tb.alloc.free) == tb.pcfg.n_pages - 1
    assert not tb.pool["k"].any() and not tb.pool["seq_len"].any()
    rids = _submit(tb, reqs)
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
    reqs = _mixed(23) + _shared_prefix(41)
    for kw in ({}, dict(step_quantum=3),
               dict(prefill_chunk=4, prefill_batch=2, prefix_cache=True),
               dict(async_rounds=True, step_quantum=2),
               dict(spec_k=3), dict(spec_k=3, spec_quantum=2),
               dict(temperature=0.7), dict(spec_k=2, temperature=0.7)):
        _, tb = model.batchers(pool=dict(n_pages=96), **kw)
        rids = _submit(tb, reqs)
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
    reqs = _plain(3, (5, 11, 3), (6, 5, 7))
    _, tb = model.batchers(step_quantum=2)
    _submit(tb, reqs)
    tb.run()
    waves = [r for r in reads if len(r) == 1]
    rounds = [r for r in reads if r == (2, 3)]
    assert len(waves) == 1 and waves[0] == (3,)       # one admission wave
    assert len(rounds) == len(reads) - 1 and len(rounds) == 3
    reads.clear()
    _, tb = model.batchers(spec_k=3, spec_quantum=2)
    _submit(tb, reqs)
    tb.run()
    assert all(r in ((3,), (2, 3, 5)) for r in reads)


# -- sampled decoding: held to the model's distribution ----------------------

TEMP = 0.9


@pytest.fixture(scope="module")
def small_vocab():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False, vocab_size=8)
    return Pair(jcfg, jllama.init_params(jax.random.PRNGKey(2), jcfg))


def _exact_joint(pair, prompt):
    """The model's exact distribution of the first two sampled tokens."""
    V = pair.tcfg.vocab_size

    def probs(rows):
        logits = tllama.forward(pair.tparams, pair.tcfg,
                                tokens=torch.tensor(rows))["logits"]
        return torch.softmax(logits[:, -1] / TEMP, dim=-1).numpy()

    p0 = probs([prompt])[0]
    p1 = probs([prompt + [a] for a in range(V)])
    return p0[:, None] * p1


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
    exact = _exact_joint(pair, prompt)
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


def test_sampled_acceptance_tracks_draft_probability(small_vocab):
    """Acceptance equals the model's probability of the drafted token (not
    0, not 1): constant drafts over the 8 tokens average to about 1/8."""
    pair = small_vocab
    _, tb = pair.batchers(pool=dict(slots=1), spec_k=4, temperature=TEMP)
    rounds = emitted = 0
    for i in range(300):
        tb.reset(seed=60_000 + i)
        d = i % pair.tcfg.vocab_size
        tb.submit([5, 1, 6, 2, 7], max_new=12,
                  draft_fn=lambda h, k, d=d, **_: [d] * k)
        tb.run()
        rounds += tb.spec_stats["rounds"]
        emitted += tb.spec_stats["emitted"]
    acc = emitted / rounds
    assert 1.02 < acc < 2.5, acc


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
    a = _prompts(rng, [4])[0]
    others = _prompts(rng, [3, 3, 3])

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
