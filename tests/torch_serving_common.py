"""Shared by tests/test_torch_serving_{plain,spec,lora,sampling}.py: the
tiny models in both packages (the JAX package's random parameters,
bridged), batchers over them, the request builders and the serving modes
the files take their cases from."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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


def port_cfg(jcfg):
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
        self.tcfg = port_cfg(jcfg)
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


def make_model():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False)
    return Pair(jcfg, jllama.init_params(jax.random.PRNGKey(0), jcfg))


def make_lora_model():
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


def make_int4_model():
    """Wide enough for int4 groups of 64 (dim 256), quantized in JAX and
    bridged, so both sides hold the same bytes."""
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False, dim=256,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              vocab_size=384)
    params = jllama.init_params(jax.random.PRNGKey(8), jcfg)
    return Pair(jcfg, jllama.quantize_params(params, jcfg, bits=4, group=64))


def make_prompts(rng, lengths, vocab=256):
    return [list(map(int, rng.integers(4, vocab, n))) for n in lengths]


def make_embeds(rng, n, dim=64):
    return rng.standard_normal((n, dim)).astype(np.float32) * 0.3


def submit_all(b, reqs):
    """reqs: (prompt or embeds, max_new, kwargs)."""
    rids = []
    for what, max_new, kw in reqs:
        if isinstance(what, np.ndarray):
            rids.append(b.submit_fused(what, max_new=max_new, **kw))
        else:
            rids.append(b.submit(what, max_new=max_new, **kw))
    return rids


def assert_same_state(jb, tb):
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


def run_both(pair, reqs, pool=None, **kw):
    jb, tb = pair.batchers(pool=pool, **kw)
    jr, tr = submit_all(jb, reqs), submit_all(tb, reqs)
    jo, to = jb.run(), tb.run()
    assert len(to) == len(reqs)
    for a, b in zip(jr, tr):
        assert to[b] == jo[a], (b, to[b], jo[a])
    assert_same_state(jb, tb)
    return [to[r] for r in tr], jb, tb


def plain_reqs(seed, lengths, max_new):
    rng = np.random.default_rng(seed)
    return [(p, m, {}) for p, m in zip(make_prompts(rng, lengths), max_new)]


def shared_prefix_reqs(seed, prefix_len=13, tails=(4, 7, 2, 5),
                   max_new=(5, 3, 6, 4)):
    rng = np.random.default_rng(seed)
    prefix = make_prompts(rng, [prefix_len])[0]
    return [(prefix + t, m, {})
            for t, m in zip(make_prompts(rng, tails), max_new)]


def mixed_reqs(seed):
    rng = np.random.default_rng(seed)
    reqs = [(p, m, {}) for p, m in zip(make_prompts(rng, (8, 3, 9, 5)),
                                       (6, 7, 4, 5))]
    return reqs + [(make_embeds(rng, 7), 5, {})]


def fused_shared_reqs(seed):
    rng = np.random.default_rng(seed)
    prefix = make_embeds(rng, 9)
    return [(np.concatenate([prefix, make_embeds(rng, t)]), 5, {})
            for t in (3, 6, 2)]


def eviction_reqs(seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(3):
        prefix = make_prompts(rng, [9])[0]
        for t in (3, 5):
            reqs.append((prefix + make_prompts(rng, [t])[0], 4, {}))
    return reqs


# mode -> (requests, pool overrides, batcher options)
MODES = {
    "solo_vs_batched": (plain_reqs(0, (5, 11, 3), (6, 6, 6)), {}, {}),
    "staggered_admission": (plain_reqs(1, (7, 4, 9, 5), (3, 8, 5, 4)),
                            dict(slots=2, n_pages=16), {}),
    "step_quantum_2": (plain_reqs(3, (5, 11, 3), (6, 5, 7)), {},
                       dict(step_quantum=2)),
    "step_quantum_4": (plain_reqs(3, (5, 11, 3), (6, 5, 7)), {},
                       dict(step_quantum=4)),
    "small_pool_many_requests": (
        plain_reqs(11, (3, 9, 11, 4, 7, 5, 10, 6, 8, 3),
               (2, 7, 3, 6, 5, 4, 2, 7, 3, 5)),
        dict(slots=2, n_pages=24), dict(step_quantum=3)),
    "kv8_pool": (plain_reqs(13, (6, 10, 4), (9, 6, 5)),
                 dict(quantize_kv=True), {}),
    "chunked": (mixed_reqs(23), {}, dict(prefill_chunk=4)),
    "bucketed": (mixed_reqs(23), {}, {}),
    "long_prompt_flash_route": (plain_reqs(25, (21, 18, 5), (4, 5, 3)), {},
                                {}),
    "wave_prefill": (mixed_reqs(83), dict(slots=4), dict(prefill_chunk=4,
                                                     prefill_batch=3)),
    "wave_prefix_same_wave_duplicates": (
        [(make_prompts(np.random.default_rng(97), [11])[0], 4, {})] * 3,
        dict(slots=2, n_pages=48),
        dict(prefill_chunk=4, prefill_batch=2, prefix_cache=True)),
    "wave_with_quantum": (plain_reqs(101, (7, 5, 10), (5, 5, 5)), {},
                          dict(prefill_chunk=4, prefill_batch=3,
                               step_quantum=2)),
    "prefix_cache_tokens": (shared_prefix_reqs(41), dict(slots=2, n_pages=48),
                            dict(prefix_cache=True)),
    "prefix_cache_chunked": (shared_prefix_reqs(41), dict(slots=2, n_pages=48),
                             dict(prefix_cache=True, prefill_chunk=4)),
    "prefix_cache_fused": (fused_shared_reqs(43), dict(slots=2, n_pages=48),
                           dict(prefix_cache=True)),
    "prefix_cache_kv8": (shared_prefix_reqs(47, max_new=(4, 5, 3, 6)),
                         dict(slots=2, n_pages=48, quantize_kv=True),
                         dict(prefix_cache=True)),
    "prefix_cache_eviction": (
        eviction_reqs(59),
        dict(slots=2, n_pages=12, max_pages_per_seq=6),
        dict(prefix_cache=True)),
    "prefix_cache_spec": (shared_prefix_reqs(53, tails=(4, 6), max_new=(6, 7)),
                          dict(slots=2, n_pages=48),
                          dict(prefix_cache=True, spec_k=3)),
    "async_rounds_q1": (plain_reqs(103, (6, 4, 9, 5, 7), (4, 9, 3, 6, 5)),
                        dict(slots=2, n_pages=32), dict(async_rounds=True)),
    "async_rounds_q3": (plain_reqs(103, (6, 4, 9, 5, 7), (4, 9, 3, 6, 5)),
                        dict(slots=2, n_pages=32),
                        dict(async_rounds=True, step_quantum=3)),
    "async_kv8": (plain_reqs(104, (6, 4, 9), (5, 8, 4)),
                  dict(slots=2, n_pages=32, quantize_kv=True),
                  dict(async_rounds=True, step_quantum=2)),
    "async_wave_prefix": (
        shared_prefix_reqs(109, prefix_len=9, tails=(4, 7, 3),
                       max_new=(5, 5, 5)),
        dict(slots=2, n_pages=48),
        dict(async_rounds=True, step_quantum=2, prefix_cache=True,
             prefill_chunk=4, prefill_batch=2)),
    "async_waste_churn": (plain_reqs(11, (5,) * 6, (2, 5, 3, 4, 5, 2)),
                          dict(slots=2),
                          dict(async_rounds=True, step_quantum=4)),
    "sync_waste_churn": (plain_reqs(11, (5,) * 6, (2, 5, 3, 4, 5, 2)),
                         dict(slots=2), dict(step_quantum=4)),
    "spec_k_host_drafts": (plain_reqs(5, (6, 11, 4, 9), (8, 5, 12, 7)),
                           dict(slots=2), dict(spec_k=3)),
    "spec_k_kv8": (plain_reqs(13, (6, 10), (9, 6)), dict(quantize_kv=True),
                   dict(spec_k=3)),
    "spec_k_fused": ([(make_embeds(np.random.default_rng(9), n), 7, {})
                      for n in (5, 9)], {}, dict(spec_k=3)),
    "spec_quantum_2": (plain_reqs(41, (6, 11, 4, 9), (8, 5, 12, 7)),
                       dict(slots=2), dict(spec_k=3, spec_quantum=2)),
    "spec_quantum_4": (plain_reqs(41, (6, 11, 4, 9), (8, 5, 12, 7))
                       + [(make_embeds(np.random.default_rng(42), 7), 6, {})],
                       dict(slots=2), dict(spec_k=3, spec_quantum=4)),
}

SPEC_MODES = sorted(m for m, (_, _, kw) in MODES.items() if kw.get("spec_k"))
PLAIN_MODES = sorted(m for m in MODES if m not in SPEC_MODES)


def check_tokens_equal_reference(model, mode):
    reqs, pool, kw = MODES[mode]
    out, jb, tb = run_both(model, reqs, pool=pool, **kw)
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


LORA_MODES = {
    "mixed_experts": (dict(slots=4), {}, (5, 7, 4, 6), (0, 1, 2, 1)),
    "quantum": ({}, dict(step_quantum=3), (6, 4, 8), (2, 0, 1)),
    "spec": ({}, dict(spec_k=2), (6, 4, 8), (2, 0, 1)),
    "spec_trip": ({}, dict(spec_k=2, spec_quantum=2), (6, 4, 8), (2, 0, 1)),
    "wave": ({}, dict(prefill_chunk=4, prefill_batch=3), (7, 5, 10),
             (1, 2, 0)),
    "slot_reuse_resets_expert": (dict(slots=1), {}, (5, 7), (2, 0)),
}


TEMP = 0.9


def make_small_vocab():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False, vocab_size=8)
    return Pair(jcfg, jllama.init_params(jax.random.PRNGKey(2), jcfg))


def exact_joint(pair, prompt):
    """The model's exact distribution of the first two sampled tokens."""
    V = pair.tcfg.vocab_size

    def probs(rows):
        logits = tllama.forward(pair.tparams, pair.tcfg,
                                tokens=torch.tensor(rows))["logits"]
        return torch.softmax(logits[:, -1] / TEMP, dim=-1).numpy()

    p0 = probs([prompt])[0]
    p1 = probs([prompt + [a] for a in range(V)])
    return p0[:, None] * p1
