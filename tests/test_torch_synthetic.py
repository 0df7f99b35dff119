"""models/synthetic.py of the port: the induced-bigram int8 checkpoint. Its
greedy decode walks the permutation f on every route (T=1 decode, a K+1
verify block, prefill), and n-gram speculative acceptance reaches K+1 a
round once the trail repeats. The numbers are torch's, not jax.random's:
the structure is what is held to the reference."""

import jax
import numpy as np
import pytest
import torch

from procyon_tpu.models import llama as jllama
from procyon_tpu.models import synthetic as jsyn
from procyon_tpu_torch.inference import kv_pool, serving
from procyon_tpu_torch.models import llama, synthetic
from procyon_tpu_torch.ops import quant

PERIOD = 8


@pytest.fixture(scope="module")
def ckpt():
    cfg = llama.tiny_config(attn_backend="ref", vocab_size=200)
    params, f = synthetic.ngram_quantized_params(cfg, period=PERIOD, seed=3,
                                                 device="cpu")
    return cfg, params, f


def _pcfg(cfg, **kw):
    base = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, page_size=4, n_pages=64,
                max_pages_per_seq=16, slots=3, dtype=cfg.dtype)
    base.update(kw)
    return kv_pool.PagedConfig(**base)


def _chain(f, tok, n):
    out = []
    for _ in range(n):
        tok = int(f[tok])
        out.append(tok)
    return out


@pytest.mark.parametrize("vocab,period", [(200, 8), (37, 16), (16, 16)])
def test_cycle_permutation_equals_reference(vocab, period):
    f = synthetic.cycle_permutation(vocab, period)
    np.testing.assert_array_equal(f, jsyn.cycle_permutation(vocab, period))
    assert sorted(f) == list(range(vocab))
    t = 0
    for _ in range(min(period, vocab)):
        t = int(f[t])
    assert t == 0                                  # a cycle of the period


def test_tree_matches_the_reference_leaf_for_leaf(ckpt):
    """Same leaves, shapes and dtypes as the reference's checkpoint (and so
    as quantize_params(init_params(...))); wo / w_down are exact zeros;
    lm_head column j is margin * normalize(E[g(j)]) up to int8 rounding."""
    cfg, params, f = ckpt
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False,
                              vocab_size=200)
    want, jf = jsyn.ngram_quantized_params(jcfg, period=PERIOD, seed=3)
    np.testing.assert_array_equal(f, jf)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    for name, sub in (("attn", "wo"), ("mlp", "w_down")):
        leaf = params["layers"][name][sub]
        assert not leaf["s"].any() and leaf["q"].any()
    for name, sub in (("attn", "wq"), ("mlp", "w_up")):
        leaf = params["layers"][name][sub]
        assert (leaf["s"] == 0.01).all()
        assert leaf["q"].min() >= -8 and leaf["q"].max() <= 8
    g = np.argsort(f)
    emb = params["embed"].float()
    w = quant.dequantize(params["lm_head"], torch.float32)        # [D, V]
    target = emb[torch.from_numpy(g)]
    target = target * (16.0 / cfg.dim ** 0.5
                       / target.norm(dim=1, keepdim=True))
    assert (w.t() - target).abs().max() <= params["lm_head"]["s"].max()


def test_greedy_walks_f_on_every_route(ckpt):
    cfg, params, f = ckpt
    pcfg = _pcfg(cfg)
    pool = kv_pool.init_pool(pcfg, device="cpu")
    alloc = kv_pool.PageAllocator(pcfg)
    for s in (0, 1):
        pages = alloc.allocate(s, 40)
        pool["page_table"][s, :len(pages)] = torch.tensor(pages,
                                                          dtype=torch.int32)
    slots = torch.tensor([0, 1])
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 200, (2, 21)).astype(np.int32))
    # prefill (T = 21: the flash route): every position predicts f(token)
    logits, _ = llama.paged_forward(params, cfg, pool, pcfg, slots,
                                    tokens=tokens)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  f[tokens.numpy()])
    # the margin: top-1 near 16 = margin * sqrt(D); the others are about
    # margin * N(0, 1) = 2 N(0, 1) at this dim of 64, far below
    top2 = logits.topk(2, dim=-1).values
    assert (top2[..., 0] > 12).all()
    assert (top2[..., 0] - top2[..., 1] > 6).all()
    # T = 1 decode and a K+1 verify block
    for T in (1, 1, 5):
        tok = torch.from_numpy(rng.integers(0, 200, (2, T)).astype(np.int32))
        logits, _ = llama.paged_forward(params, cfg, pool, pcfg, slots,
                                        tokens=tok)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      f[tok.numpy()])
    # the dense path too
    dense = llama.forward(params, cfg, tokens=tokens)["logits"]
    np.testing.assert_array_equal(dense.argmax(-1).numpy(), f[tokens.numpy()])


@pytest.mark.parametrize("spec_quantum", [1, 2])
def test_speculative_acceptance_reaches_k_plus_1(ckpt, spec_quantum):
    """Plain and speculative batchers emit the chain; once a generation has
    walked its cycle the n-gram draft is perfect and a round emits K+1."""
    cfg, params, f = ckpt
    K, new = 3, 36
    prompts = [[5, 17, 42], [130, 131]]
    want = [_chain(f, p[-1], new) for p in prompts]
    plain = serving.ContinuousBatcher(params, cfg, _pcfg(cfg), device="cpu",
                                      step_quantum=4)
    rids = [plain.submit(p, max_new=new) for p in prompts]
    out = plain.run()
    assert [out[r] for r in rids] == want
    spec = serving.ContinuousBatcher(params, cfg, _pcfg(cfg), device="cpu",
                                     spec_k=K, spec_quantum=spec_quantum)
    rids = [spec.submit(p, max_new=new) for p in prompts]
    out = spec.run()
    assert [out[r] for r in rids] == want
    stats = spec.spec_stats
    # cold: one token a round for about a period; warm: K+1 a round
    assert stats["emitted"] == 2 * (new - 1)
    assert stats["emitted"] / stats["rounds"] > 2.0
    # a warm single request: after two periods every round accepts in full
    warm = serving.ContinuousBatcher(params, cfg, _pcfg(cfg), device="cpu",
                                     spec_k=K, spec_quantum=spec_quantum)
    cycle = _chain(f, 8, 2 * PERIOD)
    rid = warm.submit([8] + cycle, max_new=1 + 4 * (K + 1))
    got = warm.run()[rid]
    assert got == _chain(f, cycle[-1], 1 + 4 * (K + 1))
    assert warm.spec_stats == {"rounds": 4, "emitted": 4 * (K + 1)}
