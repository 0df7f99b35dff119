"""models/llama.paged_forward of the port against procyon_tpu's on the same
parameters (bridged), the same pool and the same numpy inputs, f32 on the
CPU, on each of its routes: the gather + short-block route, the page-walk
kernel route (the reference's Pallas kernel in interpret mode, the port's
plain version), the grouped-prefix cascade, int8 pools, a prefill chunk of
more than 16 tokens over a filled pool (flash attention at
Skv = max_ctx + T) and per-slot LoRA experts.

Logits agree to 2e-4 (abs and rel): the same f32 function, sums in another
order. The pools hold the same rows to 1e-3: a K/V row of the second layer
carries the first layer's rounding through its attention and MLP, and one
element in some ten thousand lands a few 1e-4 apart. An int8 pool may
differ by one code where a value sits on a rounding boundary."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import lora as jlora
from procyon_tpu_torch import bridge
from procyon_tpu_torch.inference import kv_pool as tkv
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import lora as tlora

TOL = dict(atol=2e-4, rtol=2e-4)
POOL_TOL = dict(atol=1e-3, rtol=1e-3)


def _cfgs(lora=None, **kw):
    base = dict(attn_backend="ref", remat=False, dim=256, n_heads=4,
                n_kv_heads=2, intermediate=512, vocab_size=512,
                max_seq_len=640)
    base.update(kw)
    jcfg = jllama.tiny_config(lora=lora, **base)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    if lora is not None:
        fields["lora"] = tlora.LoRAConfig(
            rank=lora.rank, alpha=lora.alpha, num_experts=lora.num_experts,
            dtype=torch.float32)
    return jcfg, tllama.LlamaConfig(**fields)


def _pcfgs(jcfg, **kw):
    base = dict(n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads,
                head_dim=jcfg.head_dim, page_size=4, n_pages=24,
                max_pages_per_seq=6, slots=4)
    base.update(kw)
    return (jkv.PagedConfig(dtype=jnp.float32, **base),
            tkv.PagedConfig(dtype=torch.float32, **base))


def _pools(jpcfg, tpcfg, slots, n_tokens):
    """Empty pools on both sides with pages allocated to `slots`."""
    alloc = jkv.PageAllocator(jpcfg)
    table = np.zeros((jpcfg.slots, jpcfg.max_pages_per_seq), np.int32)
    for s in slots:
        pages = alloc.allocate(int(s), n_tokens)
        table[s, :len(pages)] = pages
    jpool = {**jkv.init_pool(jpcfg), "page_table": jnp.asarray(table)}
    tpool = tkv.init_pool(tpcfg, device="cpu")
    tpool["page_table"] = torch.from_numpy(table.copy())
    return jpool, tpool


def _assert_pools_close(tpool, jpool):
    for key, val in jpool.items():
        got, want = tpool[key].numpy(), np.asarray(val)
        if want.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key
        elif want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **POOL_TOL)


class _Pair:
    """The two packages stepping side by side on the same inputs."""

    def __init__(self, jcfg, tcfg, jpcfg, tpcfg, slots, seed, n_tokens=20):
        self.jcfg, self.tcfg, self.jpcfg, self.tpcfg = jcfg, tcfg, jpcfg, \
            tpcfg
        self.params = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
        self.tparams = bridge.to_torch(self.params)
        self.slots = np.asarray(slots, np.int32)
        self.jpool, self.tpool = _pools(jpcfg, tpcfg, slots, n_tokens)

    def step(self, tokens, jcfg=None, tcfg=None, jkw=None, tkw=None,
             seg=None):
        jkw, tkw = dict(jkw or {}), dict(tkw or {})
        if seg is not None:
            jkw["seg_ids"] = jnp.asarray(seg)
            tkw["seg_ids"] = torch.from_numpy(seg)
        want, self.jpool = jllama.paged_forward(
            self.params, jcfg or self.jcfg, self.jpool, self.jpcfg,
            jnp.asarray(self.slots), tokens=jnp.asarray(tokens), **jkw)
        got, out = tllama.paged_forward(
            self.tparams, tcfg or self.tcfg, self.tpool, self.tpcfg,
            torch.from_numpy(self.slots), tokens=torch.from_numpy(tokens),
            **tkw)
        assert out is self.tpool                   # updated in place
        live = np.ones(tokens.shape, bool) if seg is None else seg > 0
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
        return np.asarray(want)


def _tokens(rng, B, T, vocab=512):
    return rng.integers(3, vocab, (B, T)).astype(np.int32)


@pytest.mark.parametrize("quantize", [False, True])
def test_gather_route_prefill_and_decode(quantize):
    """Prefill 6 tokens (a short block, with a padded row: seq_len advances
    by the live tokens, not by T), then greedy decode steps: one gather per
    layer + the short-block attention, with the int8 scale algebra on a
    quantized pool."""
    jcfg, tcfg = _cfgs()
    pair = _Pair(jcfg, tcfg, *_pcfgs(jcfg, quantize_kv=quantize), [0, 2],
                 seed=2)
    rng = np.random.default_rng(0)
    seg = np.ones((2, 6), np.int32)
    seg[1, 4:] = 0
    logits = pair.step(_tokens(rng, 2, 6), seg=seg)
    np.testing.assert_array_equal(pair.tpool["seq_len"].numpy(),
                                  [6, 0, 4, 0])
    nxt = np.stack([logits[0, 5], logits[1, 3]]).argmax(-1)
    for _ in range(4):
        logits = pair.step(nxt.astype(np.int32)[:, None])
        nxt = logits[:, 0].argmax(-1)
    np.testing.assert_array_equal(pair.tpool["seq_len"].numpy(),
                                  [10, 0, 8, 0])
    _assert_pools_close(pair.tpool, pair.jpool)


def test_kernel_route_decode(monkeypatch):
    """A pool of max_ctx 512 takes the page-walk kernel for T == 1: the
    reference's Pallas kernel in interpret mode, the port's wrapper (its
    plain version on CPU tensors) with the self-merge around it."""
    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, attn_backend=None)
    jpcfg, tpcfg = _pcfgs(jcfg, page_size=64, max_pages_per_seq=8,
                          n_pages=20)
    assert tpcfg.max_ctx == 512
    pair = _Pair(jcfg, tcfg, jpcfg, tpcfg, [0, 2], seed=3, n_tokens=80)
    calls = []
    real = tllama.paged_decode_attention_fullpage
    monkeypatch.setattr(
        tllama, "paged_decode_attention_fullpage",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    # 62 tokens, then steps across the page boundary at 64
    logits = pair.step(_tokens(rng, 2, 62))
    assert not calls                               # T > 1: not the kernel
    kern = dataclasses.replace(jcfg, attn_backend="interpret")
    nxt = logits[:, -1].argmax(-1)
    for _ in range(4):
        logits = pair.step(nxt.astype(np.int32)[:, None], jcfg=kern)
        nxt = logits[:, 0].argmax(-1)
    assert len(calls) == 4 * tcfg.n_layers
    _assert_pools_close(pair.tpool, pair.jpool)
    # the same pool through the gather route gives the same logits
    ref = dataclasses.replace(tcfg, attn_backend="ref")
    calls.clear()
    pair.step(nxt.astype(np.int32)[:, None], jcfg=kern, tcfg=ref)
    assert not calls
    # int8 pools and short pools stay on the gather route
    for kw in (dict(quantize_kv=True, page_size=64, max_pages_per_seq=8,
                    n_pages=20), dict()):
        jp, tp = _pcfgs(jcfg, **kw)
        other = _Pair(jcfg, tcfg, jp, tp, [0, 2], seed=3, n_tokens=20)
        other.step(_tokens(rng, 2, 5))
        other.step(_tokens(rng, 2, 1))
        assert not calls


def test_long_chunk_over_a_filled_pool():
    """Chunked prefill: 20 tokens, then a chunk of 18 more: flash attention
    over [gathered context, chunk] with Skv = max_ctx + T and the cached
    positions; on an int8 pool the context is dequantized for it."""
    jcfg, tcfg = _cfgs()
    # a bf16-style pool on the port's kernel route (the flash kernel's
    # plain version), an int8 pool on its reference route
    for quantize, backend in ((False, None), (True, "ref")):
        pair = _Pair(jcfg, dataclasses.replace(tcfg, attn_backend=backend),
                     *_pcfgs(jcfg, max_pages_per_seq=12, n_pages=30,
                             quantize_kv=quantize), [3, 1], seed=4,
                     n_tokens=44)
        rng = np.random.default_rng(2)
        pair.step(_tokens(rng, 2, 20))
        seg = np.ones((2, 18), np.int32)
        seg[0, 15:] = 0
        pair.step(_tokens(rng, 2, 18), seg=seg)
        np.testing.assert_array_equal(pair.tpool["seq_len"].numpy(),
                                      [0, 38, 0, 35])
        pair.step(_tokens(rng, 2, 1))
        _assert_pools_close(pair.tpool, pair.jpool)


@pytest.mark.parametrize("quantize", [False, True])
def test_cascade_route(quantize):
    """Grouped-prefix cascade: two groups of two slots, each group sharing
    its prompt's full pages (two pages and none: a fully masked prefix),
    private tails. Against the reference's cascade and against the port's
    own flat gather route on the same pool."""
    jcfg, tcfg = _cfgs()
    jpcfg, tpcfg = _pcfgs(jcfg, quantize_kv=quantize)
    rng = np.random.default_rng(3)
    jpool = jkv.init_pool(jpcfg)
    content = {k: rng.integers(-127, 128, v.shape).astype(np.int8)
               if v.dtype == jnp.int8
               else rng.uniform(1e-3, 2e-2, v.shape).astype(np.float32)
               if k.endswith("scale")
               else rng.standard_normal(v.shape).astype(np.float32)
               for k, v in jpool.items() if k in ("k", "v", "k_scale",
                                                  "v_scale")}
    table = np.array([[1, 2, 3, 4, 5, 5], [1, 2, 6, 7, 8, 8],
                      [9, 10, 11, 11, 11, 11], [12, 13, 14, 14, 14, 14]],
                     np.int32)
    g0 = np.array([2, 2, 0, 0], np.int32)
    lens = np.array([11, 11, 5, 5], np.int32)
    params = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    tparams = bridge.to_torch(params)
    share = dict(share_gsz=2, share_prefix_pages=2, share_tail_pages=3)

    def pools():
        jp = {**{k: jnp.asarray(v) for k, v in content.items()},
              "page_table": jnp.asarray(table), "seq_len": jnp.asarray(lens)}
        return jp, bridge.pool_to_torch({k: np.asarray(v)
                                         for k, v in jp.items()})

    jp, tp = pools()
    _, tp_flat = pools()
    slots = np.arange(4, dtype=np.int32)
    for _ in range(2):
        tok = _tokens(rng, 4, 1)
        want, jp = jllama.paged_forward(
            params, jcfg, jp, jpcfg, jnp.asarray(slots),
            tokens=jnp.asarray(tok), share_g0=jnp.asarray(g0), **share)
        got, _ = tllama.paged_forward(
            tparams, tcfg, tp, tpcfg, torch.from_numpy(slots),
            tokens=torch.from_numpy(tok), share_g0=torch.from_numpy(g0),
            **share)
        flat, _ = tllama.paged_forward(
            tparams, tcfg, tp_flat, tpcfg, torch.from_numpy(slots),
            tokens=torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), flat.numpy(), **TOL)
        assert torch.isfinite(got).all()
    _assert_pools_close(tp, jp)


def test_lora_experts_scalar_and_per_slot():
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, num_experts=3,
                            dtype=jnp.float32)
    jcfg, tcfg = _cfgs(lora=lcfg)
    pair = _Pair(jcfg, tcfg, *_pcfgs(jcfg), [0, 2], seed=6)
    rng = np.random.default_rng(4)
    layers = dict(pair.params["layers"])
    for name in ("lora_wq", "lora_wv"):        # B starts at 0: make it count
        bank = dict(layers[name])
        bank["B"] = jnp.asarray(rng.standard_normal(bank["B"].shape) * 0.1,
                                jnp.float32)
        layers[name] = bank
    pair.params = {**pair.params, "layers": layers}
    pair.tparams = bridge.to_torch(pair.params)
    experts = np.array([2, 0], np.int32)
    routed = dict(jkw=dict(lora_expert=jnp.asarray(experts)),
                  tkw=dict(lora_expert=torch.from_numpy(experts)))
    a = pair.step(_tokens(rng, 2, 5), **routed)
    pair.step(_tokens(rng, 2, 1), **routed)
    b = pair.step(_tokens(rng, 2, 1), jkw=dict(lora_expert=1),
                  tkw=dict(lora_expert=1))
    assert np.abs(a).max() > 0 and np.abs(b).max() > 0
    _assert_pools_close(pair.tpool, pair.jpool)


def test_position_bound_and_logits_at():
    """The position check needs no device read when the caller passes the
    bound, and still raises; logits_at returns one row's logits."""
    jcfg, tcfg = _cfgs(max_seq_len=8)
    _, tpcfg = _pcfgs(jcfg)
    params = tllama.init_params(0, tcfg, device="cpu")
    pool = tkv.init_pool(tpcfg, device="cpu")
    pool["page_table"][0, :3] = torch.tensor([1, 2, 3])
    slots = torch.tensor([0])
    toks = torch.arange(3, 9, dtype=torch.int32)[None]
    full, _ = tllama.paged_forward(params, tcfg, pool, tpcfg, slots,
                                   tokens=toks, max_position=5)
    pool["seq_len"][:] = 0
    one, _ = tllama.paged_forward(params, tcfg, pool, tpcfg, slots,
                                  tokens=toks, max_position=5,
                                  logits_at=torch.tensor([4]))
    assert one.shape == (1, 1, tcfg.vocab_size)
    np.testing.assert_allclose(one[:, 0].numpy(), full[:, 4].numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="max_seq_len"):   # 6 + 3 - 1 = 8
        tllama.paged_forward(params, tcfg, pool, tpcfg, slots,
                             tokens=toks[:, :3])
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.paged_forward(params, tcfg, pool, tpcfg, slots,
                             tokens=toks[:, :1], max_position=8)
    # the dense forward: the bound from the host, or read from the device
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.forward(params, tcfg, tokens=toks[:, :2],
                       positions=torch.tensor([[0, 1]]), max_position=8)
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.forward(params, tcfg, tokens=toks[:, :2],
                       positions=torch.tensor([[0, 8]]))
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.forward(params, tcfg, tokens=torch.zeros((1, 9),
                                                        dtype=torch.int32))
    out = tllama.forward(params, tcfg, tokens=toks[:, :2],
                         positions=torch.tensor([[6, 7]]), max_position=7)
    assert torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("T", [1, 3, 20])
def test_ref_backend_refuses_a_pool_off_the_cpu(T):
    """attn_backend="ref" is the CPU reference on every paged route: a pool
    and parameters on another device (the meta device stands in for the
    card here) are refused before any route's plain code runs, for a decode
    step and a short block as for a long chunk."""
    jcfg, tcfg = _cfgs()
    _, tpcfg = _pcfgs(jcfg, max_pages_per_seq=8, n_pages=40)
    params = tllama.init_params(0, tcfg, device="cpu")
    meta = bridge.to_torch(bridge.to_numpy(params), device="meta")
    pool = tkv.init_pool(tpcfg, device="meta")
    slots = torch.zeros((1,), dtype=torch.long, device="meta")
    toks = torch.zeros((1, T), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU reference"):
        tllama.paged_forward(meta, tcfg, pool, tpcfg, slots, tokens=toks,
                             max_position=T - 1)
    # the kernels' backend gets past the check: the gather route's plain
    # code runs on any device, the long chunk reaches the flash wrapper
    cfg = dataclasses.replace(tcfg, attn_backend=None)
    if T <= 16:
        logits, _ = tllama.paged_forward(meta, cfg, pool, tpcfg, slots,
                                         tokens=toks, max_position=T - 1)
        assert logits.shape == (1, T, tcfg.vocab_size)
    else:
        with pytest.raises(ValueError, match="no flash attention"):
            tllama.paged_forward(meta, cfg, pool, tpcfg, slots, tokens=toks,
                                 max_position=T - 1)
