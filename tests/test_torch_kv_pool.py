"""inference/kv_pool of the port against procyon_tpu.inference.kv_pool on
the same numpy inputs (f32 on the CPU), and the bridge's pool round trip.
The JAX functions return new pools; the port's update theirs in place."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu_torch import bridge
from procyon_tpu_torch.inference import kv_pool as tkv

KW = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4, n_pages=10,
          max_pages_per_seq=3, slots=4)


def _cfgs(**kw):
    kw = {**KW, **kw}
    return (jkv.PagedConfig(dtype=jnp.float32, **kw),
            tkv.PagedConfig(dtype=torch.float32, **kw))


def _assert_pools_equal(tpool, jpool):
    assert set(tpool) == set(jpool)
    for key, val in jpool.items():
        got = tpool[key]
        assert tuple(got.shape) == val.shape, key
        assert str(got.dtype).split(".")[1] == str(val.dtype), key
        np.testing.assert_array_equal(got.numpy(), np.asarray(val),
                                      err_msg=key)


def test_config_and_init_pool():
    for quantize in (False, True):
        jcfg, tcfg = _cfgs(quantize_kv=quantize)
        assert (tcfg.kv_dim, tcfg.max_ctx) == (jcfg.kv_dim, jcfg.max_ctx)
        _assert_pools_equal(tkv.init_pool(tcfg, device="cpu"),
                            jkv.init_pool(jcfg))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tkv.init_pool(_cfgs()[1])             # device defaults to cuda


def test_quantize_rows_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0                                  # the 1e-8 floor
    x[1, 1, :8] = np.round(x[1, 1, :8] * 4) / 4    # rounding ties
    q, s = tkv.quantize_rows(torch.from_numpy(x), 2)
    jq, js = jkv.quantize_rows(jnp.asarray(x), 2)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantize", [False, True])
def test_write_tokens_matches(quantize):
    """Two writes in a row, the second with a position past the last table
    column: it is clipped to that column's page, as in the reference."""
    jcfg, tcfg = _cfgs(quantize_kv=quantize)
    rng = np.random.default_rng(1)
    table = np.zeros((4, 3), np.int32)
    table[1] = [3, 5, 7]
    table[2] = [2, 4, 6]
    jpool = {**jkv.init_pool(jcfg), "page_table": jnp.asarray(table)}
    tpool = tkv.init_pool(tcfg, device="cpu")
    tpool["page_table"] = torch.from_numpy(table)
    slots = np.array([2, 1], np.int32)
    for T, start in ((5, [0, 2]), (3, [5, 10])):   # 10 + 2 = 12: overflow
        lk, lv = (rng.standard_normal((2, 2, T, 16)).astype(np.float32)
                  for _ in range(2))
        start = np.asarray(start, np.int32)
        jpool = jkv.write_tokens(jpool, jcfg, jnp.asarray(lk),
                                 jnp.asarray(lv), jnp.asarray(slots),
                                 jnp.asarray(start))
        out = tkv.write_tokens(tpool, tcfg, torch.from_numpy(lk),
                               torch.from_numpy(lv), torch.from_numpy(slots),
                               torch.from_numpy(start))
        assert out is tpool                        # in place
        _assert_pools_equal(tpool, jpool)
    # the overflow row (slot 1, position 12) sits in the last column's page
    # 7 at offset 0, in both layers
    assert tpool["k"][7, 0].any() and tpool["k"][10 + 7, 0].any()


def test_page_allocator_matches():
    jcfg, tcfg = _cfgs()
    ja, ta = jkv.PageAllocator(jcfg), tkv.PageAllocator(tcfg)
    for alloc in (ja, ta):
        alloc.allocate(0, 9)
        alloc.allocate(1, 3, reserved=0)
        alloc.allocate(0, 12)
        alloc.disown(0, alloc.owned[0][0])
        alloc.release(0)
    assert ta.free == ja.free and ta.owned == ja.owned
    assert ta.pages_for(9) == 3 and ta.can_admit(8) == ja.can_admit(8)
    with pytest.raises(MemoryError):
        ta.allocate(2, 1000)


def test_block_digests_byte_equal_and_prefix_cache():
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((23, 6)).astype(np.float32)
    prompt = rng.integers(0, 100, 23)
    for kw in (dict(embeds=embeds, page_size=4),
               dict(embeds=embeds[:, ::2], page_size=4),   # not contiguous
               dict(prompt=prompt, page_size=8, domain=b"e1:"),
               dict(prompt=prompt[:8], page_size=8)):      # no full block
        assert tkv.PrefixCache.block_digests(**kw) \
            == jkv.PrefixCache.block_digests(**kw)
    digests = tkv.PrefixCache.block_digests(embeds=embeds, page_size=4)
    assert len(digests) == 5                       # (23 - 1) // 4
    jc, tc = jkv.PrefixCache(4), tkv.PrefixCache(4)
    assert tc.node_keys(digests) == jc.node_keys(digests)
    for c in (jc, tc):
        keys = c.node_keys(digests)
        for key, page in zip(keys[:3], (4, 5, 6)):
            assert c.promote(key, page)
        assert not c.promote(keys[0], 9)
        c.release([4, 6])
        c.acquire([6])
        c.release([6])
    assert tc.match(digests) == jc.match(digests)
    assert tc.match(digests)[0] == [4, 5, 6]
    assert tc.n_evictable() == jc.n_evictable() == 2
    assert tc.evict(1) == jc.evict(1) == [4]       # least recently used
    assert tc.match(digests)[0] == jc.match(digests)[0] == []
    assert tc.stats == jc.stats


@pytest.mark.parametrize("quantize", [False, True])
def test_bridge_pool_round_trip(quantize):
    jcfg, tcfg = _cfgs(quantize_kv=quantize)
    rng = np.random.default_rng(3)
    jpool = jkv.init_pool(jcfg)
    jpool = {k: jnp.asarray(rng.integers(-9, 9, v.shape), v.dtype)
             for k, v in jpool.items()}
    tpool = bridge.pool_to_torch({k: np.asarray(v)
                                  for k, v in jpool.items()})
    _assert_pools_equal(tpool, jpool)
    tpool["k"][0, 0, 0] += 1                       # its own memory
    assert int(tpool["k"][0, 0, 0]) == int(jpool["k"][0, 0, 0]) + 1
    tpool["k"][0, 0, 0] -= 1
    back = bridge.pool_to_numpy(tpool)
    for key, val in jpool.items():
        assert back[key].dtype == val.dtype
        np.testing.assert_array_equal(back[key], np.asarray(val))
    bf = {**tpool, "k": tpool["k"].to(torch.bfloat16),
          "v": tpool["v"].to(torch.bfloat16)}
    if not quantize:
        kb = bridge.pool_to_numpy(bf)["k"]
        assert kb.dtype.name == "bfloat16"
        np.testing.assert_array_equal(np.asarray(jnp.asarray(kb),
                                                 np.float32),
                                      np.asarray(jpool["k"]))
        again = bridge.pool_to_torch(bridge.pool_to_numpy(bf))
        assert again["k"].dtype == torch.bfloat16
        assert torch.equal(again["k"], bf["k"])
    with pytest.raises(ValueError, match="not a paged KV pool"):
        bridge.pool_to_torch({"k": np.zeros(3)})
