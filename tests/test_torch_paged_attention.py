"""ops/paged_attention of the port against procyon_tpu.ops.paged_attention
on the same numpy inputs, f32 on the CPU: the plain version (which the
wrapper takes for CPU tensors) against the Pallas kernels in interpret mode.

The reference takes block-diagonal queries [B, Hq, Hkv*D] and returns
block-diagonal output lanes; the test builds the former and selects each
head's own slice from the latter, as models/llama.py does around it. out
and lse agree to 2e-5 (5e-5 on the int8 variant): the same f32 function,
the reference's softmax online over pages and the port's in one pass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import paged_attention as jpa
from procyon_tpu_torch.ops import paged_attention as tpa

B, HQ, HKV, D, PAGE, P = 5, 4, 2, 64, 8, 4
# dead slot, one token, mid-page, page boundary, the full context
LENS = [0, 1, 13, 16, 32]


def _inputs(rng, quantized):
    n_pages = B * P + 2
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    if quantized:
        k, v = (rng.integers(-127, 128, (n_pages, PAGE, HKV * D)).astype(
            np.int8) for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 2e-2, (n_pages, PAGE, HKV)).astype(
            np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal((n_pages, PAGE, HKV * D)).astype(
            np.float32) for _ in range(2))
        ks = vs = None
    table = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return q, k, v, ks, vs, table, np.asarray(LENS, np.int32)


def _reference(q, k, v, ks, vs, table, lens):
    """The Pallas kernel in interpret mode, after the head-slice selection
    of llama._paged_attention_with_self."""
    group = HQ // HKV
    qh = jnp.asarray(q).reshape(B, HKV, group, D)
    eye = jnp.eye(HKV, dtype=qh.dtype)
    q_bd = jnp.einsum("bkgd,kj->bkgjd", qh, eye).reshape(B, HQ, HKV * D)
    scales = {} if ks is None else dict(k_scale_pool=jnp.asarray(ks),
                                        v_scale_pool=jnp.asarray(vs))
    out_bd, lse = jpa.paged_decode_attention_fullpage(
        q_bd, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), n_kv_heads=HKV, head_dim=D, interpret=True,
        **scales)
    sel = jnp.repeat(jnp.eye(HKV, dtype=jnp.float32), group, axis=0)
    out = jnp.einsum("bhkd,hk->bhd", out_bd.reshape(B, HQ, HKV, D), sel)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("quantized,tol", [(False, 2e-5), (True, 5e-5)])
def test_plain_version_matches_pallas_interpret(quantized, tol):
    q, k, v, ks, vs, table, lens = _inputs(np.random.default_rng(4),
                                           quantized)
    want, want_lse = _reference(q, k, v, ks, vs, table, lens)
    t = torch.from_numpy
    scales = {} if ks is None else dict(k_scale_pool=t(ks),
                                        v_scale_pool=t(vs))
    n0 = tpa.launches
    got, lse = tpa.paged_decode_attention_fullpage(
        t(q), t(k), t(v), t(table), t(lens), n_kv_heads=HKV, head_dim=D,
        **scales)
    assert tpa.launches == n0                     # CPU tensors: no kernel
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=tol, rtol=tol)
    assert not got[0].any() and bool((lse[0] == -1e30).all())   # dead slot


def test_plain_version_is_attention_over_the_live_tokens():
    """Independent of the reference: a slot's output is softmax attention
    over its first `len` tokens, read through the table in page order, and
    nothing past them (garbage there changes nothing)."""
    q, k, v, _, _, table, lens = _inputs(np.random.default_rng(5), False)
    t = torch.from_numpy
    got, lse = tpa.paged_decode_attention_ref(
        t(q), t(k), t(v), t(table), t(lens), n_kv_heads=HKV, head_dim=D)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(LENS):                   # poison the dead tokens
        flat = table[b].repeat(PAGE) * PAGE + np.tile(np.arange(PAGE), P)
        k2.reshape(-1, HKV * D)[flat[n:]] = 1e4
        v2.reshape(-1, HKV * D)[flat[n:]] = -1e4
    got2, _ = tpa.paged_decode_attention_ref(
        t(q), t(k2), t(v2), t(table), t(lens), n_kv_heads=HKV, head_dim=D)
    np.testing.assert_array_equal(got.numpy(), got2.numpy())
    b, n = 2, LENS[2]
    kc = k[table[b]].reshape(P * PAGE, HKV, D)[:n]
    vc = v[table[b]].reshape(P * PAGE, HKV, D)[:n]
    for h in range(HQ):
        s = kc[:, h // (HQ // HKV)] @ q[b, h] / np.sqrt(D)
        p = np.exp(s - s.max())
        want = (p / p.sum()) @ vc[:, h // (HQ // HKV)]
        np.testing.assert_allclose(got[b, h].numpy(), want, atol=1e-5)
        np.testing.assert_allclose(lse[b, h].item(),
                                   s.max() + np.log(p.sum()), atol=1e-5)


def test_wrapper_checks_its_arguments():
    q, k, v, ks, vs, table, lens = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _inputs(np.random.default_rng(6), True))
    kw = dict(n_kv_heads=HKV, head_dim=D)
    with pytest.raises(ValueError, match="go together"):
        tpa.paged_decode_attention_fullpage(q, k, v, table, lens,
                                            k_scale_pool=ks, **kw)
    with pytest.raises(ValueError, match="scale pools"):
        tpa.paged_decode_attention_fullpage(
            q, k, v, table, lens, k_scale_pool=ks[:, :, :1],
            v_scale_pool=vs, **kw)
    with pytest.raises(ValueError, match="do not fit"):
        tpa.paged_decode_attention_fullpage(q, k, v, table[:2], lens, **kw)
    with pytest.raises(ValueError, match="kv"):
        tpa.paged_decode_attention_fullpage(q, k, v, table, lens,
                                            n_kv_heads=3, head_dim=D)
