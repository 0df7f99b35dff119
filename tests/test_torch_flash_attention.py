"""procyon_tpu_torch flash attention (the plain version of the CUDA kernel,
which CPU tensors take) against procyon_tpu's Pallas kernels run in
interpret mode on the CPU and against its mha_reference, in f32 on the same
numpy inputs.

Tolerance 2e-5 (abs and rel), as tests/test_flash_attention.py uses for the
Pallas kernels against mha_reference: all sides compute the same f32
function and differ only in the order of the f32 sums and in the base of
the exponential.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import attention_rowblock as jrb
from procyon_tpu.ops import rotary as jrot
from procyon_tpu_torch.ops import attention_rowblock as trb
from procyon_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("procyon_tpu.ops.flash_attention")

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(rng, B, Sq, Skv, Hq, Hkv, D):
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _segments(B, S):
    """Row 0 right-padded, row 1 packed in two segments, row 2 left-padded
    behind a fully masked first stretch."""
    seg = np.ones((B, S), np.int32)
    seg[0, S - 19:] = 0
    seg[1, S // 3:] = 2
    seg[2, :S // 2 + 5] = 0
    return seg


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("D", [16, 24, 64])
def test_matches_pallas_flash_and_reference(causal, Hq, Hkv, D):
    rng = np.random.default_rng(D + Hkv)
    B, S = 3, 64
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    seg = _segments(B, S)
    want = jfa.flash_attention(*_j(q, k, v, seg, seg), causal=causal,
                               backend="pallas", interpret=True)
    ref = jfa.mha_reference(*_j(q, k, v, seg, seg), causal=causal)
    got = tfa.flash_attention(*_t(q, k, v, seg, seg), causal=causal)
    got_ref = tfa.flash_attention(*_t(q, k, v, seg, seg), causal=causal,
                                  backend="ref")
    _close(got, want)
    _close(got, ref)
    _close(got_ref, ref)
    assert not got[2, :S // 2 + 5].any()      # padded query rows are zero


@pytest.mark.parametrize("causal,Hq,Hkv,D", [(False, 4, 4, 24),
                                             (True, 4, 2, 16),
                                             (False, 4, 2, 64)])
def test_rowblock_backend_matches_pallas_rowblock(causal, Hq, Hkv, D):
    rng = np.random.default_rng(7)
    B, S = 3, 64
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    seg = _segments(B, S)
    want = jfa.flash_attention(*_j(q, k, v, seg, seg), causal=causal,
                               backend="rowblock", interpret=True)
    got = tfa.flash_attention(*_t(q, k, v, seg, seg), causal=causal,
                              backend="rowblock")
    _close(got, want)


def test_rowblock_backend_rope_takes_packed_route_and_matches():
    """H*D = 128 and bidirectional: the packed kernel's route with rotary
    fused, as the reference dispatches it."""
    rng = np.random.default_rng(3)
    B, S, H, D = 3, 128, 2, 64
    q, k, v = _qkv(rng, B, S, S, H, H, D)
    seg = _segments(B, S)
    cos, sin, _ = jrot.flat_rotary_tables(D, H, S)
    rope = (cos, sin, cos, sin)
    want = jfa.flash_attention(*_j(q, k, v, seg, seg), backend="rowblock",
                               interpret=True, rope=tuple(_j(*rope)))
    tq, tk, tv, tseg = _t(q, k, v, seg)
    got = tfa.flash_attention(tq, tk, tv, tseg, tseg, backend="rowblock",
                              rope=tuple(_t(*rope)))
    _close(got, want)
    flash = tfa.flash_attention(tq, tk, tv, tseg, tseg,
                                rope=tuple(_t(*rope)))
    _close(flash, want)


def test_left_padded_positions():
    """Generation prompts are left-padded: positions restart at the first
    real token and the causal comparison uses them."""
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, D = 2, 64, 4, 2, 16
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    seg = np.ones((B, S), np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg[1, :23] = 0
    pos[1] = np.maximum(np.arange(S) - 23, 0)
    kw = dict(causal=True)
    want = jfa.flash_attention(*_j(q, k, v, seg, seg), **kw,
                               q_positions=jnp.asarray(pos),
                               kv_positions=jnp.asarray(pos),
                               backend="pallas", interpret=True)
    got = tfa.flash_attention(*_t(q, k, v, seg, seg), **kw,
                              q_positions=torch.from_numpy(pos).long(),
                              kv_positions=torch.from_numpy(pos).long())
    _close(got, want)


def test_cache_shape_sq_differs_from_skv():
    """Prefill of 16 new tokens over a 96-slot cache holding 40 entries:
    Sq != Skv, positions given, the cache's tail empty (segment 0)."""
    rng = np.random.default_rng(13)
    B, Sq, Skv, Hq, Hkv, D = 2, 16, 96, 4, 2, 16
    q, k, v = _qkv(rng, B, Sq, Skv, Hq, Hkv, D)
    seg_q = np.ones((B, Sq), np.int32)
    seg_kv = np.zeros((B, Skv), np.int32)
    seg_kv[:, :40 + Sq] = 1
    q_pos = np.tile(np.arange(40, 40 + Sq, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    kv_pos[:, 40 + Sq:] = 0
    want = jfa.flash_attention(*_j(q, k, v, seg_q, seg_kv), causal=True,
                               q_positions=jnp.asarray(q_pos),
                               kv_positions=jnp.asarray(kv_pos),
                               backend="pallas", interpret=True)
    got = tfa.flash_attention(*_t(q, k, v, seg_q, seg_kv), causal=True,
                              q_positions=torch.from_numpy(q_pos),
                              kv_positions=torch.from_numpy(kv_pos))
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_and_dead_rows_match_fwd(causal):
    """Out and log-sum-exp against the Pallas forward's own (_fwd needs
    lengths that are multiples of its 128 block); a fully masked row gives
    0 and lse -1e30 on both sides."""
    rng = np.random.default_rng(17)
    B, S, Hq, Hkv, D = 3, 128, 4, 2, 16
    q, k, v = _qkv(rng, B, S, S, Hq, Hkv, D)
    seg = _segments(B, S)
    seg[0, :] = 0                                 # a dead batch row
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    sm = 1.0 / math.sqrt(D)
    want, want_lse = jfa._fwd(*_j(q, k, v, seg, seg, pos, pos),
                              (causal, sm, True, True))
    rb_out, rb_lse = jrb.rowblock_fwd(*_j(q, k, v, seg, seg, pos, pos),
                                      (causal, sm, True, True))
    args = _t(q, k, v, seg, seg, pos, pos)
    got, lse = tfa.flash_fwd(*args, causal=causal, sm_scale=sm,
                             bounded=True, want_lse=True)
    got_rb, lse_rb = trb.rowblock_fwd(*args, causal=causal, sm_scale=sm)
    _close(got, want)
    _close(lse, want_lse)
    _close(got_rb, rb_out)
    _close(lse_rb, rb_lse)
    assert not got[0].any() and (lse[0] == -1e30).all()
    assert (lse[2, :, :S // 2 + 5] == -1e30).all()
    none_lse = tfa.flash_fwd(*args, causal=causal, sm_scale=sm)[1]
    assert none_lse is None


def test_wrapper_refuses_what_it_cannot_run():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="backend"):
        tfa.flash_attention(q, q, q, backend="pallas")
    with pytest.raises(ValueError, match="device"):
        tfa.flash_fwd(*(t.to("meta") for t in (q, q, q)), None, None, None,
                      None, causal=False, sm_scale=1.0)


def _layout_case(case):
    """(q, k, v, ints) for one case of the forward kernel's layout check:
    q and k strided views of a flat [B, S, (Hq + 2 Hkv) * D] projection,
    v contiguous; "cache_slice" reads k and v from a [2, B, Smax, Hkv, D]
    cache, as the decoder's prefill over a cache does."""
    B, S, Hq, Hkv = 2, 64, 4, 2
    D = {"head_dim_24": 24, "head_dim_48": 48}.get(case, 64)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    off = 1 if case == "misaligned" else 0
    flat = torch.zeros((B, S, (Hq + 2 * Hkv) * D + 8), dtype=dtype)
    q = flat[..., off:off + Hq * D].reshape(B, S, Hq, D)
    k = flat[..., Hq * D + 8:(Hq + Hkv) * D + 8].reshape(B, S, Hkv, D)
    v = torch.zeros((B, S + (case == "shapes"), Hkv, D), dtype=dtype)
    if case == "cache_slice":
        cache = torch.zeros((2, B, 3 * S, Hkv, D), dtype=dtype)
        k, v = cache[0, :, :S], cache[1, :, :S]
    ints = list(tfa.mask_inputs(q, k, None, None, None, None))
    if case == "int64_ids":
        ints[0] = ints[0].long()
    if case == "strided_ids":
        ints[2] = torch.zeros((B, 2 * S), dtype=torch.int32)[:, ::2]
    if case == "devices":
        ints[1] = ints[1].to("meta")
    return q, k, v, tuple(ints)


@pytest.mark.parametrize("case,error", [
    ("fits", None),
    ("head_dim_24", None),        # padded to 32 inside the kernel
    ("cache_slice", None),        # k / v read in place from a cache
    ("misaligned", ValueError),   # q's heads 2 bytes off 16
    ("head_dim_48", ValueError),
    ("f32", TypeError),
    ("shapes", ValueError),       # v has another Skv than k
    ("int64_ids", ValueError),
    ("strided_ids", ValueError),
    ("devices", ValueError),
])
def test_forward_kernel_layout_check(case, error):
    """The forward kernel's preconditions (bf16, a head dim it takes,
    shapes that fit, contiguous int32 ids and positions on q's device,
    heads it copies 16 bytes at a time) are checked before the launch from
    shapes, strides and addresses alone, so they are tested on the CPU; the
    strides it hands the kernel are the views' own."""
    q, k, v, ints = _layout_case(case)
    if error is not None:
        with pytest.raises(error):
            tfa.check_fwd_layout(q, k, v, ints)
        return
    strides = tfa.check_fwd_layout(q, k, v, ints)
    assert strides == q.stride()[:3] + k.stride()[:3] + v.stride()[:3]


def _kernel_listing_limit(D):
    """The most key tiles the forward kernel's shared memory holds, counted
    up tile by tile with its own layout (csrc/flash_attention_fwd.cu, Cfg):
    Q tiles, K / V / mask rings, 20 mbarriers, then two listings of 1,104
    bytes and 20 bytes a key tile, each 16-byte aligned, under the 232,448
    bytes a block may have, with 1 KB for alignment."""
    dp = 32 if D == 24 else D
    bk = 128 if dp >= 64 else 64
    list_off = (2 * 64 * dp * 2 + 2 * bk * dp * 2 + 3 * bk * dp * 2
                + 4 * 8 * bk + 8 * 20)

    def bytes_for(n):
        return 1024 + list_off + 2 * ((1104 + 20 * n + 15) // 16 * 16)

    n = 0
    while bytes_for(n + 1) <= 232448:
        n += 1
    return n * bk


@pytest.mark.parametrize("D", [16, 24, 32, 64, 128])
def test_forward_kernel_key_limit(D):
    """max_kv_len is the kernel's own limit at every head dim it takes:
    90,624 keys at D 128 (708 tiles of 128)."""
    assert tfa.max_kv_len(D) == _kernel_listing_limit(D)
    if D == 128:
        assert tfa.max_kv_len(D) == 90624


def test_forward_kernel_refuses_keys_beyond_its_limit():
    """One key past the limit raises a ValueError that names the limit
    before any launch (the layout check reads shapes only); at the limit
    the check passes."""
    limit = tfa.max_kv_len(128)
    q = torch.zeros((1, 16, 1, 128), dtype=torch.bfloat16)
    for skv in (limit, limit + 1):
        k = torch.zeros((1, skv, 1, 128), dtype=torch.bfloat16)
        ints = (torch.ones((1, 16), dtype=torch.int32),
                torch.ones((1, skv), dtype=torch.int32),
                torch.zeros((1, 16), dtype=torch.int32),
                torch.zeros((1, skv), dtype=torch.int32))
        if skv == limit:
            tfa.check_fwd_layout(q, k, k, ints)
        else:
            with pytest.raises(ValueError, match=str(limit)):
                tfa.check_fwd_layout(q, k, k, ints)
    with pytest.raises(ValueError):
        tfa.max_kv_len(48)
