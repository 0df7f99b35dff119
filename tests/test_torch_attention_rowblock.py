"""procyon_tpu_torch row-block attention (the plain version of the CUDA
kernel) against procyon_tpu's Pallas `_rowblock_packed_kernel`, run in
interpret mode on the CPU, in f32 on the same numpy inputs.

Tolerance 2e-5 (abs and rel), as tests/test_flash_attention.py uses for the
Pallas kernels against mha_reference: both sides compute the same f32
function and differ only in the order of the f32 sums.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import attention_rowblock as jrb
from procyon_tpu.ops import rotary as jrot
from procyon_tpu_torch.ops import attention_rowblock as trb
from procyon_tpu_torch.ops import rotary as trot

TOL = dict(atol=2e-5, rtol=2e-5)


def _seg(B, S):
    """Padded rows, a packed second segment and (row 1) a dead batch row."""
    seg = np.ones((B, S), np.int32)
    seg[0, S - 27:] = 0
    seg[1, :] = 0
    if B > 2:
        seg[2, S // 2:] = 2
    return seg


def _tables(D, H, S):
    cos, sin, _ = jrot.flat_rotary_tables(D, H, S)
    return np.array(cos, np.float32), np.array(sin, np.float32)


@pytest.mark.parametrize("H,D,use_rope", [
    (2, 64, True),     # H*D = 128
    (4, 32, False),    # H*D = 128, no rotary: scale applied to the scores
    (4, 64, True),     # H*D = 256: the reference's 256-lane blocks
])
def test_packed_qkv_matches_pallas(H, D, use_rope):
    rng = np.random.default_rng(0)
    B, S = 3, 128
    HD = H * D
    qkv = rng.standard_normal((B, S, 3 * HD)).astype(np.float32)
    seg = _seg(B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    scale = 1.0 / math.sqrt(D)
    rope_j = rope_t = None
    if use_rope:
        c, s = _tables(D, H, S)
        rope_j = tuple(jnp.asarray(t) for t in (c, s, c, s))
        rope_t = tuple(torch.from_numpy(t) for t in (c, s, c, s))
    want = np.asarray(jrb.rowblock_packed_qkv_fwd(
        jnp.asarray(qkv), jnp.asarray(seg), jnp.asarray(pos),
        (False, scale, True, None), n_heads=H, head_dim=D, rope=rope_j))
    got = trb.rowblock_packed_qkv_fwd(
        torch.from_numpy(qkv), torch.from_numpy(seg), n_heads=H,
        head_dim=D, sm_scale=scale, rope=rope_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # dead rows (padding, and the all-padding batch row) are exactly zero
    assert not got[seg == 0].any()
    assert np.abs(got[seg > 0]).min(axis=-1).max() > 0


def test_separate_qkv_entry_matches_pallas():
    """rowblock_packed_fwd: separate [B, S, H, D] q/k/v, fused rotary."""
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 128, 4, 32
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    seg = _seg(B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    c, s = _tables(D, H, S)
    want, _ = jrb.rowblock_packed_fwd(
        *(jnp.asarray(a) for a in (q, k, v, seg, seg, pos, pos)),
        (False, 1.0 / math.sqrt(D), True, None),
        rope=tuple(jnp.asarray(t) for t in (c, s, c, s)))
    got = trb.rowblock_packed_fwd(
        *(torch.from_numpy(a) for a in (q, k, v, seg)),
        rope=tuple(torch.from_numpy(t) for t in (c, s, c, s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unpacked_route_matches_rowblock_fwd():
    """H*D = 64 is below the packed kernel's 128 lanes: the reference takes
    rowblock_fwd (scores scaled in the kernel, rotary applied outside);
    the port runs the same wrapper with the scale on the scores."""
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 128, 4, 16
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    seg = _seg(B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = jrb.rowblock_fwd(
        *(jnp.asarray(a) for a in (q, k, v, seg, seg, pos, pos)),
        (False, 1.0 / math.sqrt(D), True, None), want_lse=False)
    got = trb.rowblock_packed_fwd(*(torch.from_numpy(a)
                                    for a in (q, k, v, seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotary_tables_match():
    for D, H, L in ((64, 2, 130), (16, 4, 40)):
        jc, js, jp = jrot.flat_rotary_tables(D, H, L)
        tc, ts, tp = trot.flat_rotary_tables(D, H, L)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("device", ["meta"])
def test_wrapper_refuses_other_devices(device):
    """The wrapper runs the plain version only for CPU tensors; a tensor on
    any other non-CUDA device is refused, never silently computed."""
    x = torch.empty((1, 128, 128), device=device)
    seg = torch.empty((1, 128), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        trb.rowblock_attention(x, x, x, seg, head_dim=64, score_scale=1.0)
