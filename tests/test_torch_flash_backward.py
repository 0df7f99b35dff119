"""procyon_tpu_torch's flash-attention backward (the autograd Function
around the flash forward, whose backward on a CPU tensor is flash_bwd_ref,
the plain version of the CUDA kernels) against jax.grad of procyon_tpu's
flash_attention with the Pallas kernels in interpret mode, and of its
mha_reference, for q, k and v on the same numpy inputs.

f32 tolerance 1e-4 (abs and rel): the same f32 function, differentiated
through the kernels' formulation (p against the forward's log-sum-exp in
base 2, delta from the forward's output) on one side and by autodiff on
the other. bf16 case: each element within 2e-2 of the largest gradient
plus one bf16 ulp (2^-7) of itself, against the f32 gradients of the same
bf16-rounded inputs (the port rounds p and ds to bf16 before the products,
as the kernels do). Rows and keys that nothing allows get exact zeros.

Also: the kernel wrappers that have no backward refuse inputs that require
grad (on a meta tensor, standing in for a device), rather than return an
output cut from the graph.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu_torch.ops import attention_rowblock as trb
from procyon_tpu_torch.ops import flash_attention as tfa
from procyon_tpu_torch.ops import fused_mlp as tfm
from procyon_tpu_torch.ops import int4_matmul as tint4
from procyon_tpu_torch.ops import page_move as tpm
from procyon_tpu_torch.ops import paged_attention as tpa
from torch_cpu_common import one_torch_thread  # noqa: F401

jfa = importlib.import_module("procyon_tpu.ops.flash_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_SHARE = 2e-2
BF16_ULP = 2.0 ** -7
D = 16


def _inputs(rng, B, S, Hq, Hkv):
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, k, v, do


def _segments(B, S):
    """Row 0 right-padded, row 1 packed in two segments, row 2 left-padded,
    row 3 dead."""
    seg = np.ones((B, S), np.int32)
    seg[0, S - 19:] = 0
    seg[1, S // 3:] = 2
    seg[2, :S // 2 + 5] = 0
    seg[3] = 0
    return seg


def _jax_grads(fn, q, k, v, do):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * jnp.asarray(do))

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, do, dtype=torch.float32, **kw):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do).to(dtype))
    return qt.grad, kt.grad, vt.grad


def _check_dead(grads, seg_q, seg_kv):
    dq, dk, dv = grads
    assert not dq[torch.from_numpy(seg_q == 0)].any()
    assert not dk[torch.from_numpy(seg_kv == 0)].any()
    assert not dv[torch.from_numpy(seg_kv == 0)].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_grads_match_pallas_and_reference(causal, Hq, Hkv):
    """S 96 (not a multiple of the 64-row tiles), padded, packed and dead
    rows."""
    rng = np.random.default_rng(Hkv + 10 * causal)
    B, S = 4, 96
    q, k, v, do = _inputs(rng, B, S, Hq, Hkv)
    seg = _segments(B, S)
    js = jnp.asarray(seg)
    pallas = _jax_grads(lambda a, b, c: jfa.flash_attention(
        a, b, c, js, js, causal=causal, backend="pallas", interpret=True),
        q, k, v, do)
    ref = _jax_grads(lambda a, b, c: jfa.mha_reference(
        a, b, c, js, js, causal=causal), q, k, v, do)
    seg_t = torch.from_numpy(seg)
    got = _port_grads(q, k, v, do, seg_q=seg_t, seg_kv=seg_t, causal=causal)
    for g, want_p, want_r in zip(got, pallas, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_r), **TOL)
    _check_dead(got, seg, seg)


def test_grads_with_positions_match_pallas_and_reference():
    """Positions given (a left-padded prompt whose positions restart after
    the padding, and a row offset by 37): the kernels compare positions and
    may not bound the tiles. dq against the Pallas kernels and all three
    against mha_reference: procyon_tpu's _bwd_dkv_kernel drops the causal
    compare when positions are given (with `bounded` false its causal loop
    runs from 0 to lo_interior = 0, and every q tile takes the loop without
    the compare), so its dk and dv there are not the gradient of its
    forward; the port's kernels and plain version keep the compare."""
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv = 2, 80, 4, 2
    q, k, v, do = _inputs(rng, B, S, Hq, Hkv)
    seg = np.ones((B, S), np.int32)
    seg[1, :30] = 0
    pos = np.stack([np.arange(S) + 37,
                    np.maximum(np.arange(S) - 30, 0)]).astype(np.int32)
    js, jp = jnp.asarray(seg), jnp.asarray(pos)
    pallas = _jax_grads(lambda a, b, c: jfa.flash_attention(
        a, b, c, js, js, causal=True, q_positions=jp, kv_positions=jp,
        backend="pallas", interpret=True), q, k, v, do)
    ref = _jax_grads(lambda a, b, c: jfa.mha_reference(
        a, b, c, js, js, causal=True, q_positions=jp, kv_positions=jp),
        q, k, v, do)
    seg_t, pos_t = torch.from_numpy(seg), torch.from_numpy(pos)
    got = _port_grads(q, k, v, do, seg_q=seg_t, seg_kv=seg_t, causal=True,
                      q_positions=pos_t, kv_positions=pos_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas[0]), **TOL)
    for g, want in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)
    _check_dead(got, seg, seg)


def test_bf16_grads_match_reference():
    """bf16 inputs through the Function (the kernels' cast points) against
    the f32 reference gradients of the same bf16-rounded inputs."""
    rng = np.random.default_rng(9)
    B, S, Hq, Hkv = 4, 96, 4, 2
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in _inputs(rng, B, S, Hq, Hkv))
    seg = _segments(B, S)
    js = jnp.asarray(seg)
    ref = _jax_grads(lambda a, b, c: jfa.mha_reference(
        a, b, c, js, js, causal=True), q, k, v, do)
    seg_t = torch.from_numpy(seg)
    got = _port_grads(q, k, v, do, dtype=torch.bfloat16, seg_q=seg_t,
                      seg_kv=seg_t, causal=True)
    for g, want in zip(got, ref):
        assert g.dtype == torch.bfloat16
        g, want = g.float().numpy(), np.asarray(want)
        bound = BF16_SHARE * np.abs(want).max() + BF16_ULP * np.abs(want)
        assert (np.abs(g - want) <= bound).all(), np.abs(g - want).max()
    _check_dead(got, seg, seg)


def test_plain_backward_is_the_function_backward():
    """flash_bwd on CPU tensors is flash_bwd_ref, and the Function hands
    it the forward's out and lse; without grad no Function is built."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(rng, 2, 40, 4, 2))
    seg = torch.from_numpy(_segments(4, 40)[:2])
    got = _port_grads(*(t.numpy() for t in (q, k, v, do)), seg_q=seg,
                      seg_kv=seg, causal=True)
    ints = tfa.mask_inputs(q, k, seg, seg, None, None)
    sm = D ** -0.5
    out, lse = tfa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=sm,
                             bounded=True, want_lse=True)
    want = tfa.flash_bwd(q, k, v, *ints, out, lse, do, causal=True,
                         sm_scale=sm, bounded=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert tfa.flash_attention(q.requires_grad_(), k, v, seg, seg,
                                   causal=True).grad_fn is None
    with pytest.raises(ValueError, match="device"):
        tfa.flash_bwd(*(t.to("meta") for t in (q, k, v)), *ints, out, lse,
                      do, causal=True, sm_scale=sm)


def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad and dtype.is_floating_point)


def _wrapper_calls(grad):
    i32 = dict(dtype=torch.int32, grad=False)
    x = _meta(1, 128, 3 * 128, grad=grad)
    q4 = _meta(1, 128, 2, 64, grad=grad)
    seg = _meta(1, 128, **i32)
    mlp = _meta(128, 64, grad=grad)
    w = _meta(64, 64, dtype=torch.int8)
    s = _meta(1, 64, dtype=torch.float32, grad=False)
    b = _meta(64, grad=grad)
    pool = _meta(6, 8, 32, grad=grad)
    idx = torch.tensor([0, 1], dtype=torch.int32, device="meta")
    dst = torch.tensor([2, 3], dtype=torch.int32, device="meta")
    return {
        "rowblock_packed_qkv_fwd": lambda: trb.rowblock_packed_qkv_fwd(
            x, seg, n_heads=2, head_dim=64),
        "rowblock_packed_fwd": lambda: trb.rowblock_packed_fwd(
            q4, q4, q4, seg),
        "rowblock_fwd": lambda: trb.rowblock_fwd(
            q4, q4, q4, seg, seg, seg, seg, causal=True, sm_scale=0.125),
        "flash_fwd": lambda: tfa.flash_fwd(
            q4, q4, q4, seg, seg, seg, seg, causal=True, sm_scale=0.125),
        "fused_ln_mlp_int8": lambda: tfm.fused_ln_mlp_int8(
            mlp, b, b, w, s, b, w, s, b),
        "qmatvec4": lambda: tint4.qmatvec4(
            _meta(2, 256, grad=grad),
            {"p": _meta(128, 64, dtype=torch.int8),
             "s": _meta(2, 64, dtype=torch.float32, grad=False)}),
        "move_pages_direct": lambda: tpm.move_pages_direct(pool, idx, dst),
        "paged_decode_attention_fullpage":
            lambda: tpa.paged_decode_attention_fullpage(
                _meta(2, 4, 16, grad=grad), pool, pool,
                _meta(2, 2, **i32), _meta(2, **i32), n_kv_heads=2,
                head_dim=16),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls(True)))
def test_wrappers_without_backward_refuse_grad(name):
    """Under grad, a kernel wrapper with no backward raises before it
    launches; with grad off the same call reaches the device dispatch,
    which refuses the meta device."""
    with pytest.raises(RuntimeError, match="no backward"):
        _wrapper_calls(True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        _wrapper_calls(True)[name]()


@pytest.mark.parametrize("case,error", [
    ("fits", None),
    ("head_dim_24", None),        # padded to 32 inside the dk / dv kernel
    ("misaligned", ValueError),   # q's heads 2 bytes off 16
    ("head_dim_48", ValueError),
    ("f32", TypeError),
    ("out_misaligned", ValueError),   # out is read for delta, 16 bytes
    ("out_f32", TypeError),
])
def test_backward_kernel_layout_check(case, error):
    """The backward kernels' preconditions (bf16, a head dim they take,
    heads they copy 16 bytes at a time) are checked before the launch from
    shapes, strides and addresses alone, so they are tested on the CPU.
    The dq kernel also reads out (for delta), so out is held to the same."""
    B, S, Hq, Hkv = 2, 64, 4, 2
    D = {"head_dim_24": 24, "head_dim_48": 48}.get(case, 64)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    off = 1 if case == "misaligned" else 0
    flat = torch.zeros((B, S, (Hq + 2 * Hkv) * D + 8), dtype=dtype)
    q = flat[..., off:off + Hq * D].reshape(B, S, Hq, D)
    k = flat[..., Hq * D + 8:(Hq + Hkv) * D + 8].reshape(B, S, Hkv, D)
    v = torch.zeros((B, S, Hkv, D), dtype=dtype)
    ints = tfa.mask_inputs(q, k, None, None, None, None)
    out, do = torch.zeros_like(q), torch.zeros_like(q)
    if case == "out_misaligned":
        out = torch.zeros((B, S, Hq * D + 1), dtype=dtype)[
            ..., 1:].reshape(B, S, Hq, D)
    if case == "out_f32":
        out = out.float()
    lse = torch.zeros((B, Hq, S))
    if error is None:
        strides = tfa.check_bwd_layout(q, k, v, ints, out, lse, do)
        assert strides == sum((t.stride()[:3] for t in (q, k, v, do, out)),
                              ())
    else:
        with pytest.raises(error):
            tfa.check_bwd_layout(q, k, v, ints, out, lse, do)
