"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes beyond chip_smoke.py's: ESM2's full S=1026 (a ragged last key
tile), head dims 16 and 128, the unfused q/k/v layout, the fused MLP's
16-row block (d=2560) and its G=256 group; the flash forward at ragged
lengths, every head dim, strided views, a cache shape and ESM2-35M's route.

Marked `cuda`: needs a CUDA device, and without one every test skips (the
fixture decides, at run time). This file imports torch only (the machine
with the card has no JAX), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from procyon_tpu_torch.ops import attention_rowblock as rb
from procyon_tpu_torch.ops import flash_attention as fa
from procyon_tpu_torch.ops import fused_mlp as fm
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.ops.rotary import flat_rotary_tables

pytestmark = pytest.mark.cuda


def _close(out, ref):
    """|kernel - plain| <= 2e-2 + one bf16 ulp (2^-7) of the value, as in
    chip_smoke.py: the attention kernel rounds P to bf16 against a running
    max (the plain version against the row max); in the MLP an int8
    rounding tie may take the neighbouring code."""
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= 2e-2 + 2.0 ** -7 * ref.abs()).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _seg(B, S, dev):
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    seg[0, S - S // 5:] = 0
    if B > 1:
        seg[1] = 0
    if B > 2:
        seg[2, S // 3:] = 2
    return seg


@pytest.mark.parametrize("B,S,H,D,use_rope", [
    (2, 1026, 4, 64, True),     # ESM2's max length: a ragged last tile
    (3, 200, 8, 16, True),
    (2, 130, 2, 128, False),    # scale on the scores, no rotary
])
def test_packed_attention_matches_plain(cuda, B, S, H, D, use_rope):
    g = torch.Generator(device=cuda).manual_seed(S + D)
    HD = H * D
    qkv = torch.randn((B, S, 3 * HD), generator=g, device=cuda).to(
        torch.bfloat16)
    seg = _seg(B, S, cuda)
    rope = None
    if use_rope:
        c, s, _ = flat_rotary_tables(D, H, S)
        rope = tuple(t.to(cuda, torch.bfloat16) for t in (c, s, c, s))
    sm = 1.0 / math.sqrt(D)
    before = rb.launches
    out = rb.rowblock_packed_qkv_fwd(qkv, seg, n_heads=H, head_dim=D,
                                     sm_scale=sm, rope=rope)
    assert rb.launches == before + 1
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    ref = rb.rowblock_attention_ref(
        q, k, v, seg, head_dim=D,
        score_scale=1.0 if use_rope else sm * rb.LOG2E,
        rope=rb.fold_rope(rope, sm) if use_rope else None)
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert not out[seg == 0].any().item()


def test_separate_qkv_attention_matches_plain(cuda):
    B, S, H, D = 2, 384, 20, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    seg = _seg(B, S, cuda)
    c, s, _ = flat_rotary_tables(D, H, S)
    rope = tuple(t.to(cuda, torch.bfloat16) for t in (c, s, c, s))
    out = rb.rowblock_packed_fwd(q, k, v, seg, rope=rope)
    ref = rb.rowblock_attention_ref(
        q.reshape(B, S, H * D), k.reshape(B, S, H * D),
        v.reshape(B, S, H * D), seg, head_dim=D, score_scale=1.0,
        rope=rb.fold_rope(rope, 1.0 / math.sqrt(D)))
    assert _close(out.reshape(B, S, H * D), ref)


def test_attention_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 128, 3 * 96), device=cuda)
    seg = torch.ones((1, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):      # f32 on the card
        rb.rowblock_packed_qkv_fwd(x, seg, n_heads=4, head_dim=24)
    with pytest.raises(ValueError):     # head_dim 24
        rb.rowblock_packed_qkv_fwd(x.to(torch.bfloat16), seg, n_heads=4,
                                   head_dim=24)


@pytest.mark.parametrize("M,d,H", [(512, 128, 512), (1024, 2560, 10240)])
@pytest.mark.parametrize("add_residual", [False, True])
def test_fused_mlp_matches_plain(cuda, M, d, H, add_residual):
    g = torch.Generator(device=cuda).manual_seed(M + d)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale

    w1 = quant.quantize(randn(d, H, scale=d ** -0.5))
    w2 = quant.quantize(randn(H, d, scale=H ** -0.5))
    args = (randn(M, d).to(torch.bfloat16),
            (1 + randn(d, scale=0.1)).to(torch.bfloat16),
            randn(d, scale=0.1).to(torch.bfloat16), w1["q"], w1["s"],
            randn(H, scale=0.1).to(torch.bfloat16), w2["q"], w2["s"],
            randn(d, scale=0.1).to(torch.bfloat16))
    before = fm.launches
    out = fm.fused_ln_mlp_int8(*args, add_residual=add_residual)
    assert fm.launches == before + 1
    ref = fm.fused_ln_mlp_int8_ref(*args, add_residual=add_residual)
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert (out.float() - ref.float()).abs().mean().item() <= 2e-3


def test_int_mm_short_inputs_are_exact(cuda):
    """torch._int_mm's CUDA route is given at least 32 rows
    (ops/quant.int_mm pads); the product stays exact."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-127, 128, (5, 64), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 40), generator=g, device=cuda,
                      dtype=torch.int8)
    want = (a.double() @ b.double()).to(torch.int32)
    assert torch.equal(quant.int_mm(a, b), want)


def _flash_inputs(dev, B, Sq, Skv, Hq, Hkv, D, seed):
    """q, k, v as strided views of flat [B, S, (Hq + 2 Hkv) * D]
    projections when Sq == Skv, else q fresh and k/v a slice of a longer
    cache; int64 segment ids and positions, as numpy collators give them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if Sq == Skv:
        flat = torch.randn((B, Sq, (Hq + 2 * Hkv) * D), generator=g,
                           device=dev).to(torch.bfloat16)
        q = flat[..., :Hq * D].reshape(B, Sq, Hq, D)
        k = flat[..., Hq * D:(Hq + Hkv) * D].reshape(B, Skv, Hkv, D)
        v = flat[..., (Hq + Hkv) * D:].reshape(B, Skv, Hkv, D)
    else:
        q = torch.randn((B, Sq, Hq, D), generator=g, device=dev).to(
            torch.bfloat16)
        cache = torch.randn((2, B, Skv + 9, Hkv, D), generator=g,
                            device=dev).to(torch.bfloat16)
        k, v = cache[0, :, :Skv], cache[1, :, :Skv]
    seg_q = _seg(B, Sq, dev).long()
    seg_kv = _seg(B, Skv, dev).long()
    if Sq != Skv:
        seg_q = torch.ones((B, Sq), dtype=torch.long, device=dev)
        seg_kv[:] = 1
        seg_kv[:, Skv - 17:] = 0                  # the cache's empty tail
    return q, k, v, seg_q, seg_kv


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (3, 200, 200, 8, 2, 128, True),     # ragged tiles, GQA 4
    (3, 130, 130, 4, 4, 16, False),
    (2, 257, 257, 6, 3, 24, True),
    (3, 512, 512, 4, 2, 32, False),
    (2, 300, 300, 4, 1, 64, True),
    (2, 48, 333, 8, 2, 128, True),      # new tokens over a cache
    (1, 3, 20, 2, 1, 16, True),         # a few rows in one ragged tile
    (5, 70, 70, 1, 1, 32, False),
])
def test_flash_forward_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, causal):
    q, k, v, seg_q, seg_kv = _flash_inputs(cuda, B, Sq, Skv, Hq, Hkv, D,
                                           Sq + D)
    q_pos = kv_pos = None
    if Sq != Skv:
        q_pos = torch.arange(Skv - 17 - Sq, Skv - 17,
                             device=cuda).expand(B, Sq)
        kv_pos = torch.arange(Skv, device=cuda).expand(B, Skv)
    before = fa.launches
    out = fa.flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                             q_positions=q_pos, kv_positions=kv_pos)
    assert fa.launches == before + 1
    ints = fa.mask_inputs(q, k, seg_q, seg_kv, q_pos, kv_pos)
    sm = 1.0 / math.sqrt(D)
    ref, ref_lse = fa.flash_fwd_ref(q, k, v, *ints, causal=causal,
                                    sm_scale=sm)
    torch.cuda.synchronize()
    assert out.shape == (B, Sq, Hq, D) and torch.isfinite(out.float()).all()
    assert _close(out, ref)
    assert not out[seg_q == 0].any().item()
    # unbounded (no tile skipping above the diagonal) and with lse
    out2, lse = fa.flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm,
                             want_lse=True)
    assert _close(out2, ref)
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    assert (lse[~live] == -1e30).all()
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-3


def test_rowblock_fwd_esm2_35m_shape_and_model_route(cuda):
    """head_dim 24 (ESM2-35M): the packed kernel does not apply, so
    attn_backend="rowblock" lands in the function rowblock_fwd computes,
    i.e. the flash kernel's source; the model's layers all go through it."""
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import esm2
    B, S, H, D = 2, 256, 20, 24
    q, k, v, seg, _ = _flash_inputs(cuda, B, S, S, H, H, D, 5)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    sm = 1.0 / math.sqrt(D)
    out, lse = rb.rowblock_fwd(q, k, v, *ints, causal=False, sm_scale=sm)
    ref, ref_lse = fa.flash_fwd_ref(q, k, v, *ints, causal=False,
                                    sm_scale=sm)
    assert _close(out, ref)
    live = ref_lse > -1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-3

    cfg = esm2.esm2_config("35m", n_layers=3, max_seq_len=S,
                           attn_backend="rowblock")
    params = esm2.init_params(0, cfg, device=cuda)
    tokens = torch.randint(4, 24, (B, S), device=cuda)
    tokens[0, S - 40:] = esm2.PAD_IDX
    before = (fa.launches, rb.launches)
    hidden = esm2.forward(params, cfg, tokens)["hidden"]
    assert (fa.launches - before[0], rb.launches - before[1]) == (3, 0)
    cfg32 = esm2.esm2_config("35m", n_layers=3, max_seq_len=S,
                             attn_backend="ref", dtype=torch.float32)
    want = esm2.forward(bridge.to_torch(bridge.to_numpy(params)), cfg32,
                        tokens.cpu())["hidden"]
    valid = (tokens != esm2.PAD_IDX).cpu()
    cos = torch.nn.functional.cosine_similarity(
        hidden.float().cpu()[valid], want[valid], dim=-1)
    assert cos.min().item() >= 0.99


def test_flash_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 64, 4, 16), device=cuda)
    with pytest.raises(TypeError):      # f32 on the card
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 64, 4, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # head_dim 48
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):     # the CPU reference on a CUDA tensor
        fa.flash_attention(q[..., :16].contiguous(), q[..., :16].contiguous(),
                           q[..., :16].contiguous(), backend="ref")
    with pytest.raises(ValueError):     # a transposed head
        t = torch.zeros((1, 64, 16, 4), device=cuda, dtype=torch.bfloat16)
        fa.flash_attention(*(t.transpose(2, 3),) * 3)


def test_llama_prefill_and_cache_on_the_card_match_the_cpu(cuda):
    """Llama in bf16 on the card (flash kernel at prefill, over the dense
    cache with Sq != Skv, the plain decode step at S == 1) against the same
    weights in f32 on the CPU: logits within 0.1 of a unit-scale range and
    per-row cosine >= 0.99 (bf16 through 2 layers)."""
    from procyon_tpu_torch import bridge
    from procyon_tpu_torch.models import llama
    cfg = llama.tiny_config(dim=256, n_heads=4, n_kv_heads=2,
                            intermediate=512, vocab_size=512,
                            dtype=torch.bfloat16, max_seq_len=256)
    cfg32 = llama.tiny_config(dim=256, n_heads=4, n_kv_heads=2,
                              intermediate=512, vocab_size=512,
                              max_seq_len=256)
    params = llama.init_params(3, cfg, device=cuda)
    p32 = bridge.to_torch(bridge.to_numpy(params))
    g = torch.Generator().manual_seed(0)
    B = 2
    cache = llama.init_kv_cache(cfg, B, 128, device=cuda)
    cache32 = llama.init_kv_cache(cfg32, B, 128, device="cpu")
    start = 0
    before = fa.launches
    for n in (70, 5, 1):
        tokens = torch.randint(3, 512, (B, n), generator=g)
        pos = torch.arange(start, start + n).expand(B, n)
        got = llama.forward(params, cfg, tokens=tokens.to(cuda),
                            positions=pos.to(cuda), kv_cache=cache)
        want = llama.forward(p32, cfg32, tokens=tokens, positions=pos,
                             kv_cache=cache32)
        cache, cache32 = got["kv_cache"], want["kv_cache"]
        a, b = got["logits"].float().cpu(), want["logits"]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        assert cos.min().item() >= 0.99, (n, cos.min().item())
        assert (a - b).abs().max().item() <= 0.1, n
        start += n
    # two layers x (prefill of 70, block of 5); the S == 1 step is plain
    assert fa.launches - before == 4
    no_cache = llama.forward(params, cfg, tokens=tokens.to(cuda))
    assert torch.isfinite(no_cache["logits"]).all()
