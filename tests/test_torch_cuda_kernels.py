"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes beyond chip_smoke.py's: ESM2's full S=1026 (a ragged last key
tile), head dims 16 and 128, the unfused q/k/v layout, the fused MLP's
16-row block (d=2560) and its G=256 group.

Marked `cuda`: needs a CUDA device, and without one every test skips (the
fixture decides, at run time). This file imports torch only (the machine
with the card has no JAX), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from procyon_tpu_torch.ops import attention_rowblock as rb
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
    """cuBLASLt's int8 route is given at least 32 rows (ops/quant.int_mm
    pads); the product stays exact."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-127, 128, (5, 64), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 40), generator=g, device=cuda,
                      dtype=torch.int8)
    want = (a.double() @ b.double()).to(torch.int32)
    assert torch.equal(quant.int_mm(a, b), want)
