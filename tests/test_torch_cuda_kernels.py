"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes beyond chip_smoke.py's: ESM2's full S=1026 (a ragged last key
tile), head dims 16 and 128, the unfused q/k/v layout, the fused MLP's
widths of ESM2-8M, -650M and -3B, its G=256 group and rows that fill no
tile, twice for the same bits, its hidden codes against the plain stage,
and shapes it refuses; the flash forward at ragged
lengths, every head dim, strided views, a cache shape and ESM2-35M's route,
and at D 128 over five query tiles with leading padding and a packed row
(fully masked leading key tiles add nothing), from a cache slice, over
more query tiles than two rounds of the persistent grid and with 1-3 new
rows over a long cache, twice for the same bits; the flash backward (dq;
dk and dv) at the same shapes, at D 24 and 128 with groups of 1 and 4 and
over a cache, at the training shape, and through the autograd Function,
each twice for the same bits,
and with its delta buffer handed a freed block of NaN (every row written
by the dq kernel); the
row-block attention at one query tile, ESM2-3B's 40 heads, every head
dim, a row whose leading key tiles are padding, twice for the same bits;
the page move on bf16, int8 and f32 rows, direct and staged (swaps,
cycles, chains, a full permutation that overflows the staging scratch, no
overlap, one move, 2,560 moves from repeated sources: the only test of
the staged move's order; two launches the same bits); the LN + row
quantization at one row, ragged rows, d 320 to 6144, twice for the same
bits, and the two-pass MLP at ESM2-3B's widths and every group they
take; the fused decode MLP at every row count from 1 to 16; the
RMSNorm + W8A8 SwiGLU MLP at every group it takes (128 to 512 columns),
ragged rows, d 4096, the Bind prefill's shape, three and four groups a
block_n step, on K-major views and on contiguous weights (the same
bits); the paged decode attention at
other head dims, groups and page sizes, bf16 and int8 pools, serving's 16
slots and 8 with whole chunks of the page walk dead, against the plain
version and its chunked cut, twice for the same bits; the int4 matmul at
the five Llama-3-8B weight shapes (n cut where it can be), rows 1 to 256,
groups of 64 and 128, at full size at 16 rows twice for the same bits, one
device kernel a call, and one batcher run with int4 weights; at BERT's
shape (H 12, D 64, bidirectional, right-padded rows, a row of padding
alone) the flash forward against its plain version, its dead rows 0 bit
for bit with NaN / inf in every padded row, padded keys that change no
live row, and a BERT-base forward on the card against the CPU in f32.

Marked `cuda`: needs a CUDA device, and without one every test skips (the
fixture decides, at run time). This file imports torch only (the machine
with the card has no JAX), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import dataclasses
import math

import pytest
import torch

from procyon_tpu_torch.ops import attention_rowblock as rb
from procyon_tpu_torch.ops import flash_attention as fa
from procyon_tpu_torch.ops import fused_decode as fd
from procyon_tpu_torch.ops import fused_mlp as fm
from procyon_tpu_torch.ops import int4_matmul as i4
from procyon_tpu_torch.ops import page_move as pm
from procyon_tpu_torch.ops import paged_attention as pa
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
    (3, 128, 4, 64, True),      # one query tile, two key tiles
    (2, 512, 40, 64, True),     # ESM2-3B's heads
    (3, 200, 8, 16, True),
    (3, 256, 4, 32, True),
    (2, 130, 2, 128, False),    # scale on the scores, no rotary
    (2, 384, 4, 128, True),
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


def test_packed_attention_leading_padding_and_repeats(cuda):
    """A row whose first 200 keys are padding (the kernel never loads its
    first three key tiles, and a running max of -1e30 must not leak into
    the live rows) and a row with padding in the middle of a tile; two
    launches on the same inputs give the same bits."""
    B, S, H, D = 4, 512, 4, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    HD = H * D
    qkv = torch.randn((B, S, 3 * HD), generator=g, device=cuda).to(
        torch.bfloat16)
    seg = _seg(B, S, cuda)
    seg[3, :200] = 0
    seg[2, 300:310] = 0
    c, s, _ = flat_rotary_tables(D, H, S)
    rope = tuple(t.to(cuda, torch.bfloat16) for t in (c, s, c, s))
    sm = 1.0 / math.sqrt(D)
    out = rb.rowblock_packed_qkv_fwd(qkv, seg, n_heads=H, head_dim=D,
                                     sm_scale=sm, rope=rope)
    again = rb.rowblock_packed_qkv_fwd(qkv, seg, n_heads=H, head_dim=D,
                                       sm_scale=sm, rope=rope)
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    ref = rb.rowblock_attention_ref(q, k, v, seg, head_dim=D,
                                    score_scale=1.0,
                                    rope=rb.fold_rope(rope, sm))
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert not out[seg == 0].any().item()
    assert torch.equal(out, again)


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


@pytest.mark.parametrize("M,d,H", [
    (512, 128, 512),        # G 256
    (1024, 2560, 10240),    # ESM2-3B's widths
    (4096, 1280, 5120),     # ESM2-650M's
    (512, 320, 1024),       # ESM2-8M's d: a ragged 128-column tile
    (40, 1280, 5120),       # rows that fill no tile
])
@pytest.mark.parametrize("add_residual", [False, True])
def test_fused_mlp_matches_plain(cuda, M, d, H, add_residual):
    """Within _close and a mean of 2e-3 of the plain version, the same bits
    from a second launch, and the hidden codes the kernels pass between
    them equal to the plain up stage on the kernels' own row codes but at
    rounding ties."""
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
    assert torch.equal(out, fm.fused_ln_mlp_int8(
        *args, add_residual=add_residual))
    _, (xq, sx, gq, sg) = fm._launch_mlp("one_pass", *args, 1e-5,
                                         add_residual)
    own, own_sg = fm.gelu_codes_ref(xq, sx, *args[3:6],
                                    fm.requant_group(H))
    diff = (gq.int() - own.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3
    assert ((sg - own_sg).abs() <= 1e-6 * own_sg).all()


def test_fused_mlp_refuses_what_it_cannot_take(cuda):
    """Shapes and types the kernels do not take raise before a launch."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((512, 128), generator=g, device=cuda).to(torch.bfloat16)
    ln = torch.ones(128, device=cuda)

    def weights(d, H):
        w1 = quant.quantize(torch.randn((d, H), generator=g, device=cuda))
        w2 = quant.quantize(torch.randn((H, d), generator=g, device=cuda))
        return (w1["q"], w1["s"], torch.zeros(H, device=cuda), w2["q"],
                w2["s"], torch.zeros(d, device=cuda))

    before = fm.launches
    with pytest.raises(ValueError):     # H 1280: a group of 128
        fm.fused_ln_mlp_int8(x, ln, ln, *weights(128, 1280))
    with pytest.raises(ValueError):     # d 96, not a multiple of 64
        fm.fused_ln_mlp_int8(x[:, :96].contiguous(), ln[:96], ln[:96],
                             *weights(96, 1024))
    with pytest.raises(TypeError):      # f32 rows
        fm.fused_ln_mlp_int8(x.float(), ln, ln, *weights(128, 512))
    with pytest.raises(ValueError):     # weights the wrong way round
        w = weights(128, 512)
        fm.fused_ln_mlp_int8(x, ln, ln, w[3], w[1], w[2], w[0], w[4], w[5])
    with pytest.raises(ValueError):     # the two-pass form: no group
        fm.fused_mlp_int8_prequant(x, ln, ln, *weights(128, 192))
    assert fm.launches == before


def _mlp_args(dev, M, d, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    w1 = quant.quantize(randn(d, H, scale=d ** -0.5))
    w2 = quant.quantize(randn(H, d, scale=H ** -0.5))
    return (randn(M, d).to(torch.bfloat16),
            (1 + randn(d, scale=0.1)).to(torch.bfloat16),
            randn(d, scale=0.1).to(torch.bfloat16), w1["q"], w1["s"],
            randn(H, scale=0.1).to(torch.bfloat16), w2["q"], w2["s"],
            randn(d, scale=0.1).to(torch.bfloat16))


@pytest.mark.parametrize("M,d", [(512, 256), (1024, 2560), (40, 5120),
                                 (1, 2560), (333, 1280), (333, 320),
                                 (64, 6144)])
def test_ln_quant_rows_matches_plain(cuda, M, d):
    """Codes equal but at rounding ties (at most 1e-3 of them, one step),
    scales within 1e-6 relative; one row, ragged rows over the persistent
    grid, ESM2-8M's d 320 and the widest row it takes; two launches
    bitwise equal."""
    x, lnw, lnb = _mlp_args(cuda, M, d, 256, M + d)[:3]
    before = fm.launches_ln_quant
    xq, sx = fm.ln_quant_rows(x, lnw, lnb)
    assert fm.launches_ln_quant == before + 1
    again = fm.ln_quant_rows(x, lnw, lnb)
    assert torch.equal(again[0], xq) and torch.equal(again[1], sx)
    rq, rs = fm.ln_quant_rows_ref(x, lnw, lnb)
    torch.cuda.synchronize()
    assert sx.shape == (M, 1) and xq.dtype == torch.int8
    diff = (xq.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3
    assert ((sx - rs).abs() <= 1e-6 * rs).all()


@pytest.mark.parametrize("M,d,H", [(512, 128, 1024), (1024, 2560, 10240),
                                   (512, 128, 768), (256, 512, 1920),
                                   (512, 320, 1280), (200, 128, 768)])
@pytest.mark.parametrize("add_residual", [False, True])
def test_prequant_mlp_matches_plain(cuda, M, d, H, add_residual):
    """Groups 256 (two a step), 128 (two a step) and 128 (one a step),
    ESM2-8M's MLP (d 320, H 1280) and rows that fill no tile; the one-pass
    kernel's tolerance."""
    args = _mlp_args(cuda, M, d, H, M + H)
    before = (fm.launches_ln_quant, fm.launches_prequant)
    out = fm.fused_mlp_int8_prequant(*args, add_residual=add_residual)
    assert (fm.launches_ln_quant, fm.launches_prequant) == (
        before[0] + 1, before[1] + 1)
    ref = fm.fused_mlp_int8_prequant_ref(*args, add_residual=add_residual)
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert (out.float() - ref.float()).abs().mean().item() <= 2e-3
    assert torch.equal(out, fm.fused_mlp_int8_prequant(
        *args, add_residual=add_residual))


def _decode_args(dev, M, d, I, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    sc = 1.0 / (127.0 * math.sqrt(d))

    def leaf(rows, cols):
        return {"q": torch.randint(-127, 128, (rows, cols), generator=g,
                                   device=dev, dtype=torch.int8),
                "s": torch.rand((1, cols), generator=g, device=dev) * 2 * sc}

    x = torch.randn((M, d), generator=g, device=dev).to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    return x, nw, leaf(d, I), leaf(d, I), leaf(I, d)


@pytest.mark.parametrize("M", range(1, 17))
def test_fused_decode_mlp_every_row_count(cuda, M):
    """Every row count the kernels take, at d 256, I 1024: within 2e-3 +
    one bf16 ulp of the plain version and bitwise the same twice."""
    args = _decode_args(cuda, M, 256, 1024, 100 + M)
    out = fd.fused_decode_mlp(*args)
    ref = fd.fused_decode_mlp_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert (err <= 2e-3 + 2.0 ** -7 * ref.float().abs()).all()
    assert torch.equal(out, fd.fused_decode_mlp(*args))


@pytest.mark.parametrize("M", [1, 5, 8, 16])
@pytest.mark.parametrize("d,I", [(128, 512), (4096, 14336)])
def test_fused_decode_mlp_matches_plain(cuda, M, d, I):
    """|kernel - plain| <= 2e-3 + one bf16 ulp of the value: both round
    the output once; a, rounded to bf16 after sums in another order, may
    take the neighbouring value. Bitwise the same on a second launch."""
    args = _decode_args(cuda, M, d, I, M + d)
    before = fd.launches
    out = fd.fused_decode_mlp(*args)
    assert fd.launches == before + 1
    ref = fd.fused_decode_mlp_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert (err <= 2e-3 + 2.0 ** -7 * ref.float().abs()).all()
    assert torch.equal(out, fd.fused_decode_mlp(*args))


def test_fused_decode_mlp_refuses_what_it_cannot_take(cuda):
    x, nw, wg, wu, wd = _decode_args(cuda, 17, 128, 512, 0)
    with pytest.raises(ValueError, match="M <= 16"):
        fd.fused_decode_mlp(x, nw, wg, wu, wd)
    with pytest.raises(TypeError, match="bf16"):
        fd.fused_decode_mlp(x[:4].float(), nw, wg, wu, wd)
    with pytest.raises(ValueError, match="int8"):
        fd.fused_decode_mlp(x[:4], nw, {"q": wg["q"].to(torch.int16),
                                        "s": wg["s"]}, wu, wd)
    with pytest.raises(RuntimeError, match="grad"):
        fd.fused_decode_mlp(x[:4].requires_grad_(), nw, wg, wu, wd)


def _swiglu_args(dev, M, d, H, seed, k_major=True):
    """x, the norm weight and the int8 [in, out] weights with their scales;
    with k_major the weights are views of [out, in] storage, the layout
    the kernels read without a copy (fm.SWIGLU_WEIGHT_LAYOUT)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    ws = [quant.quantize(randn(*shape, scale=shape[0] ** -0.5))
          for shape in ((d, H), (d, H), (H, d))]
    if k_major:
        for w in ws:
            w["q"] = w["q"].t().contiguous().t()
    return [randn(M, d).to(torch.bfloat16),
            (1 + randn(d, scale=0.1)).to(torch.bfloat16)] \
        + [t for w in ws for t in (w["q"], w["s"])]


def _swiglu_within_steps(out, ref, args, G, block_n):
    """The error beyond one bf16 ulp of the plain value at most 16
    hidden-code steps (a row's largest group scale times the largest |down
    weight| of the column), at most 1% of the elements more than one ulp
    off: chip_smoke.py's check of row 7."""
    xq, sx = fm.rms_quant_rows_ref(args[0], args[1])
    _, sa = fm.swiglu_codes_ref(xq, sx, *args[2:6], G)
    step = sa.amax(1, keepdim=True) * (
        args[6].abs().amax(0, keepdim=True).float() * args[7].float())
    err = (out.float() - ref.float()).abs()
    ulp = 2.0 ** -7 * ref.float().abs()
    return ((err - ulp).clamp_min(0) / step).max().item() <= 16.0 \
        and (err > ulp).float().mean().item() <= 1e-2


@pytest.mark.parametrize("M,d,H,block_n,G", [
    (200, 256, 512, 512, 256),      # ragged rows: 200 = 3 x 64 + 8
    (128, 128, 384, 512, 384),      # three 128-column tiles a group
    (96, 512, 2048, 1024, 512),     # four
    (256, 2560, 10240, 512, 256),
    (64, 4096, 1024, 512, 128),     # d 4096: block_n capped at 256
])
def test_fused_rms_swiglu_matches_plain(cuda, M, d, H, block_n, G):
    """Kernel row 7 against its plain version as chip_smoke.py holds it:
    the error beyond one bf16 ulp at most 16 hidden-code steps (a row's
    largest group scale times the largest |down weight| of the column),
    at most 1% of the elements more than one ulp off; bitwise the same on
    a second launch; one count a call."""
    assert fm.swiglu_group(d, H, block_n) == G
    args = _swiglu_args(cuda, M, d, H, M + H)
    before = fm.launches_swiglu
    out = fm.fused_rms_swiglu_int8(*args, block_n=block_n)
    assert fm.launches_swiglu == before + 1
    ref = fm.fused_rms_swiglu_int8_ref(*args, block_n=block_n)
    torch.cuda.synchronize()
    assert _swiglu_within_steps(out, ref, args, G, block_n)
    assert torch.equal(out, fm.fused_rms_swiglu_int8(*args,
                                                     block_n=block_n))


@pytest.mark.parametrize("M,d,H,block_n,sub_tiles,G", [
    (4096, 4096, 11008, 512, 2, 128),   # the Bind prefill
    (328, 4096, 1024, 512, 2, 128),     # 2 x 128 + 72 rows
    (72, 512, 1024, 512, 4, 128),       # four groups a block_n step
    (200, 384, 768, 384, 3, 128),       # three, an odd number
])
def test_fused_rms_swiglu_weight_layouts_and_steps(cuda, M, d, H, block_n,
                                                   sub_tiles, G):
    """Row 7 on K-major views and on contiguous [in, out] weights (which
    the wrapper transposes): the same bits; within the check of the plain
    version at ragged row counts and with more than two groups a block_n
    step (the down kernel's running total in shared memory)."""
    kw = dict(block_n=block_n, sub_tiles=sub_tiles)
    assert fm.swiglu_group(d, H, block_n, sub_tiles) == G
    args = _swiglu_args(cuda, M, d, H, M + d, k_major=True)
    flat = [t.contiguous() for t in args]
    assert not args[2].is_contiguous() and flat[2].is_contiguous()
    out = fm.fused_rms_swiglu_int8(*args, **kw)
    assert torch.equal(out, fm.fused_rms_swiglu_int8(*flat, **kw))
    ref = fm.fused_rms_swiglu_int8_ref(*args, **kw)
    torch.cuda.synchronize()
    assert _swiglu_within_steps(out, ref, args, G, block_n)


def test_fused_rms_swiglu_refuses_what_it_cannot_take(cuda):
    args = _swiglu_args(cuda, 64, 256, 512, 0)
    with pytest.raises(TypeError, match="bf16"):
        fm.fused_rms_swiglu_int8(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="int8"):
        fm.fused_rms_swiglu_int8(*args[:2], args[2].to(torch.int16),
                                 *args[3:])
    bad = _swiglu_args(cuda, 64, 192, 512, 0)
    with pytest.raises(ValueError, match="multiples of 128"):
        fm.fused_rms_swiglu_int8(*bad)
    with pytest.raises(RuntimeError, match="grad"):
        fm.fused_rms_swiglu_int8(args[0].requires_grad_(), *args[1:])


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


def test_flash_forward_key_limit(cuda):
    """At D 128 the forward kernel takes max_kv_len(128) keys (90,624: its
    listing of the key tiles fills shared memory) and matches the plain
    version there; one key more raises a ValueError that names the limit,
    before any launch."""
    limit = fa.max_kv_len(128)
    B, Sq, Hq, Hkv, D = 1, 64, 2, 1, 128
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((B, limit + 1, Hkv, D), generator=g,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    seg_q = torch.ones((B, Sq), dtype=torch.int32, device=cuda)
    seg_kv = torch.ones((B, limit + 1), dtype=torch.int32, device=cuda)
    q_pos = torch.full((B, Sq), limit, dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(limit + 1, dtype=torch.int32,
                          device=cuda).expand(B, -1).contiguous()
    sm = 1.0 / math.sqrt(D)
    ints = (seg_q, seg_kv[:, :limit].contiguous(), q_pos,
            kv_pos[:, :limit].contiguous())
    before = fa.launches
    out, _ = fa.flash_fwd(q, k[:, :limit], v[:, :limit], *ints, causal=True,
                          sm_scale=sm)
    assert fa.launches == before + 1
    ref, _ = fa.flash_fwd_ref(q, k[:, :limit], v[:, :limit], *ints,
                              causal=True, sm_scale=sm)
    torch.cuda.synchronize()
    assert _close(out, ref)
    with pytest.raises(ValueError, match=str(limit)):
        fa.flash_fwd(q, k, v, seg_q, seg_kv, q_pos, kv_pos, causal=True,
                     sm_scale=sm)
    assert fa.launches == before + 1


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (3, 200, 200, 8, 2, 128, True),     # ragged tiles, GQA 4
    (3, 130, 130, 4, 4, 16, False),
    (2, 257, 257, 6, 3, 24, True),
    (3, 512, 512, 4, 2, 32, False),
    (2, 300, 300, 4, 1, 64, True),
    (2, 48, 333, 8, 2, 128, True),      # new tokens over a cache
    (1, 3, 20, 2, 1, 16, True),         # a few rows in one ragged tile
    (5, 70, 70, 1, 1, 32, False),
    (4, 1100, 1100, 8, 2, 128, True),   # 288 query tiles: the grid wraps
    (1, 2, 2000, 8, 2, 128, True),      # two new rows over a long cache
    (1, 1, 1500, 4, 1, 64, True),
    (4, 512, 512, 12, 12, 64, False),   # BERT-base: right padding, a dead
    (8, 384, 384, 12, 12, 64, False),   # row, a packed row; bidirectional
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


def _bert_rows(dev, B, S, H, D, fill, seed):
    """q, k, v [B, S, H, D] bf16 with BERT's right padding: rows of S, of
    a length that ends inside a key tile, of 0 (a row of padding alone) and
    of 37 tokens (its later key tiles all padding), then random lengths;
    `fill` written into the padded rows of q, k and v."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    lens = [S, S - 75, 0, 37] + torch.randint(
        1, S + 1, (B - 4,), generator=g, device=dev).tolist()
    seg = (torch.arange(S, device=dev)[None]
           < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    pad = seg == 0
    for t in (q, k, v):
        t[pad] = fill
    return q, k, v, seg


@pytest.mark.parametrize("fill", [float("nan"), float("inf"),
                                  float("-inf")])
@pytest.mark.parametrize("B,S", [(6, 512), (5, 200)])
def test_flash_forward_dead_rows_are_zero_whatever_padding_holds(
        cuda, B, S, fill):
    """BERT's shape (H 12, D 64, bidirectional, right-padded): a query row
    that sees no key comes out 0 bit for bit and its lse -1e30, with NaN or
    inf in every padded row of q, k and v (the kernel writes a dead row by
    a select, not by scaling its sums, and a row of padding alone walks key
    tile 0 all the same)."""
    q, k, v, seg = _bert_rows(cuda, B, S, 12, 64, fill, S)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    before = fa.launches
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=False, sm_scale=0.125,
                            bounded=True, want_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    dead = seg == 0
    assert (out[dead].view(torch.int16) == 0).all()
    assert (lse.permute(0, 2, 1)[dead] == -1e30).all()


@pytest.mark.parametrize("B,S", [(6, 512), (5, 200), (16, 128)])
def test_flash_forward_padding_changes_no_live_row(cuda, B, S):
    """The same BERT rows with 0 and with -3e4 in the padded rows: the live
    rows come out the same bits (padded keys' scores are masked, their
    probabilities exactly 0, and key tiles of padding alone are not
    walked), and match the plain version."""
    q, k, v, seg = _bert_rows(cuda, B, S, 12, 64, 0.0, S + 1)
    q2, k2, v2, _ = _bert_rows(cuda, B, S, 12, 64, -3e4, S + 1)
    out = fa.flash_attention(q, k, v, seg, seg, causal=False)
    out2 = fa.flash_attention(q2, k2, v2, seg, seg, causal=False)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    ref, _ = fa.flash_fwd_ref(q, k, v, *ints, causal=False, sm_scale=0.125)
    torch.cuda.synchronize()
    live = seg > 0
    assert torch.equal(out[live], out2[live])
    assert torch.isfinite(out.float()).all() and _close(out, ref)


def test_bert_base_forward_on_the_card_matches_the_cpu(cuda):
    """BERT-base (12 layers, 768 wide, 12 heads of 64) in bf16 on the card,
    one flash forward launch a layer, against the same weights in f32 on
    the CPU (the plain route) on right-padded rows and a row of padding
    alone: every valid token's hidden state at a cosine of at least 0.995
    and the pooled outputs at 0.999; a dead row's attention is 0 on both
    sides, so its hidden states agree as well."""
    from procyon_tpu_torch.models import bert

    cfg = bert.bert_config("base", vocab_size=4096, max_position=256)
    params = bert.init_params(7, cfg, device="cpu")
    g = torch.Generator().manual_seed(8)
    ids = torch.randint(5, 4096, (6, 256), generator=g)
    for r, n in enumerate((256, 200, 129, 1, 64, 0)):
        ids[r, n:] = cfg.pad_id
    ids[:5, 0] = 2
    ref = bert.forward(_f32(params), dataclasses.replace(
        cfg, dtype=torch.float32), ids)
    before = fa.launches
    out = bert.forward(_to(params, cuda), cfg, ids.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches == before + cfg.n_layers
    h = out["hidden"].float().cpu()
    assert torch.isfinite(h).all()
    cos = torch.nn.functional.cosine_similarity(h, ref["hidden"], dim=-1)
    assert cos.min().item() >= 0.995, cos.min().item()
    pc = torch.nn.functional.cosine_similarity(out["pooled"].cpu(),
                                               ref["pooled"], dim=-1)
    assert pc.min().item() >= 0.999, pc.min().item()


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _grad_close(out, ref):
    """The backward kernels against their plain version, both in bf16 out
    of f32 sums: the kernels add the key (or query) tiles in another order
    and may round ds to the neighbouring bf16 value. Each element of a
    [B, S, H, D] gradient is held to 1% of the largest |plain| in its own
    row (a query's dq, a key's dk or dv: causal gradients shrink along the
    sequence, so a share of the tensor's largest would pass a fault in the
    late tiles) plus 1e-4 of the tensor's largest (f32 noise where ds
    cancels) plus one bf16 ulp (2^-7) of itself, and the error's norm to
    1% of the plain gradient's."""
    out, ref = out.float(), ref.float()
    allow = (1e-2 * ref.abs().amax(-1, keepdim=True)
             + 1e-4 * ref.abs().max() + 2.0 ** -7 * ref.abs())
    err = (out - ref).abs()
    return bool((err <= allow).all()) and \
        err.norm().item() <= 1e-2 * ref.norm().item()


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (3, 200, 200, 8, 2, 128, True),     # ragged tiles, GQA 4
    (3, 130, 130, 4, 4, 16, False),
    (2, 257, 257, 6, 3, 24, True),
    (3, 512, 512, 4, 2, 32, False),
    (2, 300, 300, 4, 1, 64, True),
    (2, 48, 333, 8, 2, 128, True),      # new tokens over a cache
    (1, 3, 20, 2, 1, 16, True),         # a few rows in one ragged tile
    (5, 70, 70, 1, 1, 32, False),
    (2, 320, 320, 16, 4, 128, True),    # five query tiles a head, GQA 4
    (2, 256, 256, 8, 8, 24, False),     # D 24 padded to 32, group 1
    (2, 100, 300, 4, 1, 24, True),      # D 24 over a cache, group 4
])
def test_flash_backward_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, D, causal):
    """Kernel rows 8 and 9 (dq; dk and dv) against flash_bwd_ref on the
    same bf16 inputs, bounded and with the positions given; padded and
    dead rows and keys exactly 0."""
    q, k, v, seg_q, seg_kv = _flash_inputs(cuda, B, Sq, Skv, Hq, Hkv, D,
                                           Sq + D + 1)
    q_pos = kv_pos = None
    if Sq != Skv:
        q_pos = torch.arange(Skv - 17 - Sq, Skv - 17,
                             device=cuda).expand(B, Sq)
        kv_pos = torch.arange(Skv, device=cuda).expand(B, Skv)
    ints = fa.mask_inputs(q, k, seg_q, seg_kv, q_pos, kv_pos)
    sm = 1.0 / math.sqrt(D)
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=causal, sm_scale=sm,
                            want_lse=True)
    g = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    want = fa.flash_bwd_ref(q, k, v, *ints, out, lse, do, causal=causal,
                            sm_scale=sm)
    for bounded in ((False, True) if q_pos is None else (False,)):
        before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
        got = fa.flash_bwd(q, k, v, *ints, out, lse, do, causal=causal,
                           sm_scale=sm, bounded=bounded)
        torch.cuda.synchronize()
        assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (
            before[0] + 1, before[1] + 1)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            assert torch.isfinite(a.float()).all(), name
            assert _grad_close(a, b), (name, bounded,
                                       (a.float() - b.float()).abs().max())
        again = fa.flash_bwd(q, k, v, *ints, out, lse, do, causal=causal,
                             sm_scale=sm, bounded=bounded)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        dq, dk, dv = got
        assert not dq[ints[0] == 0].any().item()
        assert not dk[ints[1] == 0].any().item()
        assert not dv[ints[1] == 0].any().item()


def test_flash_attention_under_grad_takes_the_backward_kernels(cuda):
    """flash_attention with inputs that require grad goes through the
    autograd Function: one forward launch (with lse), one launch of each
    backward kernel, and the gradients flash_bwd gives directly."""
    B, S, Hq, Hkv, D = 2, 160, 8, 2, 64
    q, k, v, seg, _ = _flash_inputs(cuda, B, S, S, Hq, Hkv, D, 11)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out = fa.flash_attention(q, k, v, seg, seg, causal=True)
    g = torch.Generator(device=cuda).manual_seed(8)
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fa.launches_bwd_dq - before[1],
            fa.launches_bwd_dkv - before[2]) == (1, 1, 1)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    with torch.no_grad():
        o2, lse = fa.flash_fwd(q, k, v, *ints, causal=True,
                               sm_scale=D ** -0.5, bounded=True,
                               want_lse=True)
        want = fa.flash_bwd(q, k, v, *ints, o2, lse, do, causal=True,
                            sm_scale=D ** -0.5, bounded=True)
    for a, b in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):   # the kernel alone has no backward
        fa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=D ** -0.5)


def test_flash_backward_at_the_training_shape(cuda):
    """B2 x S2048, Hq 32, Hkv 8, D 128, causal, bounded: the shape every
    layer of the Llama-3-8B training step gives the kernels."""
    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    q, k, v, _, _ = _flash_inputs(cuda, B, S, S, Hq, Hkv, D, 12)
    ints = fa.mask_inputs(q, k, None, None, None, None)
    sm = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=sm,
                            bounded=True, want_lse=True)
    g = torch.Generator(device=cuda).manual_seed(9)
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = fa.flash_bwd(q, k, v, *ints, out, lse, do, causal=True,
                       sm_scale=sm, bounded=True)
    want = fa.flash_bwd_ref(q, k, v, *ints, out, lse, do, causal=True,
                            sm_scale=sm)
    for a, b in zip(got, want):
        assert _grad_close(a, b), (a.float() - b.float()).abs().max()


@pytest.mark.parametrize("case", ["fresh", "cache_slice", "grid_wraps",
                                  "few_rows_long_cache"])
def test_flash_forward_long_gqa_rows_and_repeats(cuda, case):
    """The forward at D 128 with groups of 4 over five 128-row query tiles
    a head: a row whose first 200 keys are padding, a dead row, and a packed
    row whose second segment starts at 333, so that its rows' first key
    tiles are live for the block but fully masked for them (they must add
    nothing once an allowed key comes); bounded and not; k / v fresh, or
    read in place from a [2, B, Smax, Hkv, D] cache; the same rows at B4
    over 9 query tiles a head (288 items: the persistent grid's blocks
    take three rounds); and B1 with 3 new rows (positions given) over a
    2,000-slot cache whose first 64 slots are padding. Two launches give
    the same bits, out and lse."""
    B, S, Hq, Hkv, D = 3, 640, 8, 2, 128
    if case == "grid_wraps":
        B, S = 4, 1100
    g = torch.Generator(device=cuda).manual_seed(21)
    Sq = 3 if case == "few_rows_long_cache" else S
    Skv = 2000 if case == "few_rows_long_cache" else S
    if case == "few_rows_long_cache":
        B = 1
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).to(
        torch.bfloat16)
    if case in ("cache_slice", "few_rows_long_cache"):
        cache = torch.randn((2, B, Skv + 100, Hkv, D), generator=g,
                            device=cuda).to(torch.bfloat16)
        k, v = cache[0, :, :Skv], cache[1, :, :Skv]
    else:
        k, v = (torch.randn((B, Skv, Hkv, D), generator=g,
                            device=cuda).to(torch.bfloat16)
                for _ in range(2))
    if case == "few_rows_long_cache":
        seg_q = torch.ones((B, Sq), dtype=torch.int32, device=cuda)
        seg_kv = torch.ones((B, Skv), dtype=torch.int32, device=cuda)
        seg_kv[:, :64] = 0
        q_pos = torch.arange(Skv - Sq, Skv, device=cuda).expand(B, Sq)
        kv_pos = torch.arange(Skv, device=cuda).expand(B, Skv)
        bounds = (False,)
    else:
        seg_q = torch.ones((B, S), dtype=torch.int32, device=cuda)
        seg_q[0, :200] = 0
        seg_q[1] = 0
        seg_q[2, 333:] = 2
        seg_kv, q_pos, kv_pos = seg_q, None, None
        bounds = (True, False)
    ints = fa.mask_inputs(q, k, seg_q, seg_kv, q_pos, kv_pos)
    sm = D ** -0.5
    ref, ref_lse = fa.flash_fwd_ref(q, k, v, *ints, causal=True, sm_scale=sm)
    live = ref_lse > -1e29
    for bounded in bounds:
        before = fa.launches
        out, lse = fa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=sm,
                                bounded=bounded, want_lse=True)
        again = fa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=sm,
                             bounded=bounded, want_lse=True)
        torch.cuda.synchronize()
        assert fa.launches == before + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert torch.isfinite(out.float()).all()
        assert _close(out, ref), (bounded, (out.float() - ref.float()).abs()
                                  .max())
        assert torch.equal(lse > -1e29, live) and (lse[~live] == -1e30).all()
        assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-3
        assert not out[seg_q == 0].any().item()


def test_flash_backward_writes_delta_of_every_row(cuda):
    """The dq kernel writes delta for every row the dk / dv kernel reads:
    also those of a 64-row query tile that holds only padding (a block
    that has no other work), of a dead row and of a ragged last tile of
    padding. Run right after a CUDA tensor of delta's size, full of NaN,
    is freed, so that the allocator hands its block to the delta buffer:
    with a NaN there, ds = p (dp - delta) is NaN where p is 0. dq, dk and
    dv stay finite and close to the plain version, padded rows' and keys'
    gradients exactly 0."""
    B, S, Hq, Hkv, D = 3, 300, 8, 2, 128
    q, k, v, _, _ = _flash_inputs(cuda, B, S, S, Hq, Hkv, D, 23)
    seg = torch.ones((B, S), dtype=torch.int32, device=cuda)
    seg[0, 64:128] = 0          # a whole query tile of padding
    seg[0, 128:] = 2
    seg[1] = 0                  # dead
    seg[2, 236:] = 0            # the ragged last tile: padding only
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    sm = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=True, sm_scale=sm,
                            bounded=True, want_lse=True)
    g = torch.Generator(device=cuda).manual_seed(24)
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    want = fa.flash_bwd_ref(q, k, v, *ints, out, lse, do, causal=True,
                            sm_scale=sm)
    for bounded in (True, False):
        nan = torch.full((B, Hq, S), float("nan"), device=cuda)
        del nan
        got = fa.flash_bwd(q, k, v, *ints, out, lse, do, causal=True,
                           sm_scale=sm, bounded=bounded)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a.float()).all(), (name, bounded)
            assert _grad_close(a, b), (name, bounded)
        dq, dk, dv = got
        pad = seg == 0
        assert not dq[pad].any().item()
        assert not dk[pad].any().item() and not dv[pad].any().item()


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


# ---- page move and paged decode attention (the caption path's kernels) ----


@pytest.mark.parametrize("dtype,tail", [
    (torch.bfloat16, (64, 1024)),    # a bf16 page at Llama-3-8B widths
    (torch.int8, (64, 1024)),        # an int8 page
    (torch.float32, (64, 8)),        # an int8 pool's scale slab: 2 KiB rows
    (torch.bfloat16, (8, 24)),       # a row shorter than one block's chunk
])
def test_page_move_matches_plain(cuda, dtype, tail):
    N, M = 300, 97
    g = torch.Generator(device=cuda).manual_seed(N + tail[1])
    pool = torch.randint(-100, 100, (N, *tail), generator=g,
                         device=cuda).to(dtype)
    perm = torch.randperm(N, generator=g, device=cuda)
    dst = perm[:M].to(torch.int32)
    # sources repeat, and none of them is a destination
    src = perm[M:][torch.randint(0, 40, (M,), generator=g,
                                 device=cuda)].to(torch.int32)
    want = pm.move_pages_direct_ref(pool.clone(), src, dst)
    before = pm.launches
    got = pm.move_pages_direct(pool, src, dst)
    torch.cuda.synchronize()
    assert pm.launches == before + 1 and got is pool
    assert torch.equal(got, want)


def _staged_plan(kind, N, g, dev):
    """src, dst (int32) of one staged-move plan over N rows."""
    p = torch.randperm(N, generator=g, device=dev)
    if kind == "mixed":       # swap, 3-cycle, chain, 64 permuted, repeats
        M = 160
        dst = p[:M]
        src = torch.cat([
            p[[1, 0, 3, 4, 2, 200, 5]],
            p[7:71][torch.randperm(64, generator=g, device=dev)],
            p[M:][torch.randint(0, 20, (M - 71,), generator=g,
                                device=dev)]])
    elif kind == "permutation":   # every source a destination
        dst = p[:160]
        src = dst[torch.randperm(160, generator=g, device=dev)]
    elif kind == "disjoint":      # no source is a destination
        dst, src = p[:160], p[160:320]
    elif kind == "one":
        dst, src = p[:1], p[1:2]
    else:                         # 2,560 destinations, repeated sources
        dst = p[:2560]
        src = p[2560:][torch.randint(0, 640, (2560,), generator=g,
                                     device=dev)]
    return src.to(torch.int32), dst.to(torch.int32)


@pytest.mark.parametrize("kind", ["mixed", "permutation", "disjoint", "one",
                                  "repeats"])
@pytest.mark.parametrize("dtype,tail", [
    (torch.bfloat16, (64, 1024)),
    (torch.int8, (64, 1024)),
    (torch.float32, (64, 8)),
])
def test_staged_page_move_is_safe_on_chains(cuda, dtype, tail, kind):
    """Every destination gets the OLD source row: swaps, a 3-cycle, a
    chain, a permutation of 64 destinations among themselves and repeated
    sources; a full permutation (its bf16 rows overflow the scratch, so
    they move in column slabs); no overlap; one move; 2,560 destinations
    from 640 sources. A kernel that writes before all reads (the direct
    move on these plans) fails this. Two launches on copies of the pool
    give the same bits."""
    N = 3200 if kind == "repeats" else 400
    g = torch.Generator(device=cuda).manual_seed(N + tail[1] + len(kind))
    pool = torch.randint(-100, 100, (N, *tail), generator=g,
                         device=cuda).to(dtype)
    src, dst = _staged_plan(kind, N, g, cuda)
    start = pool.clone()
    want = pm.move_pages_ref(pool.clone(), src, dst)
    before = pm.launches_staged
    got = pm.move_pages(pool, src, dst)
    torch.cuda.synchronize()
    assert pm.launches_staged == before + 1 and got is pool
    assert torch.equal(got, want)
    assert torch.equal(pm.move_pages(start, src, dst), got)


def test_page_move_refuses_what_it_cannot_copy(cuda):
    pool = torch.zeros((8, 4, 8), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        pm.move_pages_direct(pool, idx.long(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        pm.move_pages_direct(pool.transpose(1, 2), idx, idx)
    with pytest.raises(ValueError, match="16 bytes"):
        pm.move_pages_direct(pool[:, :1, :4].contiguous(), idx, idx)


def _paged_case(dev, B, Hq, Hkv, D, page, P, lens, quantized, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * P + 3
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    shape = (n_pages, page, Hkv * D)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=g,
                              device=dev).to(torch.int8) for _ in range(2))
        ks, vs = (torch.rand((n_pages, page, Hkv), generator=g, device=dev)
                  * 0.02 + 1e-3 for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * P].reshape(
        B, P).to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(n_kv_heads=Hkv, head_dim=D, k_scale_pool=ks, v_scale_pool=vs)
    return (q, k, v, table, lens), kw


# a page's worth of tokens, each slot's lengths: dead chunks of the chunk
# plan's cut wherever a slot is shorter than the table
_DEAD_CHUNKS_16 = [0, 1, 64, 768, 0, 1, 64, 768, 2, 63, 65, 129, 300, 767,
                   700, 5]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,P,lens", [
    # Llama-3-8B widths: dead slot, mid-page, page boundary, full context
    (6, 32, 8, 128, 64, 12, [0, 1, 300, 320, 767, 768]),
    (3, 8, 8, 128, 64, 3, [5, 64, 192]),        # no grouping (MHA)
    (4, 16, 2, 64, 32, 5, [0, 33, 96, 160]),    # D 64, group 8, page 32
    (2, 4, 2, 128, 128, 2, [130, 256]),         # one token per thread
    (3, 8, 4, 64, 16, 4, [7, 16, 64]),          # 16-token pages
    (2, 8, 8, 128, 8, 6, [3, 48]),              # 8-token pages
    # serving's B16 and the caption check's B8 at Llama-3-8B widths: the
    # chunk plan cuts their tables, and slots of length 0, 1, one page and
    # the whole table leave whole chunks dead
    (16, 32, 8, 128, 64, 12, _DEAD_CHUNKS_16),
    (8, 32, 8, 128, 64, 12, [0, 1, 64, 768, 128, 383, 640, 65]),
])
def test_paged_attention_matches_plain(cuda, B, Hq, Hkv, D, page, P, lens,
                                       quantized):
    args, kw = _paged_case(cuda, B, Hq, Hkv, D, page, P, lens, quantized,
                           seed=B * 100 + page)
    before = pa.launches
    out, lse = pa.paged_decode_attention_fullpage(*args, **kw)
    ref, ref_lse = pa.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert _close(out, ref)
    dead = args[4] == 0
    assert not out[dead].any() and bool((lse[dead] == -1e30).all())
    assert (lse[~dead] - ref_lse[~dead]).abs().max() <= 1e-3
    # the kernel's own cut in plain code, and twice the same bits
    cut, cut_lse = pa.paged_decode_attention_chunked_ref(*args, **kw)
    assert _close(out, cut)
    assert (lse[~dead] - cut_lse[~dead]).abs().max() <= 1e-3
    again, again_lse = pa.paged_decode_attention_fullpage(*args, **kw)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_attention_ignores_the_pool_past_each_length(cuda, quantized):
    """Rows of a slot's pages past its length are garbage by contract: NaN
    and inf there (in the codes, and the scales of an int8 pool) change no
    bit of the output. The tensor cores multiply P = 0 by those rows, so
    the kernel must read them as zeros."""
    lens = [0, 1, 63, 64, 65, 700, 767, 768]
    args, kw = _paged_case(cuda, 8, 32, 8, 128, 64, 12, lens, quantized,
                           seed=12)
    q, k, v, table, n = args
    out, lse = pa.paged_decode_attention_fullpage(*args, **kw)
    k2, v2 = k.clone(), v.clone()
    ks2 = None if kw["k_scale_pool"] is None else kw["k_scale_pool"].clone()
    vs2 = None if kw["v_scale_pool"] is None else kw["v_scale_pool"].clone()
    page = k.shape[1]
    for b, length in enumerate(lens):
        for j, row in enumerate(table[b].tolist()):
            dead = slice(max(0, min(page, length - j * page)), page)
            if quantized:
                k2[row, dead] = -128
                v2[row, dead] = 127
                ks2[row, dead] = float("nan")
                vs2[row, dead] = float("inf")
            else:
                k2[row, dead] = float("nan")
                v2[row, dead] = float("inf")
    kw2 = dict(kw, k_scale_pool=ks2, v_scale_pool=vs2)
    out2, lse2 = pa.paged_decode_attention_fullpage(q, k2, v2, table, n,
                                                    **kw2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_paged_attention_refuses_what_it_cannot_take(cuda):
    args, kw = _paged_case(cuda, 2, 8, 2, 128, 64, 2, [3, 70], False, 0)
    q, k, v, table, lens = args
    with pytest.raises(TypeError, match="bf16"):
        pa.paged_decode_attention_fullpage(q.float(), k.float(), v.float(),
                                           table, lens, **kw)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention_fullpage(q, k, v, table.long(), lens, **kw)
    with pytest.raises(ValueError, match="page_size"):
        pa.paged_decode_attention_fullpage(
            q, k[:, :48].contiguous(), v[:, :48].contiguous(), table, lens,
            **kw)


# ---- the caption path's calling code on the card ----


def test_ref_backend_refuses_the_card_on_decode_and_beam_steps(cuda):
    """attn_backend="ref" is the CPU reference: with the pool on the card a
    one-token decode, a beam step and the beam's prefill raise instead of
    doing the kernels' work in plain code, and launch nothing."""
    import dataclasses
    from procyon_tpu_torch.data import collators, datasets, instruct
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.inference import generation, paged_beam
    from procyon_tpu_torch.models import llama, unified
    cfg = unified.UnifiedConfig(
        llama=llama.LlamaConfig(
            vocab_size=4096, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            intermediate=256, max_seq_len=512, dtype=torch.bfloat16),
        esm=None, protein_embed_dim=64, token_projector_layers=2,
        token_projector_hidden=64, retrieval_dim=32, dtype=torch.bfloat16)
    ref = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, attn_backend="ref"))
    params = unified.init_params(0, cfg, device=cuda)
    tok = load_tokenizer(vocab_size=4096)
    task = instruct.TaskLibrary().get("uniprot_all_caption")
    coll = collators.CaptionCollator(
        collators.CollatorConfig(protein_embed_dim=cfg.encoder_out_dim), tok,
        datasets.SyntheticStore(n_proteins=8, embed_dim=64), task)
    batch = coll([(0, 0), (1, 0)], instruct.get_prompt(task, num_examples=1),
                 for_generation=True)
    gen = generation.GenerationConfig(
        max_new_tokens=4, method="beam", beam_size=4, beam_group_size=2,
        diversity_penalty=0.8, eos_token_id=tok.spec.eos_id,
        pad_token_id=tok.spec.pad_id)
    state, ctx = paged_beam.paged_beam_init(params, cfg, batch, gen)
    pcfg, pool = ctx["pcfg"], state[1]
    before = (pm.launches, pa.launches, fa.launches)
    with pytest.raises(ValueError, match="CPU reference"):
        paged_beam.paged_beam_step(
            params, ref, gen, pcfg, ctx["beam"], ctx["private"], ctx["g0"],
            state, 0, max_position=ctx["max_len"])
    with pytest.raises(ValueError, match="CPU reference"):
        llama.paged_forward(
            params["llama"], ref.llama, pool, pcfg,
            torch.arange(pcfg.slots, device=cuda),
            tokens=torch.zeros((pcfg.slots, 1), dtype=torch.int32,
                               device=cuda), max_position=ctx["max_len"])
    with pytest.raises(ValueError, match="CPU reference"):
        paged_beam.paged_beam_init(params, ref, batch, gen)
    assert (pm.launches, pa.launches, fa.launches) == before
    # the kernels' backend takes the same step, through the page move
    paged_beam.paged_beam_step(
        params, cfg, gen, pcfg, ctx["beam"], ctx["private"], ctx["g0"],
        state, 0, max_position=ctx["max_len"])
    torch.cuda.synchronize()
    assert pm.launches == before[0] + 2


@pytest.mark.parametrize("flags", [(), ("--paged",),
                                   ("--paged", "--shared_prefix")])
def test_caption_cli_writes_captions_on_the_card(cuda, tmp_path, flags):
    """The bulk caption entry point at its default device: the synthetic
    model in bf16, every backend through the flash kernel at prefill and
    the paged ones through the page move."""
    import csv
    from procyon_tpu_torch.scripts import caption_bulk
    out = tmp_path / "captions.csv"
    before = (fa.launches, pm.launches)
    caption_bulk.main(["--synthetic", "--n_proteins", "6", "--batch_size",
                       "4", "--max_new_tokens", "8", "--out", str(out),
                       *flags])
    rows = list(csv.reader(open(out)))
    assert rows[0] == ["protein_id", "caption"]
    assert [r[0] for r in rows[1:]] == [str(i) for i in range(6)]
    assert all(r[1] for r in rows[1:])
    assert fa.launches > before[0]
    assert (pm.launches > before[1]) == bool(flags)


# ---- the int4 unpack + matmul kernel ----


@pytest.mark.parametrize("k,n,group", [
    (4096, 4096, 128),        # wq / wo
    (4096, 1024, 128),        # wk / wv: 16 slices of k
    (4096, 1792, 128),        # w_gate / w_up, n cut from 14336
    (14336, 512, 128),        # w_down: the high half of x starts at 7168
    (4096, 2048 + 128, 128),  # lm_head, n cut; not a multiple of 512
    (512, 128, 64),           # groups of 64
])
@pytest.mark.parametrize("rows", [1, 16, 100, 256])
def test_int4_matmul_matches_plain(cuda, k, n, group, rows):
    g = torch.Generator(device=cuda).manual_seed(k + n + rows)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    qw = quant.quantize4(w, group=group)
    x = torch.randn((rows, k), generator=g, device=cuda).to(torch.bfloat16)
    before = i4.launches
    out = i4.qmatvec4(x, qw)
    ref = i4.qmatvec4_ref(x, qw)
    torch.cuda.synchronize()
    assert i4.launches == before + 1
    assert out.shape == (rows, n) and out.dtype == torch.bfloat16
    assert _close(out, ref)
    assert torch.equal(out, i4.qmatvec4(x, qw))      # no atomics: repeatable
    # through the dispatch, and against the dequantize route (another
    # function: it rounds q * s to bf16 first), loosely
    assert torch.equal(quant.mm(x, qw), out)
    deq = x @ quant.dequantize4(qw, torch.bfloat16)
    assert (out.float() - deq.float()).abs().max() \
        <= 4 * 2.0 ** -8 * deq.float().abs().max()


@pytest.mark.parametrize("k,n", [
    (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
    (4096, 128256)])
def test_int4_matmul_llama_shapes_at_16_rows(cuda, k, n):
    """The five Llama-3-8B weight shapes at full size and a decode round's
    16 rows (groups of 128), against the plain version, twice for the same
    bits: the slices of a tile add in one order whatever the plan."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    w = torch.randn((k, n), generator=g, device=cuda) * k ** -0.5
    qw = quant.quantize4(w, group=128)
    del w
    x = torch.randn((16, k), generator=g, device=cuda).to(torch.bfloat16)
    out = i4.qmatvec4(x, qw)
    ref = i4.qmatvec4_ref(x, qw)
    assert _close(out, ref)
    for _ in range(2):
        assert torch.equal(out, i4.qmatvec4(x, qw))


def test_int4_matmul_is_one_kernel_a_call(cuda):
    """One qmatvec4 call is one device kernel at every shape the plan cuts
    into slices (the slices add up inside the launch), counted by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for k, n in ((4096, 1024), (4096, 4096), (14336, 4096)):
        qw = quant.quantize4(torch.randn((k, n), device=cuda) / 64,
                             group=128)
        x = torch.randn((16, k), device=cuda).to(torch.bfloat16)
        i4.qmatvec4(x, qw)
        torch.cuda.synchronize()
        assert i4.plan(16, n, k // 256)[2] > 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            i4.qmatvec4(x, qw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "int4" in e.name]
        others = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "int4" not in e.name and "Memcpy" not in e.name
                  and "Memset" not in e.name]
        assert len(kernels) == 1 and not others, (k, n, others)


def test_int4_matmul_weights_reused_at_one_address(cuda):
    """The kernel keeps the weights' tensor maps from call to call, keyed
    by address and layout: weights freed and made again, of the same shape
    with other values, then of other shapes and group sizes (the caching
    allocator hands the same addresses back), still match the plain
    version, as do column slices of one packed tensor at other offsets."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((16, 1024), generator=g, device=cuda).to(torch.bfloat16)
    for n, group in ((512, 128), (512, 128), (256, 128), (512, 64),
                     (1024, 32)):
        qw = quant.quantize4(torch.randn((1024, n), generator=g,
                                         device=cuda) / 32, group=group)
        assert _close(i4.qmatvec4(x, qw), i4.qmatvec4_ref(x, qw)), (n, group)
        del qw
    qw = quant.quantize4(torch.randn((1024, 1024), generator=g, device=cuda)
                         / 32, group=128)
    for c0 in (0, 256, 512):
        part = {"p": qw["p"][:, c0:c0 + 512], "s": qw["s"][:, :, c0:c0 + 512]}
        assert _close(i4.qmatvec4(x, part), i4.qmatvec4_ref(x, part)), c0


def test_int4_matmul_layer_slices_and_3d_x(cuda):
    """A layer's slice of a stacked leaf goes in as it is; x may be
    [B, T, k] and a column slice of a wider tensor."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((3, 512, 256), generator=g, device=cuda) * 512 ** -0.5
    st = quant.quantize4(w, group=128)
    wide = torch.randn((2, 5, 1024), generator=g, device=cuda).to(
        torch.bfloat16)
    x = wide[..., 256:768]
    for i in range(3):
        qw = {"p": st["p"][i], "s": st["s"][i]}
        assert _close(i4.qmatvec4(x, qw), i4.qmatvec4_ref(x, qw))
        assert i4.qmatvec4(x, qw).shape == (2, 5, 256)


def test_int4_matmul_refuses_what_it_cannot_take(cuda):
    qw = quant.quantize4(torch.randn((512, 256), device=cuda), group=128)
    x = torch.randn((4, 512), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        i4.qmatvec4(x, qw)
    with pytest.raises(ValueError, match="rows"):
        i4.qmatvec4(torch.zeros((257, 512), dtype=torch.bfloat16,
                                device=cuda), qw)
    with pytest.raises(ValueError, match="devices"):
        i4.qmatvec4(x.to(torch.bfloat16),
                    {"p": qw["p"].cpu(), "s": qw["s"].cpu()})
    # more than 256 rows take the dequantize route in the dispatch
    big = torch.randn((300, 512), device=cuda).to(torch.bfloat16)
    before = i4.launches
    assert quant.mm(big, qw).shape == (300, 256)
    assert i4.launches == before


def test_batcher_with_int4_weights_on_the_card(cuda):
    """One ContinuousBatcher run on the card in bf16 with int4 weights:
    every matmul of every forward through the int4 kernel, decode steps
    through the page-walk kernel (max_ctx 512), tokens equal with and
    without async rounds (the same routes, so bit for bit)."""
    from procyon_tpu_torch.inference import kv_pool, serving
    from procyon_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab_size=1024, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=1, intermediate=1024,
                            max_seq_len=1024, dtype=torch.bfloat16)
    params = llama.quantize_params(llama.init_params(0, cfg, device=cuda),
                                   cfg, bits=4)
    pcfg = kv_pool.PagedConfig(n_layers=2, n_kv_heads=1, head_dim=128,
                               page_size=64, n_pages=32, max_pages_per_seq=8,
                               slots=4, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(4, 1024, (n,), generator=g).tolist()
               for n in (5, 40, 17, 9, 70)]
    outs = []
    for async_rounds in (False, True):
        b = serving.ContinuousBatcher(params, cfg, pcfg, step_quantum=4,
                                      prefix_cache=True,
                                      async_rounds=async_rounds)
        i4.launches = pa.launches = 0
        rids = [b.submit(p, max_new=9) for p in prompts]
        out = b.run()
        outs.append([out[r] for r in rids])
        assert all(len(o) == 9 for o in outs[-1])
        assert i4.launches % (7 * cfg.n_layers + 1) == 0 and i4.launches > 0
        assert pa.launches % cfg.n_layers == 0 and pa.launches > 0
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="device"):
        serving.ContinuousBatcher(params, cfg, pcfg, device="cpu")
