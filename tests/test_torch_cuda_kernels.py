"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes beyond chip_smoke.py's: ESM2's full S=1026 (a ragged last key
tile), head dims 16 and 128, the unfused q/k/v layout, the fused MLP's
16-row block (d=2560) and its G=256 group; the flash forward at ragged
lengths, every head dim, strided views, a cache shape and ESM2-35M's route;
the page move on bf16, int8 and f32 rows; the paged decode attention at
other head dims, groups and page sizes, bf16 and int8 pools.

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


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,page,P,lens", [
    # Llama-3-8B widths: dead slot, mid-page, page boundary, full context
    (6, 32, 8, 128, 64, 12, [0, 1, 300, 320, 767, 768]),
    (3, 8, 8, 128, 64, 3, [5, 64, 192]),        # no grouping (MHA)
    (4, 16, 2, 64, 32, 5, [0, 33, 96, 160]),    # D 64, group 8, page 32
    (2, 4, 2, 128, 128, 2, [130, 256]),         # one token per thread
    (3, 8, 4, 64, 16, 4, [7, 16, 64]),          # 8 slices of head_dim
])
def test_paged_attention_matches_plain(cuda, B, Hq, Hkv, D, page, P, lens,
                                       quantized):
    args, kw = _paged_case(cuda, B, Hq, Hkv, D, page, P, lens, quantized,
                           seed=B * 100 + page)
    if (D * (1 if quantized else 2)) % (16 * (128 // page)):
        # a head row that does not split into 16-byte slices over the block
        with pytest.raises(ValueError, match="page_size"):
            pa.paged_decode_attention_fullpage(*args, **kw)
        return
    before = pa.launches
    out, lse = pa.paged_decode_attention_fullpage(*args, **kw)
    ref, ref_lse = pa.paged_decode_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert _close(out, ref)
    dead = args[4] == 0
    assert not out[dead].any() and bool((lse[dead] == -1e30).all())
    assert (lse[~dead] - ref_lse[~dead]).abs().max() <= 1e-3


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
