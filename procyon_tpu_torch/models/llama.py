"""Llama-2 / Llama-3 decoder (counterpart of procyon_tpu/models/llama.py),
limited to the inference paths: the dense KV cache and the paged pool.

Takes token ids or pre-built input embeddings (the soft-token fusion path),
returns hidden states and LM logits, and supports an incremental KV cache.
Parameters are the JAX package's tree, bridged to torch (bridge.py):
stacked `[L, ...]` leaves read per layer in a Python loop where JAX used
`lax.scan`. Attention goes through ops/flash_attention.flash_attention
with `attn_backend` as its backend (the flash kernel on a CUDA tensor);
single-token decode over the cache is plain tensor code, as it is plain
jnp in the reference. `remat` is a training matter and is ignored.

`paged_forward` runs T tokens per slot against the paged pool
(inference/kv_pool.py) and updates the pool in place. Its one-token decode
walks the page table in the hand-written kernel of ops/paged_attention.py
where the reference's dispatch rule takes its Pallas kernel; the grouped
prefix (cascade) decode and the gather routes are plain tensor code, as
they are plain jnp in the reference. The reference's probes
PROCYON_PAGED_KERNEL and PROCYON_SHORT_BLOCK_T are not ported.

Weights may be bf16 / f32 tensors, int8 leaves {"q", "s"} or packed int4
leaves {"p", "s"} (`quantize_params`); `ops/quant.mm` dispatches on the
leaf, and int4 products of at most 256 rows go through the kernel of
ops/int4_matmul.py.
"""

import dataclasses
import math
from typing import Optional

import torch

from procyon_tpu_torch.models import lora as lora_mod
from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.ops.flash_attention import flash_attention
from procyon_tpu_torch.ops.paged_attention import \
    paged_decode_attention_fullpage
from procyon_tpu_torch.ops.norms import rms_norm
from procyon_tpu_torch.ops.rotary import (apply_rotary_flat,
                                          apply_rotary_flat_decode,
                                          flat_rotary_at)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # int8 matmul mode for quantized params: "dequant" = weight-only;
    # "w8a8" = s8 x s8 product for the prefill path. Decode steps (S == 1)
    # always use weight-only.
    quant_mode: str = "dequant"
    # None: the flash kernel (its plain version on the CPU); "ref": the
    # O(S^2) CPU reference
    attn_backend: Optional[str] = None
    remat: bool = True
    # task-banked LoRA on the attention q/v projections
    lora: Optional[lora_mod.LoRAConfig] = None

    @property
    def head_dim(self):
        return self.dim // self.n_heads


def llama2_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama3_8b(**kw) -> LlamaConfig:
    base = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                n_kv_heads=8, intermediate=14336, rope_theta=500000.0,
                max_seq_len=8192)
    base.update(kw)
    return LlamaConfig(**base)


def tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                intermediate=128, max_seq_len=128, dtype=torch.float32)
    base.update(kw)
    return LlamaConfig(**base)


def init_params(seed: Seed, cfg: LlamaConfig, *, device="cuda"):
    """Random parameters in the reference's tree: dense weights
    N(0, 1/fan_in), embedding std 0.02, unit norm scales. (The reference
    scales its stacked [L, in, out] weights by 1/sqrt(L), the leading axis,
    where it means the fan-in; at 32 layers of width 4096 that saturates
    every softmax, so the port keeps 1/sqrt(in).) Layer parameters are
    stacked [L, ...], drawn one layer at a time so the f32 temporary stays
    one layer's size. The numbers differ from jax.random's. `seed` is
    an int or a generator on `device` (models/_init.py)."""
    generator, device = make_generator(seed, device)
    hd = cfg.head_dim
    L = cfg.n_layers

    def dense(shape, scale=None):
        if scale is None:
            scale = 1.0 / (shape[-2] ** 0.5)
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        rows = out.reshape(-1, *shape[-2:]) if len(shape) == 3 else out[None]
        for i in range(rows.shape[0]):
            rows[i] = torch.randn(shape[-2:], generator=generator,
                                  device=device, dtype=torch.float32) * scale
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "attn": {
            "wq": dense((L, cfg.dim, cfg.n_heads * hd)),
            "wk": dense((L, cfg.dim, cfg.n_kv_heads * hd)),
            "wv": dense((L, cfg.dim, cfg.n_kv_heads * hd)),
            "wo": dense((L, cfg.n_heads * hd, cfg.dim)),
        },
        "mlp": {
            "w_gate": dense((L, cfg.dim, cfg.intermediate)),
            "w_up": dense((L, cfg.dim, cfg.intermediate)),
            "w_down": dense((L, cfg.intermediate, cfg.dim)),
        },
        "attn_norm": ones((L, cfg.dim)),
        "mlp_norm": ones((L, cfg.dim)),
    }
    if cfg.lora is not None:
        def lora_bank(out_dim):
            ps = [lora_mod.init_params(generator, cfg.lora, cfg.dim, out_dim,
                                       device=device) for _ in range(L)]
            return {"A": torch.stack([p["A"] for p in ps]),
                    "B": torch.stack([p["B"] for p in ps])}
        layers["lora_wq"] = lora_bank(cfg.n_heads * hd)
        layers["lora_wv"] = lora_bank(cfg.n_kv_heads * hd)
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), scale=0.02),
        "layers": layers,
        "final_norm": ones((cfg.dim,)),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def init_kv_cache(cfg: LlamaConfig, batch: int,
                  max_len: Optional[int] = None, *, device="cuda"):
    """Contiguous KV cache [L, B, Smax, Hkv, D] + filled length."""
    S = max_len or cfg.max_seq_len
    device = torch.device(device)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        # per-example segment ids of cached positions (0 = empty)
        "seg": torch.zeros((batch, S), dtype=torch.int32, device=device),
        # RoPE positions of cached entries (positional causal masking)
        "pos": torch.zeros((batch, S), dtype=torch.int32, device=device),
        "length": 0,
    }


_mm = quant.mm


def _layer(layers, i: int):
    """Layer i's view of the stacked [L, ...] tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _decode_attention_step(q, cache_k, cache_v, seg_ids, cache_seg,
                           positions, cache_pos, k_scale=None,
                           v_scale=None):
    """Short-block attention over the cache. q [B, T, Hq, D] for small T
    (T = 1 decode steps; T = K+1 speculative verify blocks, T <= 16);
    cache [B, S, Hkv, D].

    With k_scale / v_scale [B, S, Hkv] the cache holds int8 rows: the K
    scale multiplies each head's score row and the V scale folds into the
    probabilities before the P.V product. Exact algebra.

    Masking matches the flash kernel: same segment, nonzero, and cached
    position <= query position. Softmax probabilities are cast to the
    cache's compute dtype before P.V; scores and the P.V accumulation are
    f32. The reference contracts block-diagonal queries over all Hkv*D
    lanes to keep the TPU's flat layout; the zero lanes add exact zeros,
    so the grouped product here is the same function."""
    B, T, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    group = Hq // Hkv
    qh = q.reshape(B, T, Hkv, group, D)
    s = torch.einsum("btkgd,bskd->btkgs", qh.float(),
                     cache_k.to(q.dtype).float()) / math.sqrt(D)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, None, :, None, :]
    allowed = (cache_seg[:, None, :] == seg_ids[:, :, None]) \
        & (cache_seg[:, None, :] > 0) \
        & (cache_pos[:, None, :] <= positions[:, :, None])      # [B, T, S]
    s = torch.where(allowed[:, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, None, :, None, :]
    out = torch.einsum("btkgs,bskd->btkgd", p.to(q.dtype).float(),
                       cache_v.to(q.dtype).float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _block(x, lp, seg_ids, positions, rot, cfg: LlamaConfig,
           cache_k=None, cache_v=None, cache_seg=None, cache_pos=None,
           cache_len=None, lora_expert=0):
    """One decoder block. x [B, S, dim]. With a cache, layer i's cache_k /
    cache_v [B, Smax, Hkv, D] are updated in place at
    [cache_len, cache_len + S)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    cos_q, sin_q, perm_q, cos_k, sin_k, perm_k = rot

    h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps)
    mode = cfg.quant_mode if S > 1 else "dequant"
    q_flat = _mm(h, lp["attn"]["wq"], mode)
    k_flat = _mm(h, lp["attn"]["wk"], mode)
    v_flat = _mm(h, lp["attn"]["wv"], mode)
    if cfg.lora is not None:
        q_flat = lora_mod.apply(lp["lora_wq"], cfg.lora, h, q_flat,
                                expert_idx=lora_expert)
        v_flat = lora_mod.apply(lp["lora_wv"], cfg.lora, h, v_flat,
                                expert_idx=lora_expert)
    if S == 1:
        q = apply_rotary_flat_decode(q_flat, cos_q, sin_q, hd)
        k = apply_rotary_flat_decode(k_flat, cos_k, sin_k, hd)
    else:
        q = apply_rotary_flat(q_flat, cos_q, sin_q, perm_q)
        k = apply_rotary_flat(k_flat, cos_k, sin_k, perm_k)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v_flat.reshape(B, S, cfg.n_kv_heads, hd)

    if cache_k is not None:
        # write new k/v at [cache_len, cache_len + S), attend over the cache
        cache_k[:, cache_len:cache_len + S] = k.to(cache_k.dtype)
        cache_v[:, cache_len:cache_len + S] = v.to(cache_v.dtype)
        if S == 1:
            # single-token decode: a bandwidth-bound product over the cache
            attn = _decode_attention_step(
                q, cache_k, cache_v, seg_ids, cache_seg, positions,
                cache_pos)
        else:
            attn = flash_attention(
                q, cache_k, cache_v, seg_ids, cache_seg, causal=True,
                q_positions=positions, kv_positions=cache_pos,
                backend=cfg.attn_backend)
    else:
        attn = flash_attention(q, k, v, seg_ids, seg_ids, causal=True,
                               backend=cfg.attn_backend)
    attn = attn.reshape(B, S, cfg.n_heads * hd).to(x.dtype)
    x = x + _mm(attn, lp["attn"]["wo"], mode)

    h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps)
    gated = torch.nn.functional.silu(_mm(h, lp["mlp"]["w_gate"], mode)) \
        * _mm(h, lp["mlp"]["w_up"], mode)
    return x + _mm(gated, lp["mlp"]["w_down"], mode)


def forward(params, cfg: LlamaConfig, *, input_embeds=None, tokens=None,
            seg_ids=None, positions=None, kv_cache=None, lora_expert=0,
            want_logits: bool = True, max_position: Optional[int] = None):
    """Run the decoder stack on the parameters' device.

    input_embeds [B, S, dim] (fusion path) or tokens [B, S]. seg_ids [B, S]
    (0 = pad). positions [B, S] absolute positions for RoPE; none may reach
    cfg.max_seq_len. max_position is an upper bound of `positions` that the
    caller knows on the host (a decode loop knows its step): the check then
    costs no read of the device, which would stall the host once per call.

    Returns a dict with "hidden" [B, S, dim], "logits" [B, S, vocab] f32
    and, when a cache was passed, "kv_cache": the same k / v tensors,
    updated in place, with new seg / pos / length. want_logits=False skips
    the LM head for callers that read only "hidden" (the reference leaves
    that to dead-code elimination under jit; eager PyTorch has none).
    """
    if input_embeds is None:
        input_embeds = params["embed"][tokens.long()]
    x = input_embeds.to(cfg.dtype)
    B, S, _ = x.shape
    dev = x.device
    if seg_ids is None:
        seg_ids = torch.ones((B, S), dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
        max_position = S - 1
    seg_ids = seg_ids.to(device=dev, dtype=torch.int32)
    positions = positions.to(device=dev, dtype=torch.int32)
    if max_position is None:
        max_position = int(positions.max())
    if max_position >= cfg.max_seq_len:
        raise ValueError(f"position {max_position} >= max_seq_len "
                         f"{cfg.max_seq_len}")

    def tables(n_heads):
        cos_g, sin_g, perm = flat_rotary_at(positions, cfg.head_dim, n_heads,
                                            cfg.rope_theta)
        return cos_g.to(cfg.dtype), sin_g.to(cfg.dtype), perm

    rot_q = tables(cfg.n_heads)
    rot = rot_q + (rot_q if cfg.n_kv_heads == cfg.n_heads
                   else tables(cfg.n_kv_heads))

    layers = params["layers"]
    new_cache = None
    if kv_cache is None:
        for i in range(cfg.n_layers):
            x = _block(x, _layer(layers, i), seg_ids, positions, rot, cfg,
                       lora_expert=lora_expert)
    else:
        cache_len = int(kv_cache["length"])
        if cache_len + S > kv_cache["seg"].shape[1]:
            raise ValueError(f"{cache_len} cached + {S} new tokens exceed "
                             f"the cache's {kv_cache['seg'].shape[1]}")
        # cached-position segment ids: the S new positions carry their
        # (query) segment ids so tokens attend to themselves and the prefix
        cache_seg = kv_cache["seg"].clone()
        cache_pos = kv_cache["pos"].clone()
        cache_seg[:, cache_len:cache_len + S] = seg_ids
        cache_pos[:, cache_len:cache_len + S] = positions
        for i in range(cfg.n_layers):
            x = _block(x, _layer(layers, i), seg_ids, positions, rot, cfg,
                       cache_k=kv_cache["k"][i], cache_v=kv_cache["v"][i],
                       cache_seg=cache_seg, cache_pos=cache_pos,
                       cache_len=cache_len, lora_expert=lora_expert)
        new_cache = {"k": kv_cache["k"], "v": kv_cache["v"],
                     "seg": cache_seg, "pos": cache_pos,
                     "length": cache_len + S}

    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    out = {"hidden": x}
    if want_logits:
        out["logits"] = _mm(x, params["lm_head"]).float()
    if new_cache is not None:
        out["kv_cache"] = new_cache
    return out


def quantize_params(params, cfg: LlamaConfig, *, bits: int = 8,
                    group: int = 128):
    """Weight-only quantization of the decoder (ops/quant.py). LoRA banks,
    norms and the embedding table stay in their dtype.

    bits=8: per-channel int8 (half the bf16 bytes); bits=4: group-wise
    packed int4 (a quarter), whose matmuls of at most 256 rows run in the
    kernel of ops/int4_matmul.py."""
    if bits not in (4, 8):
        raise ValueError(f"bits is 4 or 8, got {bits}")
    out = dict(params)
    if bits == 4:
        out["layers"] = quant.quantize_tree4(params["layers"], group=group)
        out["lm_head"] = quant.quantize4(params["lm_head"], group=group)
    else:
        out["layers"] = quant.quantize_tree(params["layers"])
        out["lm_head"] = quant.quantize(params["lm_head"])
    return out


# ---------------------------------------------------------------------------
# Paged-KV path (inference/kv_pool.py): decode / prefill over a shared page
# pool. Each layer attends to the cached context and, separately, to the
# in-flight tokens; every layer's new K/V rows are written back with one
# scatter after the layer loop, so per-step traffic is proportional to the
# live context.
# ---------------------------------------------------------------------------

# widest token block routed to the short-block attention (and, on quantized
# pools, to the exact scale-algebra path) instead of the flash kernel;
# speculative verify blocks are K+1 <= 16 in practice
_SHORT_BLOCK_T = 16
# the page-walk kernel takes pools of at least this many tokens per slot;
# shorter pools take the gather route (the reference's rule, kept as it is)
_PAGED_KERNEL_MIN_CTX = 512


def require_cpu_for_ref(cfg: LlamaConfig, *tensors):
    """attn_backend "ref" is the CPU reference: its paged routes are plain
    tensor code (the gather route, indexed page copies). On any other device
    it would do the kernels' work without them, so it is refused there, as
    ops/flash_attention.flash_attention refuses backend="ref"."""
    if cfg.attn_backend != "ref":
        return
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(
                "attn_backend='ref' is the CPU reference; a tensor on "
                f"{t.device} takes attn_backend None")


def _cascade_decode_attention(q, gsz, kp, vp, pfx_valid, kt, vt,
                              tail_valid, k_scale_p=None, v_scale_p=None,
                              k_scale_t=None, v_scale_t=None):
    """Grouped-prefix (cascade) decode attention for beam pools.

    All `gsz` consecutive slots of a group (a prompt's beams) share the
    prompt's immutable full pages, which the flat per-slot gather would
    read gsz times. This splits decode attention into two segments and
    merges their softmax statistics:

      * prefix: the group's shared prompt pages, gathered once per group
        (kp / vp [G, Sp, Hkv*D]); the group's gsz queries ride one score
        block;
      * tail: each slot's private pages from its first generation index
        on, plus the in-flight token (kt / vt [B, St, Hkv*D]): the only
        per-slot traffic.

    The merge is the log-sum-exp combine: per segment (m, l, acc) = (row
    max, sum of exp(s - m), their V-weighted sum), combined in f32. A fully
    masked prefix (g0 == 0) has m = -1e30 (finite), so its merge weight
    exp(-1e30 - m) is exactly 0.

    Same numerics as `_decode_attention_step`: f32 scores and accumulation,
    unnormalised probabilities cast to q's dtype for P.V; on int8 pools the
    K scale multiplies the score rows and the V scale the probabilities
    before the cast, while the merge divides by the unscaled sum l.
    q [B, 1, Hq, D]; returns [B, 1, Hq, D]."""
    B, T, Hq, D = q.shape
    assert T == 1
    G = B // gsz
    Hkv = kp.shape[-1] // D
    group = Hq // Hkv
    dt = q.dtype

    def stats(qh, kf, vf, valid, ks, vs):
        """qh [b, t, Hkv, group, D]; kf / vf [b, S, Hkv*D]; valid [b, S];
        ks / vs [b, S, Hkv]. -> m, l [b, t, Hkv, group], acc [..., D]."""
        b, S = valid.shape
        k4 = kf.reshape(b, S, Hkv, D).to(dt).float()
        v4 = vf.reshape(b, S, Hkv, D).to(dt).float()
        s = torch.einsum("btkgd,bskd->btkgs", qh.float(), k4) / math.sqrt(D)
        if ks is not None:
            s = s * ks.float().permute(0, 2, 1)[:, None, :, None, :]
        ok = valid[:, None, None, None, :]
        s = torch.where(ok, s, -1e30)
        m = s.amax(-1)
        e = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        l = e.sum(-1)
        if vs is not None:
            e = e * vs.float().permute(0, 2, 1)[:, None, :, None, :]
        acc = torch.einsum("btkgs,bskd->btkgd", e.to(dt).float(), v4)
        return m, l, acc

    m_p, l_p, acc_p = stats(q.reshape(G, gsz, Hkv, group, D), kp, vp,
                            pfx_valid, k_scale_p, v_scale_p)
    m_p = m_p.reshape(B, Hq)
    l_p = l_p.reshape(B, Hq)
    acc_p = acc_p.reshape(B, Hq, D)
    m_t, l_t, acc_t = stats(q.reshape(B, 1, Hkv, group, D), kt, vt,
                            tail_valid, k_scale_t, v_scale_t)
    m_t = m_t.reshape(B, Hq)
    l_t = l_t.reshape(B, Hq)
    acc_t = acc_t.reshape(B, Hq, D)

    m = torch.maximum(m_p, m_t)
    a = torch.exp(m_p - m)
    b = torch.exp(m_t - m)
    l = a * l_p + b * l_t
    out = (a[..., None] * acc_p + b[..., None] * acc_t) / l[..., None]
    return out.reshape(B, 1, Hq, D).to(dt)


def _paged_attention_with_self(q, k_new, v_new, k_pool, v_pool, table, lens,
                               cfg: LlamaConfig):
    """Decode attention = the page-walk kernel over the cached context,
    merged with the in-flight token's own k / v by log-sum-exp (the kernel
    returns per-head lse; the self term is a rank-1 softmax correction).

    q [B, Hq, D]; k_new / v_new [B, Hkv, D]; pools [n_pages, page, Hkv*D];
    table [B, P] int32 flat pool rows; lens [B] int32. Returns [B, Hq, D].
    int8 pools never come here (paged_forward sends them to the gather
    route, by the reference's rule), so the kernel's int8 variant has no
    caller in the model yet."""
    B, Hq, D = q.shape
    Hkv = k_new.shape[1]
    group = Hq // Hkv
    out_ctx, lse = paged_decode_attention_fullpage(
        q, k_pool, v_pool, table, lens, n_kv_heads=Hkv, head_dim=D)
    out_ctx = out_ctx.float()
    qg = q.reshape(B, Hkv, group, D).float()
    s_self = torch.einsum("bhgd,bhd->bhg", qg, k_new.float()) / math.sqrt(D)
    s_self = s_self.reshape(B, Hq)
    m = torch.maximum(lse, s_self)
    w_ctx = torch.exp(lse - m)
    w_self = torch.exp(s_self - m)
    v_self = v_new.float().repeat_interleave(group, dim=1)      # [B, Hq, D]
    out = (w_ctx[..., None] * out_ctx + w_self[..., None] * v_self) \
        / (w_ctx + w_self)[..., None]
    return out.to(q.dtype)


def _position_bound_from_device(start, T: int) -> int:
    """The largest position of a [B, T] block that starts at `start` [B],
    read from the device: the host waits for the stream. Callers that know
    their lengths pass `max_position` and never come here (the continuous
    batcher's test patches this to raise)."""
    return int(start.max()) + T - 1


def paged_forward(params, cfg: LlamaConfig, pool, pcfg, slot_ids, *,
                  tokens=None, input_embeds=None, seg_ids=None,
                  lora_expert=0, share_gsz: int = 0,
                  share_prefix_pages: int = 0, share_tail_pages: int = 0,
                  share_g0=None, logits_at=None,
                  max_position: Optional[int] = None):
    """Forward T tokens per slot against the paged pool, then append their
    K/V. T == 1 is the decode step; T > 1 is (chunked) prefill. The pool's
    k / v (and scale) tensors and its seq_len are updated in place; returns
    (logits [B, T, vocab] f32, the same pool dict).

    slot_ids [B] integer slots on the pool's device. `lora_expert` is a
    scalar (one adapter for the whole batch) or a [B] integer tensor (an
    adapter per slot, lora.apply_routed's exact one-hot mixing).

    share_gsz > 1 (with share_prefix_pages / share_tail_pages ints and
    share_g0 a [B] per-slot first-generation-page index) takes the
    grouped-prefix cascade decode route for beam pools: groups of share_gsz
    consecutive slots share their leading share_g0 page-table entries
    (immutable prompt pages), so those pages are gathered once per group
    and only the tail (share_tail_pages from each slot's g0) per slot; see
    `_cascade_decode_attention`. T == 1 only.

    Routes, by the reference's rule: the page-walk kernel
    (ops/paged_attention.py) for T == 1 without cascade on a bf16 / f32
    pool whose Hkv*D is a multiple of 128 and whose max_ctx is at least
    512, unless attn_backend is "ref"; the cascade; else one gather of the
    slot's pages per layer followed by `_decode_attention_step` for
    T <= 16 (with the int8 scale algebra on quantized pools) or by
    `flash_attention` over [context, chunk] for longer chunks.

    logits_at [B] (indices into T) computes the LM head for that one token
    of each row only and returns logits [B, 1, vocab]: a prefill needs the
    last live token's row, and eager PyTorch has no dead-code elimination
    to drop the rest of a [B, T, vocab] product.

    Positions come from the pool's seq_len on the device and none may
    reach cfg.max_seq_len. max_position is their upper bound where the
    caller knows it on the host (a decode loop knows its prompt lengths and
    its step); without it the bound is read from the device, which stalls
    the host once per call."""
    from procyon_tpu_torch.inference import kv_pool

    if input_embeds is None:
        input_embeds = params["embed"][tokens.long()]
    x = input_embeds.to(cfg.dtype)
    B, T, _ = x.shape
    dev = x.device
    require_cpu_for_ref(cfg, x, pool["k"])
    slot_ids = slot_ids.to(device=dev, dtype=torch.long)
    expert_oh = None
    if cfg.lora is not None and isinstance(lora_expert, torch.Tensor) \
            and lora_expert.dim() == 1:
        expert_oh = torch.nn.functional.one_hot(
            lora_expert.to(dev).long(), cfg.lora.num_experts).to(cfg.dtype)
    hd = cfg.head_dim
    KH = cfg.n_kv_heads
    kd = KH * hd
    start = pool["seq_len"][slot_ids]                            # [B] int32
    positions = start[:, None] + torch.arange(T, dtype=torch.int32,
                                              device=dev)[None, :]
    if max_position is None:
        max_position = _position_bound_from_device(start, T)
    if max_position >= cfg.max_seq_len:
        raise ValueError(f"position {max_position} >= max_seq_len "
                         f"{cfg.max_seq_len}")
    if seg_ids is None:
        seg_ids = torch.ones((B, T), dtype=torch.int32, device=dev)
    seg_ids = seg_ids.to(device=dev, dtype=torch.int32)

    def tables(n_heads):
        cos_g, sin_g, perm = flat_rotary_at(positions, hd, n_heads,
                                            cfg.rope_theta)
        return cos_g.to(cfg.dtype), sin_g.to(cfg.dtype), perm

    cos_q, sin_q, perm_q = tables(cfg.n_heads)
    cos_k, sin_k, perm_k = (cos_q, sin_q, perm_q) if KH == cfg.n_heads \
        else tables(KH)

    cascade = (T == 1 and share_gsz > 1 and share_prefix_pages > 0
               and share_g0 is not None)
    use_paged_kernel = (T == 1 and cfg.attn_backend != "ref"
                        and not cascade and not pcfg.quantize_kv
                        and kd % 128 == 0
                        and pcfg.max_ctx >= _PAGED_KERNEL_MIN_CTX)
    table = pool["page_table"][slot_ids]                         # [B, P]
    lens = start
    pool_k, pool_v = pool["k"], pool["v"]
    pool_ks = pool.get("k_scale")
    pool_vs = pool.get("v_scale")
    if cascade:
        # layer-independent cascade indices and masks: the prefix gather
        # width and the tail width are fixed; validity masks carry the
        # per-row raggedness. A group's prefix pages are read from its
        # slot 0's table (all group slots hold identical entries below g0)
        P_ = pcfg.page_size
        n_groups = B // share_gsz
        Sp = share_prefix_pages * P_
        St = share_tail_pages * P_
        g0 = share_g0.to(device=dev, dtype=torch.long)
        g0_row = g0.reshape(n_groups, share_gsz)[:, 0]
        pfx_valid = torch.arange(Sp, device=dev)[None, :] \
            < (g0_row * P_)[:, None]                             # [G, Sp]
        tail_idx = (g0[:, None] + torch.arange(
            share_tail_pages, device=dev)[None, :]).clamp(
                0, pcfg.max_pages_per_seq - 1)                   # [B, Pt]
        tail_pos = g0[:, None] * P_ + torch.arange(St, device=dev)[None, :]
        tail_valid = torch.cat(
            [tail_pos < lens[:, None],
             torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
        pfx_tab0 = table.reshape(n_groups, share_gsz, -1)[
            :, 0, :share_prefix_pages].long()
        tail_tab0 = torch.gather(table.long(), 1, tail_idx)
    elif not use_paged_kernel:
        ctx_valid = torch.arange(pcfg.max_ctx, device=dev)[None, :] \
            < lens[:, None]
        ctx_seg = ctx_valid.to(torch.int32)                      # [B, ctx]
        ctx_pos = torch.arange(pcfg.max_ctx, dtype=torch.int32,
                               device=dev).expand(B, -1)
        seg_all = torch.cat([ctx_seg, seg_ids], dim=1)
        pos_all = torch.cat([ctx_pos, positions], dim=1)
        table_long = table.long()

    layers = params["layers"]
    new_k, new_v = [], []
    for li in range(cfg.n_layers):
        lp = _layer(layers, li)
        page_off = li * pcfg.n_pages
        h = rms_norm(x, lp["attn_norm"], eps=cfg.norm_eps)
        q_flat = _mm(h, lp["attn"]["wq"])
        k_flat = _mm(h, lp["attn"]["wk"])
        v_flat = _mm(h, lp["attn"]["wv"])
        if cfg.lora is not None:
            if expert_oh is not None:
                q_flat = lora_mod.apply_routed(lp["lora_wq"], cfg.lora, h,
                                               q_flat, expert_oh)
                v_flat = lora_mod.apply_routed(lp["lora_wv"], cfg.lora, h,
                                               v_flat, expert_oh)
            else:
                q_flat = lora_mod.apply(lp["lora_wq"], cfg.lora, h, q_flat,
                                        expert_idx=lora_expert)
                v_flat = lora_mod.apply(lp["lora_wv"], cfg.lora, h, v_flat,
                                        expert_idx=lora_expert)
        if T == 1:
            q = apply_rotary_flat_decode(q_flat, cos_q, sin_q, hd)
            k_new = apply_rotary_flat_decode(k_flat, cos_k, sin_k, hd)
        else:
            q = apply_rotary_flat(q_flat, cos_q, sin_q, perm_q)
            k_new = apply_rotary_flat(k_flat, cos_k, sin_k, perm_k)
        q = q.reshape(B, T, cfg.n_heads, hd)
        k_new = k_new.reshape(B, T, KH, hd)
        v_new = v_flat.reshape(B, T, KH, hd)

        # short blocks on a quantized pool quantize the in-flight tokens'
        # K/V here for their own attention; write_tokens quantizes the
        # same rows after the loop with the same function (bit-identical)
        quant_decode = pcfg.quantize_kv and T <= _SHORT_BLOCK_T
        if quant_decode:
            knq, kns = kv_pool.quantize_rows(k_new.reshape(B, T, kd), KH)
            vnq, vns = kv_pool.quantize_rows(v_new.reshape(B, T, kd), KH)

        if use_paged_kernel:
            attn = _paged_attention_with_self(
                q[:, 0].contiguous(), k_new[:, 0], v_new[:, 0], pool_k,
                pool_v, table + page_off, lens, cfg)[:, None]
        elif cascade:
            # shared prompt pages gathered once per group, the private
            # tail (+ the in-flight token) per slot
            pfx_tab = pfx_tab0 + page_off
            tail_tab = tail_tab0 + page_off
            kp = pool_k[pfx_tab].reshape(n_groups, Sp, kd)
            vp = pool_v[pfx_tab].reshape(n_groups, Sp, kd)
            kc_t = pool_k[tail_tab].reshape(B, St, kd)
            vc_t = pool_v[tail_tab].reshape(B, St, kd)
            ksp = vsp = kst = vst = None
            if quant_decode:
                ksp = pool_ks[pfx_tab].reshape(n_groups, Sp, KH)
                vsp = pool_vs[pfx_tab].reshape(n_groups, Sp, KH)
                kst = torch.cat(
                    [pool_ks[tail_tab].reshape(B, St, KH), kns], dim=1)
                vst = torch.cat(
                    [pool_vs[tail_tab].reshape(B, St, KH), vns], dim=1)
                k_tok, v_tok = knq, vnq
            else:
                k_tok = k_new.reshape(B, T, kd).to(kc_t.dtype)
                v_tok = v_new.reshape(B, T, kd).to(vc_t.dtype)
            attn = _cascade_decode_attention(
                q, share_gsz, kp, vp, pfx_valid,
                torch.cat([kc_t, k_tok], dim=1),
                torch.cat([vc_t, v_tok], dim=1), tail_valid,
                k_scale_p=ksp, v_scale_p=vsp, k_scale_t=kst, v_scale_t=vst)
        else:
            # gather this layer's pages dense (invalid tail masked through
            # ctx_seg), then context + the chunk itself; attention inside
            # the chunk is causal through the positional comparison
            table_l = table_long + page_off
            kc = pool_k[table_l].reshape(B, pcfg.max_ctx, KH, hd)
            vc = pool_v[table_l].reshape(B, pcfg.max_ctx, KH, hd)
            k_scale = v_scale = None
            if quant_decode:
                ks_c = pool_ks[table_l].reshape(B, pcfg.max_ctx, KH)
                vs_c = pool_vs[table_l].reshape(B, pcfg.max_ctx, KH)
                k_scale = torch.cat([ks_c, kns], dim=1)
                v_scale = torch.cat([vs_c, vns], dim=1)
                k_tok = knq.reshape(B, T, KH, hd)
                v_tok = vnq.reshape(B, T, KH, hd)
            else:
                if pcfg.quantize_kv:
                    # chunked prefill: dequantize the gathered context for
                    # the flash kernel (once per prompt, not per step)
                    ks_c = pool_ks[table_l].reshape(B, pcfg.max_ctx, KH)
                    vs_c = pool_vs[table_l].reshape(B, pcfg.max_ctx, KH)
                    kc = kc.to(cfg.dtype) * ks_c[..., None].to(cfg.dtype)
                    vc = vc.to(cfg.dtype) * vs_c[..., None].to(cfg.dtype)
                k_tok = k_new.to(kc.dtype)
                v_tok = v_new.to(vc.dtype)
            k_all = torch.cat([kc, k_tok], dim=1)
            v_all = torch.cat([vc, v_tok], dim=1)
            if T <= _SHORT_BLOCK_T:
                attn = _decode_attention_step(
                    q, k_all, v_all, seg_ids, seg_all, positions, pos_all,
                    k_scale=k_scale, v_scale=v_scale)
            else:
                attn = flash_attention(q, k_all, v_all, seg_ids, seg_all,
                                       causal=True, q_positions=positions,
                                       kv_positions=pos_all,
                                       backend=cfg.attn_backend)
        attn = attn.reshape(B, T, cfg.n_heads * hd).to(x.dtype)
        x = x + _mm(attn, lp["attn"]["wo"])
        h = rms_norm(x, lp["mlp_norm"], eps=cfg.norm_eps)
        gated = torch.nn.functional.silu(_mm(h, lp["mlp"]["w_gate"])) \
            * _mm(h, lp["mlp"]["w_up"])
        x = x + _mm(gated, lp["mlp"]["w_down"])
        new_k.append(k_new.reshape(B, T, kd))
        new_v.append(v_new.reshape(B, T, kd))

    if logits_at is not None:
        x = x[torch.arange(B, device=dev), logits_at.to(dev).long()][:, None]
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = _mm(x, params["lm_head"]).float()

    kv_pool.write_tokens(pool, pcfg, torch.stack(new_k), torch.stack(new_v),
                         slot_ids, start)
    pool["seq_len"].index_add_(0, slot_ids, seg_ids.sum(-1).to(torch.int32))
    return logits, pool
