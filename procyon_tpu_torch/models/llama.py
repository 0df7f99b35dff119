"""Llama-2 / Llama-3 decoder (counterpart of procyon_tpu/models/llama.py),
limited to the inference paths over the dense KV cache.

Takes token ids or pre-built input embeddings (the soft-token fusion path),
returns hidden states and LM logits, and supports an incremental KV cache.
Parameters are the JAX package's tree, bridged to torch (bridge.py):
stacked `[L, ...]` leaves read per layer in a Python loop where JAX used
`lax.scan`. Attention goes through ops/flash_attention.flash_attention
with `attn_backend` as its backend (the flash kernel on a CUDA tensor);
single-token decode over the cache is plain tensor code, as it is plain
jnp in the reference. `remat` is a training matter and is ignored.

Not ported yet (ROADMAP.md): `paged_forward`, the cascade decode and the
paged kernel's self-merge (queue 1, slice 3); int4 weights (queue 1,
remainder).
"""

import dataclasses
import math
from typing import Optional

import torch

from procyon_tpu_torch.models import lora as lora_mod
from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.ops.flash_attention import flash_attention
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
            want_logits: bool = True):
    """Run the decoder stack on the parameters' device.

    input_embeds [B, S, dim] (fusion path) or tokens [B, S]. seg_ids [B, S]
    (0 = pad). positions [B, S] absolute positions for RoPE.

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
    seg_ids = seg_ids.to(device=dev, dtype=torch.int32)
    positions = positions.to(device=dev, dtype=torch.int32)
    if int(positions.max()) >= cfg.max_seq_len:
        raise ValueError(f"position {int(positions.max())} >= max_seq_len "
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


def quantize_params(params, cfg: LlamaConfig, *, bits: int = 8):
    """Weight-only int8 quantization of the decoder (ops/quant.py). LoRA
    banks, norms and the embedding table stay in their dtype."""
    if bits != 8:
        raise NotImplementedError(
            f"{bits}-bit weights are not ported to procyon_tpu_torch yet "
            "(ROADMAP.md, queue 1, remainder: the int4 matvec kernel)")
    out = dict(params)
    out["layers"] = quant.quantize_tree(params["layers"])
    out["lm_head"] = quant.quantize(params["lm_head"])
    return out
