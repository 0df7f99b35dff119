"""ESM2 protein language model encoder (counterpart of
procyon_tpu/models/esm2.py), limited to the inference path.

Residue tokens in, per-token embeddings (and optionally MLM logits) out.
Parameters are the JAX package's tree, bridged to torch (bridge.py):
stacked `[L, ...]` leaves read per layer in a Python loop where JAX used
`lax.scan`. Two block layouts, as in the reference:
  * separate q/k/v projections (training / HF-converted layout);
  * fused `wqkv` (serving layout, `fuse_qkv_params`): one projection, the
    packed row-block attention kernel reading q/k/v in place, and, under
    W8A8, the fused LayerNorm + int8 MLP kernel.

The dispatch rules are the reference's, at the same shapes (esm2.py:271-323):
packed attention when S % 128 == 0, H*D % 128 == 0 and 128 % D == 0; the
fused MLP when quant_mode == "w8a8", w1 is quantized, (B*S) % 512 == 0 and
ffn % 512 == 0; otherwise the non-fused MLP with gelu_erf_fast.
Attention outside the packed route goes through
ops/flash_attention.flash_attention with `attn_backend` as its backend, as
in the reference: "rowblock" the row-block kernels, None the flash kernel,
"ref" the CPU reference.

Not ported yet (see ROADMAP.md, slice 1 remainder): LoRA, prefix tuning and
the bottleneck adapter raise NotImplementedError instead of dropping out.
"""

import dataclasses
from typing import Any, Optional

import torch

from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.ops.activations import gelu_erf_fast
from procyon_tpu_torch.ops.attention_rowblock import rowblock_packed_qkv_fwd
from procyon_tpu_torch.ops.flash_attention import flash_attention
from procyon_tpu_torch.ops.fused_mlp import fused_ln_mlp_int8
from procyon_tpu_torch.ops.norms import layer_norm
from procyon_tpu_torch.ops.rotary import flat_rotary_tables

PAD_IDX = 1
MASK_IDX = 32
CLS_IDX = 0
EOS_IDX = 2
VOCAB = 33

_NOT_PORTED = ("{} is not ported to procyon_tpu_torch yet (ROADMAP.md, "
               "queue 1, slice 1 remainder)")


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = VOCAB
    dim: int = 1280
    n_layers: int = 33
    n_heads: int = 20
    norm_eps: float = 1e-5
    max_seq_len: int = 1026
    token_dropout: bool = True
    gelu_approx: bool = False
    pad_aware_token_dropout: bool = True
    prefix_len: int = 0
    lora: Optional[Any] = None
    adapter_rank: int = 0
    dtype: torch.dtype = torch.bfloat16
    attn_backend: Optional[str] = None
    quant_mode: str = "dequant"

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @property
    def ffn_dim(self):
        return 4 * self.dim


_SIZES = {
    "8m": dict(dim=320, n_layers=6, n_heads=20),
    "35m": dict(dim=480, n_layers=12, n_heads=20),
    "150m": dict(dim=640, n_layers=30, n_heads=20),
    "650m": dict(dim=1280, n_layers=33, n_heads=20),
    "3b": dict(dim=2560, n_layers=36, n_heads=40),
    "15b": dict(dim=5120, n_layers=48, n_heads=40),
}


def esm2_config(size: str, **kw) -> ESM2Config:
    base = dict(_SIZES[size])
    base.update(kw)
    return ESM2Config(**base)


def tiny_config(**kw) -> ESM2Config:
    base = dict(dim=64, n_layers=2, n_heads=4, dtype=torch.float32,
                max_seq_len=64)
    base.update(kw)
    return ESM2Config(**base)


def _check_ported(cfg: ESM2Config):
    if cfg.lora is not None:
        raise NotImplementedError(_NOT_PORTED.format("ESM2 LoRA"))
    if cfg.prefix_len:
        raise NotImplementedError(_NOT_PORTED.format("ESM2 prefix tuning"))
    if cfg.adapter_rank:
        raise NotImplementedError(_NOT_PORTED.format("the ESM2 adapter"))


def init_params(seed: Seed, cfg: ESM2Config, *, device="cuda"):
    """Random parameters with the reference's distributions (esm2.py:166-240):
    dense weights N(0, 1/fan_in) (embedding and LM-head std as there), zero
    biases, unit norm scales. The numbers differ from jax.random's. `seed`
    is an int or a generator on `device` (models/_init.py)."""
    _check_ported(cfg)
    generator, device = make_generator(seed, device)
    L, hd = cfg.n_layers, cfg.head_dim
    HD = cfg.n_heads * hd

    def dense(shape, scale=None):
        if scale is None:
            scale = 1.0 / (shape[-2] ** 0.5)
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "attn": {
            "wq": dense((L, cfg.dim, HD)), "bq": zeros((L, HD)),
            "wk": dense((L, cfg.dim, HD)), "bk": zeros((L, HD)),
            "wv": dense((L, cfg.dim, HD)), "bv": zeros((L, HD)),
            "wo": dense((L, HD, cfg.dim)), "bo": zeros((L, cfg.dim)),
        },
        "mlp": {
            "w1": dense((L, cfg.dim, cfg.ffn_dim)),
            "b1": zeros((L, cfg.ffn_dim)),
            "w2": dense((L, cfg.ffn_dim, cfg.dim)),
            "b2": zeros((L, cfg.dim)),
        },
        "attn_norm": {"w": ones((L, cfg.dim)), "b": zeros((L, cfg.dim))},
        "mlp_norm": {"w": ones((L, cfg.dim)), "b": zeros((L, cfg.dim))},
    }
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), scale=0.02),
        "layers": layers,
        "final_norm": {"w": ones((cfg.dim,)), "b": zeros((cfg.dim,))},
        "lm_head": {
            "dense_w": dense((cfg.dim, cfg.dim)),
            "dense_b": zeros((cfg.dim,)),
            "norm": {"w": ones((cfg.dim,)), "b": zeros((cfg.dim,))},
            "bias": torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                                device=device),
        },
    }


def _layer(layers, i: int):
    """Layer i's view of the stacked [L, ...] tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _attention(q, k, v, seg, rot, cfg: ESM2Config):
    """q/k/v [B, S, H*D] pre-rotary -> [B, S, H*D]. On a CUDA tensor every
    backend ends in a kernel: "rowblock" in the packed row-block kernel
    (rotary fused) or, where that does not apply (head_dim 24), in the
    flash kernel, as None does. "ref" is the CPU reference."""
    B, S, HD = q.shape
    shape4 = (B, S, cfg.n_heads, cfg.head_dim)
    out = flash_attention(q.reshape(shape4), k.reshape(shape4),
                          v.reshape(shape4), seg, seg,
                          backend=cfg.attn_backend,
                          rope=(rot[0], rot[1], rot[0], rot[1]))
    return out.reshape(B, S, HD)


def _mlp(x, lp, cfg: ESM2Config):
    h = layer_norm(x, lp["mlp_norm"]["w"], lp["mlp_norm"]["b"],
                   eps=cfg.norm_eps)
    h1 = quant.mm(h, lp["mlp"]["w1"], cfg.quant_mode) + lp["mlp"]["b1"]
    if cfg.gelu_approx:
        h = torch.nn.functional.gelu(h1.float(), approximate="tanh").to(
            h1.dtype)
    else:
        h = gelu_erf_fast(h1)
    return x + quant.mm(h, lp["mlp"]["w2"], cfg.quant_mode) + lp["mlp"]["b2"]


def _block(x, lp, seg, rot, cfg: ESM2Config):
    B, S, _ = x.shape
    hd = cfg.head_dim
    HD = cfg.n_heads * hd
    h = layer_norm(x, lp["attn_norm"]["w"], lp["attn_norm"]["b"],
                   eps=cfg.norm_eps)
    if "wqkv" in lp["attn"]:
        qkv = quant.mm(h, lp["attn"]["wqkv"], cfg.quant_mode) \
            + lp["attn"]["bqkv"]
        if (cfg.attn_backend == "rowblock" and S % 128 == 0
                and HD % 128 == 0 and 128 % hd == 0):
            attn = rowblock_packed_qkv_fwd(
                qkv, seg, n_heads=cfg.n_heads, head_dim=hd,
                sm_scale=1.0 / hd ** 0.5, rope=(rot[0], rot[1], rot[0],
                                                rot[1]))
            x = x + quant.mm(attn, lp["attn"]["wo"], cfg.quant_mode) \
                + lp["attn"]["bo"]
            if (cfg.quant_mode == "w8a8"
                    and quant.is_quantized(lp["mlp"]["w1"])
                    and (B * S) % 512 == 0 and cfg.ffn_dim % 512 == 0):
                m = lp["mlp"]
                out = fused_ln_mlp_int8(
                    x.reshape(B * S, cfg.dim), lp["mlp_norm"]["w"],
                    lp["mlp_norm"]["b"], m["w1"]["q"], m["w1"]["s"], m["b1"],
                    m["w2"]["q"], m["w2"]["s"], m["b2"], eps=cfg.norm_eps,
                    add_residual=True)
                return out.reshape(B, S, cfg.dim)
            return _mlp(x, lp, cfg)
        q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    else:
        q = quant.mm(h, lp["attn"]["wq"], cfg.quant_mode) + lp["attn"]["bq"]
        k = quant.mm(h, lp["attn"]["wk"], cfg.quant_mode) + lp["attn"]["bk"]
        v = quant.mm(h, lp["attn"]["wv"], cfg.quant_mode) + lp["attn"]["bv"]
    attn = _attention(q, k, v, seg, rot, cfg).to(x.dtype)
    x = x + quant.mm(attn, lp["attn"]["wo"], cfg.quant_mode) \
        + lp["attn"]["bo"]
    return _mlp(x, lp, cfg)


def forward(params, cfg: ESM2Config, tokens: torch.Tensor, *,
            seg_ids: Optional[torch.Tensor] = None,
            return_logits: bool = False):
    """tokens [B, S] (ESM alphabet, cls/eos included), on the parameters'
    device. Returns {"hidden": [B, S, dim] after the final LayerNorm,
    "logits": [B, S, vocab] f32 when return_logits}. Padding (PAD_IDX) is
    masked out of attention through segment ids."""
    _check_ported(cfg)
    B, S = tokens.shape
    tokens = tokens.long()
    if seg_ids is None:
        seg_ids = (tokens != PAD_IDX).to(torch.int32)
    seg_ids = seg_ids.to(torch.int32).contiguous()

    x = params["embed"][tokens].float()
    if cfg.token_dropout:
        # fair-esm token-dropout rescale: <mask> embeddings zeroed, the rest
        # scaled by (1 - 0.15*0.8) / (1 - observed mask ratio); with no mask
        # tokens every embedding is scaled by 0.88
        is_mask = tokens == MASK_IDX
        x = torch.where(is_mask[..., None], 0.0, x)
        if cfg.pad_aware_token_dropout:
            valid = seg_ids > 0
            n_valid = valid.sum(-1).clamp_min(1)
            ratio = (is_mask & valid).sum(-1) / n_valid
        else:
            ratio = is_mask.sum(-1) / S
        scale = (1.0 - 0.15 * 0.8) / (1.0 - ratio.float()).clamp_min(1e-3)
        x = x * scale[:, None, None]
    x = x.to(cfg.dtype)

    if S > cfg.max_seq_len:
        raise ValueError(f"{S} tokens per row > max_seq_len "
                         f"{cfg.max_seq_len}")
    cos_f, sin_f, _ = flat_rotary_tables(cfg.head_dim, cfg.n_heads,
                                         cfg.max_seq_len)
    rot = (cos_f[:S].to(device=x.device, dtype=cfg.dtype),
           sin_f[:S].to(device=x.device, dtype=cfg.dtype))

    layers = params["layers"]
    for i in range(cfg.n_layers):
        x = _block(x, _layer(layers, i), seg_ids, rot, cfg)

    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"],
                   eps=cfg.norm_eps)
    out = {"hidden": x}
    if return_logits:
        lm = params["lm_head"]
        h = gelu_erf_fast(x @ lm["dense_w"] + lm["dense_b"])
        h = layer_norm(h, lm["norm"]["w"], lm["norm"]["b"], eps=cfg.norm_eps)
        logits = h @ params["embed"].t().to(h.dtype)
        out["logits"] = logits.float() + lm["bias"]
    return out


def quantize_params(params, cfg: ESM2Config):
    """int8 per-output-channel weights for the encoder projections; norms,
    biases and the tied embedding / LM head stay as they are."""
    out = dict(params)
    out["layers"] = quant.quantize_tree(
        params["layers"], keys=("wq", "wk", "wv", "wo", "w1", "w2"))
    return out


def fuse_qkv_params(params):
    """Serving layout: q/k/v concatenated into one [L, d, 3*H*D] weight
    (`wqkv`, quantized or not) and one [L, 3*H*D] bias."""
    layers = dict(params["layers"])
    if any(k.startswith("lora_") for k in layers):
        raise NotImplementedError(_NOT_PORTED.format("ESM2 LoRA"))
    attn = dict(layers["attn"])
    ws = [attn.pop(n) for n in ("wq", "wk", "wv")]
    if quant.is_quantized(ws[0]):
        attn["wqkv"] = {"q": torch.cat([w["q"] for w in ws], -1),
                        "s": torch.cat([w["s"] for w in ws], -1)}
    else:
        attn["wqkv"] = torch.cat(ws, -1)
    attn["bqkv"] = torch.cat([attn.pop(n) for n in ("bq", "bk", "bv")], -1)
    layers["attn"] = attn
    return {**params, "layers": layers}
