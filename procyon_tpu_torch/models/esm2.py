"""ESM2 protein language model encoder (counterpart of
procyon_tpu/models/esm2.py): the inference path and the live-encoder
training path.

Residue tokens in, per-token embeddings (and optionally MLM logits) out.
Parameters are the JAX package's tree, bridged to torch (bridge.py):
stacked `[L, ...]` leaves read per layer in a Python loop where JAX used
`lax.scan`. Two block layouts, as in the reference:
  * separate q/k/v projections (training / HF-converted layout);
  * fused `wqkv` (serving layout, `fuse_qkv_params`): one projection, the
    packed row-block attention kernel reading q/k/v in place, and, under
    W8A8, the fused LayerNorm + int8 MLP kernel.

The dispatch rules are the reference's, at the same shapes (esm2.py:271-323):
packed attention when S % 128 == 0, H*D % 128 == 0, 128 % D == 0 and no
prefix; the fused MLP when quant_mode == "w8a8", w1 is quantized,
(B*S) % 512 == 0 and ffn % 512 == 0; otherwise the non-fused MLP with
gelu_erf_fast. Attention outside the packed route goes through
ops/flash_attention.flash_attention with `attn_backend` as its backend, as
in the reference: "rowblock" the row-block kernels, None the flash kernel,
"ref" the CPU reference. Under autograd it takes the flash forward and the
backward kernels (`FlashAttention`).

Parameter-efficient tuning of the encoder (the reference's
freeze_protein_encoder "lora" / "qlora" recipes, esm.py:424-501):
  * (Mo)LoRA banks `lora_<name>` {A [L, E, in, r], B [L, E, r, out]} on
    the projections `lora_targets` names ("attn", "mlp" or "default");
    `lora_expert` picks the bank's expert (clamped to it, models/lora.py);
  * prefix tuning: P learned post-rotary K / V rows a layer, prepended to
    the keys with the identity rotation and segment 1;
  * a bottleneck adapter after each block's MLP (up projection
    zero-initialized, so it starts as the identity);
  * `merge_lora_params` folds the experts' mean delta into the base before
    `quantize_params` and `fuse_qkv_params` for serving.
With `cfg.remat`, a forward under autograd checkpoints each layer
(`torch.utils.checkpoint`, the counterpart of `jax.checkpoint`): the
backward recomputes each layer's forward, attention included.
"""

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from procyon_tpu_torch.models import lora as lora_mod
from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.models.llama import needs_grad
from procyon_tpu_torch.ops import quant
from procyon_tpu_torch.ops.activations import gelu_erf_fast
from procyon_tpu_torch.ops.attention_rowblock import rowblock_packed_qkv_fwd
from procyon_tpu_torch.ops.flash_attention import flash_attention
from procyon_tpu_torch.ops.fused_mlp import fused_ln_mlp_int8
from procyon_tpu_torch.ops.norms import layer_norm
from procyon_tpu_torch.ops.rotary import flat_rotary_tables
from procyon_tpu_torch.parallel import collectives as coll
from procyon_tpu_torch.parallel.sharding import split_group
from procyon_tpu_torch.utils import profiling

PAD_IDX = 1
MASK_IDX = 32
CLS_IDX = 0
EOS_IDX = 2
VOCAB = 33

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
    # prefix tuning: P learned post-rotary K/V rows per layer; 0 = off
    prefix_len: int = 0
    # encoder-side (Mo)LoRA; composes with quantize_params (QLoRA)
    lora: Optional[lora_mod.LoRAConfig] = None
    # which projections carry LoRA: "attn" = wq / wk / wv; "mlp" = the HF
    # "dense" targets (wo, w1, w2); "default" = all six
    lora_targets: str = "default"
    # bottleneck adapter rank (x += up(gelu(down(x))), up zero-init); 0 = off
    adapter_rank: int = 0
    dtype: torch.dtype = torch.bfloat16
    attn_backend: Optional[str] = None
    # checkpoint each layer of a forward under autograd
    remat: bool = True
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


_LORA_DIMS = {
    # projection name -> (in_dim, out_dim) as (dim, proj, ffn) sizes
    "wq": ("dim", "proj"), "wk": ("dim", "proj"), "wv": ("dim", "proj"),
    "wo": ("proj", "dim"), "w1": ("dim", "ffn"), "w2": ("ffn", "dim"),
}

_LORA_TARGET_SETS = {
    # the reference's target_lora_modules (esm.py:424-429): attn ->
    # query / key / value; mlp -> "dense" (HF module-name match: the
    # attention output and both MLP denses); default -> both
    "attn": ("wq", "wk", "wv"),
    "mlp": ("wo", "w1", "w2"),
    "default": ("wq", "wk", "wv", "wo", "w1", "w2"),
}


def lora_target_names(cfg: ESM2Config):
    return _LORA_TARGET_SETS[cfg.lora_targets]


def _lora_dims(cfg: ESM2Config, name):
    sizes = {"dim": cfg.dim, "proj": cfg.n_heads * cfg.head_dim,
             "ffn": cfg.ffn_dim}
    i, o = _LORA_DIMS[name]
    return sizes[i], sizes[o]


def init_params(seed: Seed, cfg: ESM2Config, *, device="cuda"):
    """Random parameters with the reference's distributions (esm2.py:166-240):
    dense weights N(0, 1/fan_in) (embedding and LM-head std as there), zero
    biases, unit norm scales; LoRA A ~ N(0, 1/in) and B = 0, prefix rows
    N(0, 0.02^2), the adapter's down projection N(0, 0.02^2) and its up
    projection 0. The numbers differ from jax.random's. `seed` is an int or
    a generator on `device` (models/_init.py)."""
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
    if cfg.prefix_len:
        P = cfg.prefix_len
        layers["prefix"] = {"k": dense((L, P, HD), scale=0.02),
                            "v": dense((L, P, HD), scale=0.02)}
    if cfg.lora is not None:
        for name in lora_target_names(cfg):
            di, do = _lora_dims(cfg, name)
            ps = [lora_mod.init_params(generator, cfg.lora, di, do,
                                       device=device) for _ in range(L)]
            layers[f"lora_{name}"] = {"A": torch.stack([p["A"] for p in ps]),
                                      "B": torch.stack([p["B"] for p in ps])}
    if cfg.adapter_rank:
        r = cfg.adapter_rank
        layers["adapter"] = {"wd": dense((L, cfg.dim, r), scale=0.02),
                             "bd": zeros((L, r)),
                             "wu": zeros((L, r, cfg.dim)),
                             "bu": zeros((L, cfg.dim))}
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


def prefix_key_rotation(rot, P: int):
    """The keys' rotary tables with P prefix rows in front: the identity
    rotation (cos 1, sin 0). The prefix K rows are learned after rotary
    (the reference stores rotated keys in its past_key_values), so they
    must not be rotated again."""
    cos, sin = rot
    return (torch.cat([torch.ones((P,) + cos.shape[1:], dtype=cos.dtype,
                                  device=cos.device), cos]),
            torch.cat([torch.zeros((P,) + sin.shape[1:], dtype=sin.dtype,
                                   device=sin.device), sin]))


def _attention(q, k, v, seg, rot, cfg: ESM2Config, prefix=None,
               n_heads=None):
    """q/k/v [B, S, H*D] pre-rotary -> [B, S, H*D]. On a CUDA tensor every
    backend ends in a kernel: "rowblock" in the packed row-block kernel
    (rotary fused) or, where that does not apply (head_dim 24, a prefix,
    under autograd), in the flash kernel, as None does. "ref" is the CPU
    reference. `prefix` {"k", "v"} [P, H*D] prepends P key / value rows
    (segment 1, identity rotation) that every query may attend. n_heads:
    the heads q / k / v hold (a rank's, under tensor parallelism)."""
    B, S, HD = q.shape
    shape4 = (B, S, n_heads or cfg.n_heads, cfg.head_dim)
    q, k, v = q.reshape(shape4), k.reshape(shape4), v.reshape(shape4)
    seg_kv, rot_k = seg, rot
    if prefix is not None:
        P = cfg.prefix_len
        pk, pv = (prefix[n].reshape(1, P, *shape4[2:]).expand(
            B, P, *shape4[2:]).to(k.dtype) for n in ("k", "v"))
        k = torch.cat([pk, k], 1)
        v = torch.cat([pv, v], 1)
        seg_kv = torch.cat([torch.ones((B, P), dtype=seg.dtype,
                                       device=seg.device), seg], 1)
        rot_k = prefix_key_rotation(rot, P)
    out = flash_attention(q, k, v, seg, seg_kv, backend=cfg.attn_backend,
                          rope=(rot[0], rot[1], rot_k[0], rot_k[1]))
    return out.reshape(B, S, HD)


def _lora(lp, name, cfg: ESM2Config, inp, out, lora_expert):
    """out plus the LoRA delta of projection `name`, where it has a bank."""
    bank = lp.get(f"lora_{name}")
    if cfg.lora is None or bank is None:
        return out
    return lora_mod.apply(bank, cfg.lora, inp, out, expert_idx=lora_expert)


def _adapter(y, lp, cfg: ESM2Config):
    """The bottleneck adapter after the MLP's residual (up zero-init)."""
    a = lp.get("adapter")
    if not cfg.adapter_rank or a is None:
        return y
    mid = gelu_erf_fast(y @ a["wd"], a["bd"])
    return y + (mid @ a["wu"] + a["bu"]).to(y.dtype)


def _lora_col(lp, name, cfg: ESM2Config, inp, out, lora_expert, g):
    """_lora onto a column-split product: the whole delta from the
    replicated input, then this rank's columns."""
    if g is None or cfg.lora is None or lp.get(f"lora_{name}") is None:
        return _lora(lp, name, cfg, inp, out, lora_expert)
    return out + coll.split_to(_lora(lp, name, cfg, inp, 0.0, lora_expert),
                               g)


def _row(lp, group, name, cfg: ESM2Config, inp, lora_expert, g):
    """A row-split product (this rank's input columns) summed over the
    group, plus the LoRA delta of the whole (gathered) input."""
    out = coll.reduce_from(quant.mm(inp, lp[group][name], cfg.quant_mode), g)
    if g is None or cfg.lora is None or lp.get(f"lora_{name}") is None:
        return _lora(lp, name, cfg, inp, out, lora_expert)
    return _lora(lp, name, cfg, coll.gather_from(inp, g), out, lora_expert)


def _mlp(x, lp, cfg: ESM2Config, lora_expert=0, mesh=None):
    """The MLP with its residual; under a split MLP (mesh), this rank's
    columns of w1 / rows of w2 and the all-reduce after w2."""
    mode = cfg.quant_mode
    g = split_group(lp["mlp"]["w1"], cfg.ffn_dim, mesh)
    h = layer_norm(x, lp["mlp_norm"]["w"], lp["mlp_norm"]["b"],
                   eps=cfg.norm_eps)
    h1 = _lora_col(lp, "w1", cfg, h,
                   quant.mm(coll.copy_to(h, g), lp["mlp"]["w1"], mode),
                   lora_expert, g)
    b1 = coll.split_to(lp["mlp"]["b1"], g)
    if cfg.gelu_approx:
        h1 = h1 + b1
        h = torch.nn.functional.gelu(h1.float(), approximate="tanh").to(
            h1.dtype)
    else:
        h = gelu_erf_fast(h1, b1)
    x = x + _row(lp, "mlp", "w2", cfg, h, lora_expert, g) + lp["mlp"]["b2"]
    return _adapter(x, lp, cfg)


def _block(x, lp, seg, rot, cfg: ESM2Config, lora_expert=0, mesh=None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    HD = cfg.n_heads * hd
    mode = cfg.quant_mode
    h = layer_norm(x, lp["attn_norm"]["w"], lp["attn_norm"]["b"],
                   eps=cfg.norm_eps)
    if "wqkv" in lp["attn"]:
        qkv = quant.mm(h, lp["attn"]["wqkv"], mode) + lp["attn"]["bqkv"]
        if (cfg.attn_backend == "rowblock" and not cfg.prefix_len
                and S % 128 == 0 and HD % 128 == 0 and 128 % hd == 0):
            attn = rowblock_packed_qkv_fwd(
                qkv, seg, n_heads=cfg.n_heads, head_dim=hd,
                sm_scale=1.0 / hd ** 0.5, rope=(rot[0], rot[1], rot[0],
                                                rot[1]))
            x = x + quant.mm(attn, lp["attn"]["wo"], mode) \
                + lp["attn"]["bo"]
            if (mode == "w8a8" and quant.is_quantized(lp["mlp"]["w1"])
                    and (B * S) % 512 == 0 and cfg.ffn_dim % 512 == 0):
                m = lp["mlp"]
                out = fused_ln_mlp_int8(
                    x.reshape(B * S, cfg.dim), lp["mlp_norm"]["w"],
                    lp["mlp_norm"]["b"], m["w1"]["q"], m["w1"]["s"], m["b1"],
                    m["w2"]["q"], m["w2"]["s"], m["b2"], eps=cfg.norm_eps,
                    add_residual=True)
                return _adapter(out.reshape(B, S, cfg.dim), lp, cfg)
            return _mlp(x, lp, cfg, mesh=mesh)
        q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
        g = None
    else:
        g = split_group(lp["attn"]["wq"], HD, mesh)
        h_in = coll.copy_to(h, g)
        q, k, v = (_lora_col(lp, n, cfg, h,
                             quant.mm(h_in, lp["attn"][n], mode)
                             + coll.split_to(lp["attn"]["b" + n[1:]], g),
                             lora_expert, g)
                   for n in ("wq", "wk", "wv"))
    prefix = lp.get("prefix") if cfg.prefix_len else None
    if prefix is not None and g is not None:
        prefix = {n: coll.split_to(prefix[n], g) for n in ("k", "v")}
    n_heads = cfg.n_heads // coll.size(g)
    attn = _attention(q, k, v, seg, rot, cfg, prefix=prefix,
                      n_heads=n_heads).to(x.dtype)
    x = x + _row(lp, "attn", "wo", cfg, attn, lora_expert, g) \
        + lp["attn"]["bo"]
    return _mlp(x, lp, cfg, lora_expert, mesh)


def forward(params, cfg: ESM2Config, tokens: torch.Tensor, *,
            seg_ids: Optional[torch.Tensor] = None,
            return_logits: bool = False, lora_expert=0, mesh=None):
    """tokens [B, S] (ESM alphabet, cls/eos included), on the parameters'
    device. Returns {"hidden": [B, S, dim] after the final LayerNorm,
    "logits": [B, S, vocab] f32 when return_logits}. Padding (PAD_IDX) is
    masked out of attention through segment ids. lora_expert selects the
    active (Mo)LoRA expert (the reference's set_prot_lora_group). mesh:
    with a `model` axis, `params` are this rank's slices and the blocks
    run tensor-parallel (the separate q / k / v layout; a fused wqkv is
    replicated), as llama.forward's."""
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
    attn0 = params["layers"]["attn"]
    n_heads = cfg.n_heads if "wqkv" in attn0 else cfg.n_heads // coll.size(
        split_group(attn0["wq"], cfg.n_heads * cfg.head_dim, mesh))
    with profiling.span("esm2.rotary"):
        cos_f, sin_f, _ = flat_rotary_tables(cfg.head_dim, n_heads,
                                             cfg.max_seq_len)
        rot = (cos_f[:S].to(device=x.device, dtype=cfg.dtype),
               sin_f[:S].to(device=x.device, dtype=cfg.dtype))

    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        if cfg.remat and needs_grad(x, lp):
            x = torch.utils.checkpoint.checkpoint(
                _block, x, lp, seg_ids, rot, cfg, lora_expert=lora_expert,
                mesh=mesh, use_reentrant=False)
        else:
            x = _block(x, lp, seg_ids, rot, cfg, lora_expert=lora_expert,
                       mesh=mesh)

    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"],
                   eps=cfg.norm_eps)
    out = {"hidden": x}
    if return_logits:
        lm = params["lm_head"]
        h = gelu_erf_fast(x @ lm["dense_w"], lm["dense_b"])
        h = layer_norm(h, lm["norm"]["w"], lm["norm"]["b"], eps=cfg.norm_eps)
        logits = h @ params["embed"].t().to(h.dtype)
        out["logits"] = logits.float() + lm["bias"]
    return out


def quantize_params(params, cfg: ESM2Config):
    """int8 per-output-channel weights for the encoder projections; norms,
    biases, the tied embedding / LM head, LoRA banks, prefix rows and the
    adapter stay as they are (QLoRA: an int8 frozen base under bf16
    banks)."""
    out = dict(params)
    out["layers"] = quant.quantize_tree(
        params["layers"], keys=("wq", "wk", "wv", "wo", "w1", "w2"))
    return out


@torch.no_grad()
def merge_lora_params(params, cfg: ESM2Config):
    """Fold the experts' mean LoRA delta into the base weights and drop the
    banks (the reference's merge by averaging, mlora.py:417-431) for
    serving: w + scaling * mean_e A_e @ B_e, summed in f32 and cast to w's
    dtype, one layer at a time. Needs an unquantized tree (merge before
    quantize_params, as peft's merge_and_unload comes before bnb)."""
    if cfg.lora is None:
        raise ValueError("merge_lora_params needs a config with LoRA")
    layers = dict(params["layers"])
    for name in lora_target_names(cfg):
        bank = layers.pop(f"lora_{name}", None)
        if bank is None:
            continue
        group = "attn" if name in ("wq", "wk", "wv", "wo") else "mlp"
        w = layers[group][name]
        if quant.is_quantized(w) or quant.is_quantized4(w):
            raise ValueError("merge LoRA before quantize_params")
        E = bank["A"].shape[1]
        merged = torch.empty_like(w)
        for i in range(w.shape[0]):
            delta = torch.einsum("eir,ero->io", bank["A"][i].float(),
                                 bank["B"][i].float())
            delta = cfg.lora.scaling * delta / E
            merged[i] = (w[i].float() + delta).to(w.dtype)
        layers[group] = {**layers[group], name: merged}
    return {**params, "layers": layers}


def fuse_qkv_params(params):
    """Serving layout: q/k/v concatenated into one [L, d, 3*H*D] weight
    (`wqkv`, quantized or not) and one [L, 3*H*D] bias; int8 MLP weights
    kept [in, out] as views of [out, in] storage, the layout the fused MLP
    kernels read (`bridge.int8_k_major` then copies nothing). LoRA banks
    must be merged first (merge_lora_params): the fused layout does not
    apply them."""
    layers = dict(params["layers"])
    if any(k.startswith("lora_") for k in layers):
        raise ValueError("merge_lora_params before fuse_qkv_params")
    mlp = dict(layers["mlp"])
    for n in ("w1", "w2"):
        if quant.is_quantized(mlp[n]):
            q = mlp[n]["q"].transpose(-1, -2).contiguous().transpose(-1, -2)
            mlp[n] = {"q": q, "s": mlp[n]["s"]}
    layers["mlp"] = mlp
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
