"""BERT-family text encoder (counterpart of procyon_tpu/models/bert.py).

The one encoder behind BERTScore (evaluate/bertscore.py, the reference's
en-sci scorer: SciBERT) and the text towers of the BioTranslator, ProtST,
PubMedBERT and SimCSE baselines (evaluate/baselines/text_models.py).
Parameters are the JAX package's tree (bridge.py carries it across):
stacked `[L, ...]` leaves, `[in, out]` dense weights, read per layer in a
Python loop where JAX used `lax.scan`.

BERT's own semantics, as in the reference:
  * learned absolute position and token-type embeddings, LayerNorm eps
    1e-12;
  * post-LayerNorm residual blocks (the LayerNorm after each residual add,
    unlike ESM2 and Llama);
  * erf GELU (`ops/activations.gelu_erf_fast`), and the tanh pooler on
    [CLS].

Attention is bidirectional over right-padded rows, through
`ops/flash_attention.flash_attention(q, k, v, seg, seg, causal=False,
backend=cfg.attn_backend)`: on a CUDA bf16 tensor the flash forward kernel
(csrc/flash_attention_fwd.cu, head_dim 64 at every released size), on a
CPU tensor its plain version. A pad query row sees no key and comes out 0.
`convert_hf_state` / `load_hf_checkpoint` read an HF BERT / SciBERT /
PubMedBERT / SimCSE state dict from a local file (safetensors, read here
without the package, or pytorch_model.bin); nothing is fetched.
"""

import dataclasses
import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from procyon_tpu_torch.models._init import Seed, make_generator
from procyon_tpu_torch.ops.activations import gelu_erf_fast
from procyon_tpu_torch.ops.flash_attention import flash_attention
from procyon_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_position: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    pad_id: int = 0
    dtype: torch.dtype = torch.bfloat16
    # None: the flash kernel (its plain version on the CPU); "ref": the
    # O(S^2) CPU reference
    attn_backend: Optional[str] = None

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @property
    def ffn_dim(self):
        return 4 * self.dim


def bert_config(size: str = "base", **kw) -> BertConfig:
    sizes = {
        "base": dict(dim=768, n_layers=12, n_heads=12),
        "large": dict(dim=1024, n_layers=24, n_heads=16),
    }
    base = dict(sizes[size])
    base.update(kw)
    return BertConfig(**base)


def tiny_config(**kw) -> BertConfig:
    base = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                max_position=64, dtype=torch.float32)
    base.update(kw)
    return BertConfig(**base)


def init_params(seed: Seed, cfg: BertConfig, *, device="cuda"):
    """Random parameters in the reference's tree and distributions (dense
    weights and embeddings N(0, 0.02), zero biases, unit norm scales);
    the numbers differ from jax.random's. `seed` is an int or a generator
    on `device` (models/_init.py)."""
    generator, device = make_generator(seed, device)
    L, d, f = cfg.n_layers, cfg.dim, cfg.ffn_dim

    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "attn": {
            "wq": dense((L, d, d)), "bq": zeros((L, d)),
            "wk": dense((L, d, d)), "bk": zeros((L, d)),
            "wv": dense((L, d, d)), "bv": zeros((L, d)),
            "wo": dense((L, d, d)), "bo": zeros((L, d)),
        },
        # post-LN: applied after each residual add
        "attn_norm": {"w": ones((L, d)), "b": zeros((L, d))},
        "mlp": {
            "w1": dense((L, d, f)), "b1": zeros((L, f)),
            "w2": dense((L, f, d)), "b2": zeros((L, d)),
        },
        "mlp_norm": {"w": ones((L, d)), "b": zeros((L, d))},
    }
    return {
        "embed": {
            "word": dense((cfg.vocab_size, d)),
            "position": dense((cfg.max_position, d)),
            "token_type": dense((cfg.type_vocab_size, d)),
            "norm": {"w": ones((d,)), "b": zeros((d,))},
        },
        "layers": layers,
        "pooler": {"w": dense((d, d)), "b": zeros((d,))},
    }


def _layer(layers, i: int):
    """Layer i's view of the stacked [L, ...] tree."""
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _block(x, lp, seg_ids, cfg: BertConfig):
    B, S, _ = x.shape
    shape4 = (B, S, cfg.n_heads, cfg.head_dim)
    a = lp["attn"]
    q = (x @ a["wq"] + a["bq"]).reshape(shape4)
    k = (x @ a["wk"] + a["bk"]).reshape(shape4)
    v = (x @ a["wv"] + a["bv"]).reshape(shape4)
    attn = flash_attention(q, k, v, seg_ids, seg_ids, causal=False,
                           backend=cfg.attn_backend)
    attn = attn.reshape(B, S, cfg.dim).to(x.dtype)
    x = layer_norm(x + attn @ a["wo"] + a["bo"], lp["attn_norm"]["w"],
                   lp["attn_norm"]["b"], eps=cfg.norm_eps)
    m = lp["mlp"]
    h = gelu_erf_fast(x @ m["w1"] + m["b1"])
    return layer_norm(x + h @ m["w2"] + m["b2"], lp["mlp_norm"]["w"],
                      lp["mlp_norm"]["b"], eps=cfg.norm_eps)


def forward(params, cfg: BertConfig, tokens: torch.Tensor, *,
            token_type_ids: Optional[torch.Tensor] = None,
            seg_ids: Optional[torch.Tensor] = None,
            return_all_hidden: bool = False,
            n_layers: Optional[int] = None):
    """tokens [B, S] (WordPiece ids, [CLS] / [SEP] included), on the
    parameters' device; seg_ids [B, S] (0 = padding) default to tokens !=
    pad_id.

    Returns {"hidden": [B, S, dim], "pooled": [B, dim] f32,
    "all_hidden": [layers + 1, B, S, dim] when asked}: all_hidden[0] is the
    embedding output, all_hidden[i] the output of layer i (the layout
    bert_score indexes). n_layers < cfg.n_layers stops after that many
    blocks: "hidden" is then all_hidden[n_layers] of the whole stack, the
    same tensor, and there is no "pooled" (the pooler reads the last
    layer)."""
    B, S = tokens.shape
    dev = params["embed"]["word"].device
    tokens = tokens.to(dev).long()
    if seg_ids is None:
        seg_ids = (tokens != cfg.pad_id).to(torch.int32)
    seg_ids = seg_ids.to(device=dev, dtype=torch.int32).contiguous()
    if token_type_ids is None:
        token_type_ids = torch.zeros((B, S), dtype=torch.long, device=dev)
    if S > cfg.max_position:
        raise ValueError(f"{S} tokens per row > max_position "
                         f"{cfg.max_position}")
    depth = cfg.n_layers if n_layers is None else n_layers
    if not 0 <= depth <= cfg.n_layers:
        raise ValueError(f"n_layers {n_layers} out of range for a "
                         f"{cfg.n_layers}-layer encoder")

    emb = params["embed"]
    x = (emb["word"][tokens].float()
         + emb["position"][:S][None].float()
         + emb["token_type"][token_type_ids.to(dev).long()].float())
    x = layer_norm(x, emb["norm"]["w"], emb["norm"]["b"],
                   eps=cfg.norm_eps).to(cfg.dtype)
    hidden = [x] if return_all_hidden else None
    for i in range(depth):
        x = _block(x, _layer(params["layers"], i), seg_ids, cfg)
        if return_all_hidden:
            hidden.append(x)

    out = {"hidden": x}
    if depth == cfg.n_layers:
        p = params["pooler"]
        out["pooled"] = torch.tanh(x[:, 0].float() @ p["w"].float()
                                   + p["b"].float())
    if return_all_hidden:
        out["all_hidden"] = torch.stack(hidden)
    return out


def pool(hidden, seg_ids, how: str = "mean", pooled=None):
    """SimCSE-style poolers (procyon/model/simcse.py:21-72): cls (the tanh
    pooler's output when given), cls_before_pooler, mean (avg), max; the
    mean and max over the rows seg_ids marks (> 0)."""
    if how == "cls" and pooled is not None:
        return pooled
    if how in ("cls", "cls_before_pooler"):
        return hidden[:, 0]
    mask = seg_ids.to(device=hidden.device, dtype=hidden.dtype)[..., None]
    if how in ("mean", "avg"):
        return (hidden * mask).sum(1) / mask.sum(1).clamp_min(1e-6)
    if how == "max":
        neg = torch.finfo(hidden.dtype).min
        return torch.where(mask > 0, hidden, neg).amax(1)
    raise ValueError(f"unknown pooler {how!r}")


# ---------------------------------------------------------------------------
# HF checkpoint ingestion (a local state dict -> the parameter tree)

_HF_LAYER_RE = re.compile(r"encoder\.layer\.(\d+)\.(.+)")

_HF_LAYER_MAP = {
    # HF name tail -> (group, key, transpose)
    "attention.self.query.weight": ("attn", "wq", True),
    "attention.self.query.bias": ("attn", "bq", False),
    "attention.self.key.weight": ("attn", "wk", True),
    "attention.self.key.bias": ("attn", "bk", False),
    "attention.self.value.weight": ("attn", "wv", True),
    "attention.self.value.bias": ("attn", "bv", False),
    "attention.output.dense.weight": ("attn", "wo", True),
    "attention.output.dense.bias": ("attn", "bo", False),
    "attention.output.LayerNorm.weight": ("attn_norm", "w", False),
    "attention.output.LayerNorm.bias": ("attn_norm", "b", False),
    "intermediate.dense.weight": ("mlp", "w1", True),
    "intermediate.dense.bias": ("mlp", "b1", False),
    "output.dense.weight": ("mlp", "w2", True),
    "output.dense.bias": ("mlp", "b2", False),
    "output.LayerNorm.weight": ("mlp_norm", "w", False),
    "output.LayerNorm.bias": ("mlp_norm", "b", False),
}

# legacy HF BERT checkpoints name the LayerNorm parameters gamma / beta
_GAMMA_BETA = {"gamma": "weight", "beta": "bias"}


def convert_hf_state(state: Dict, dtype=torch.bfloat16, *, device="cuda"):
    """An HF BERT-family state dict (numpy arrays or tensors) -> (params,
    cfg), the config read from the weights' shapes. Names may carry the
    `bert.` prefix; the MLM head (`cls.*`) is ignored; a checkpoint without
    a pooler gets an identity pooler. The head count is not in the weights:
    every released BERT-family model has head_dim 64."""
    named: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        k = k[5:] if k.startswith("bert.") else k
        parts = k.split(".")
        if parts[-1] in _GAMMA_BETA:
            k = ".".join(parts[:-1] + [_GAMMA_BETA[parts[-1]]])
        named[k] = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).detach()

    word = named["embeddings.word_embeddings.weight"]
    pos = named["embeddings.position_embeddings.weight"]
    ttype = named["embeddings.token_type_embeddings.weight"]
    n_layers = 1 + max(int(_HF_LAYER_RE.match(k).group(1))
                       for k in named if _HF_LAYER_RE.match(k))
    dim = word.shape[1]
    cfg = BertConfig(vocab_size=word.shape[0], dim=dim, n_layers=n_layers,
                     n_heads=max(dim // 64, 1), max_position=pos.shape[0],
                     type_vocab_size=ttype.shape[0], dtype=dtype)

    def cast(a):
        return a.to(device=device, dtype=dtype).contiguous()

    stacked: Dict[str, Dict[str, torch.Tensor]] = {
        "attn": {}, "attn_norm": {}, "mlp": {}, "mlp_norm": {}}
    for tail, (group, key, transpose) in _HF_LAYER_MAP.items():
        rows = [named[f"encoder.layer.{i}.{tail}"] for i in range(n_layers)]
        stacked[group][key] = cast(torch.stack(
            [r.t() if transpose else r for r in rows]))

    pw, pb = named.get("pooler.dense.weight"), named.get("pooler.dense.bias")
    params = {
        "embed": {
            "word": cast(word), "position": cast(pos),
            "token_type": cast(ttype),
            "norm": {"w": cast(named["embeddings.LayerNorm.weight"]),
                     "b": cast(named["embeddings.LayerNorm.bias"])},
        },
        "layers": stacked,
        "pooler": {
            "w": cast(pw.t()) if pw is not None
            else torch.eye(dim, dtype=dtype, device=device),
            "b": cast(pb) if pb is not None
            else torch.zeros((dim,), dtype=dtype, device=device),
        },
    }
    return params, cfg


# safetensors' dtype names -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor}, read here (an 8-byte
    little-endian header length, a JSON header of dtype / shape /
    data_offsets, then the bytes), so the port needs no safetensors
    package."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        buf = bytearray(data[lo:hi])
        t = torch.frombuffer(buf, dtype=dtype) if buf else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, *, device="cuda"):
    """A local HF checkpoint directory (model.safetensors or
    pytorch_model.bin) -> (params, cfg) on `device`. Nothing remote."""
    st_path = os.path.join(path, "model.safetensors")
    pt_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        state = read_safetensors(st_path)
    elif os.path.exists(pt_path):
        state = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin under {path}")
    return convert_hf_state({k: v.float() for k, v in state.items()},
                            dtype=dtype, device=device)
