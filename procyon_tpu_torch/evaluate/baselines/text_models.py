"""Third-party retrieval baselines: BioTranslator, ProtST and the
PubMedBERT / SimCSE text encoders (counterpart of
procyon_tpu/evaluate/baselines/text_models.py).

The reference runs these as torch models
(procyon/evaluate/framework/biotranslator.py:27-80 one-hot CNN protein
tower and :171-217 HFTextEncoder text tower; framework/protst.py and
baseline_models/protst.py, an ESM tower and a PubMedBERT tower with 2-layer
MLP projections; procyon/model/pubmedbert.py and simcse.py, pooled text
encoders). Here every text tower is the port's BERT (models/bert.py: the
flash forward kernel on the card), the protein towers the port's ESM2
(models/esm2.py) and the DeepGOPlus CNN, whose 16 valid conv1d of widths
8..128 and global max are `torch.nn.functional.conv1d` (the reference's
JAX computes them with `lax.conv`, outside any Pallas kernel). The CNN
tree keeps JAX's `[k, in, out]` weights; the forward transposes them.
Released `.pth` checkpoints load through `load_torch_state` and the two
converters. Each model runs on its parameters' device; scores are numpy.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from procyon_tpu_torch.evaluate.retrieval import AbstractRetrievalModel
from procyon_tpu_torch.models import bert
from procyon_tpu_torch.models._init import Seed, make_generator

# DeepGOPlus amino-acid ordering (biotranslator.py:37-66): index 0 is the
# out-of-range / padding channel, 1..20 the amino acids
AALETTER = "ARNDCQEGHILKMFPSTWYV"
AAINDEX = {c: i + 1 for i, c in enumerate(AALETTER)}


def one_hot_protein(seq: str, max_len: int = 2000) -> np.ndarray:
    """[L, 21] one-hot, channels last (the reference emits [21, L] for
    torch's conv1d: the same content, biotranslator.py:27-66). Unknown
    residues and the padding set channel 0."""
    out = np.zeros((max_len, 21), np.float32)
    n = min(max_len, len(seq))
    for i in range(n):
        out[i, AAINDEX.get(seq[i], 0)] = 1.0
    out[n:, 0] = 1.0
    return out


# ---------------------------------------------------------------------------
# BioTranslator protein tower: parallel-kernel CNN (DeepGOPlus)

@dataclasses.dataclass(frozen=True)
class CNNConfig:
    in_channels: int = 21
    out_channels: int = 512       # seq_in_nc
    max_kernel: int = 129         # kernels 8, 16, ..., 128
    seq_length: int = 2000
    hidden_dim: int = 1000

    @property
    def kernels(self):
        return tuple(range(8, self.max_kernel, 8))


def init_cnn_params(seed: Seed, cfg: CNNConfig, *, device="cuda",
                    dtype=torch.float32):
    """Random CNN tower in the reference's tree: per kernel width k a
    weight [k, in, out] N(0, 1 / (in k)) and a zero bias, then the fc
    [16 out, hidden] N(0, 1 / fan_in). The numbers differ from
    jax.random's."""
    generator, device = make_generator(seed, device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) / fan_in ** 0.5
        return w.to(dtype)

    convs = [{"w": normal((k, cfg.in_channels, cfg.out_channels),
                          cfg.in_channels * k),
              "b": torch.zeros((cfg.out_channels,), dtype=dtype,
                               device=device)}
             for k in cfg.kernels]
    fc_in = len(cfg.kernels) * cfg.out_channels
    return {"convs": convs,
            "fc_w": normal((fc_in, cfg.hidden_dim), fc_in),
            "fc_b": torch.zeros((cfg.hidden_dim,), dtype=dtype,
                                device=device)}


@torch.no_grad()
def cnn_forward(params, cfg: CNNConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, L, 21] one-hot -> [B, hidden_dim] in the weights' dtype.

    Per kernel width k: a valid conv over the length, the global max (the
    MaxPool1d(L - k + 1) of biotranslator.py:120-136), then the features
    concatenated, Linear + LeakyReLU(0.01)."""
    xt = x.to(params["fc_w"].dtype).transpose(1, 2)        # [B, 21, L]
    feats = []
    for conv in params["convs"]:
        y = F.conv1d(xt, conv["w"].permute(2, 1, 0))        # [B, out, L-k+1]
        feats.append((y + conv["b"][:, None]).amax(2))
    h = torch.cat(feats, dim=-1)
    return F.leaky_relu(h @ params["fc_w"] + params["fc_b"],
                        negative_slope=0.01)


# ---------------------------------------------------------------------------
# projections

@dataclasses.dataclass
class MLPProj:
    """Projection head: weights `ws` [in, out], biases `bs` (None for a
    bias-free layer) and the activation between layers, `act`."""
    ws: List
    bs: List
    act: str = "relu"


def init_mlp_proj(seed: Seed, d_in: int, d_out: int, *, kind: str = "mlp",
                  n_layers: int = 2, activation: str = "relu",
                  device="cuda") -> MLPProj:
    """kind="mlp": open_clip's bias-free Linear-GELU-Linear with hidden
    (d_in + d_out) // 2 (biotranslator_tencoder.py:186-192); "tower_mlp":
    torchdrug's layers.MLP d_in -> d_in -> d_out with ReLU and biases
    (baseline_models/protst.py:36-40); "linear": one bias-free Linear.
    Weights N(0, 1 / d_in), f32."""
    generator, device = make_generator(seed, device)

    def normal(a, b):
        return torch.randn((a, b), generator=generator, device=device,
                           dtype=torch.float32) / a ** 0.5

    if kind == "linear":
        return MLPProj(ws=[normal(d_in, d_out)], bs=[None], act=activation)
    if kind == "mlp":
        dims, biases, act = [d_in, (d_in + d_out) // 2, d_out], False, "gelu"
    elif kind == "tower_mlp":
        dims, biases, act = [d_in] * n_layers + [d_out], True, activation
    else:
        raise ValueError(kind)
    ws = [normal(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    bs = [torch.zeros((dims[i + 1],), dtype=torch.float32, device=device)
          if biases else None for i in range(len(dims) - 1)]
    return MLPProj(ws=ws, bs=bs, act=act)


def apply_proj(proj: Optional[MLPProj], x: torch.Tensor) -> torch.Tensor:
    """x through the head; the activation between layers: "gelu" is the
    tanh form (jax.nn.gelu's default, as the reference computes it),
    anything else ReLU."""
    if proj is None:
        return x
    n = len(proj.ws)
    for i, (w, b) in enumerate(zip(proj.ws, proj.bs)):
        x = x @ w
        if b is not None:
            x = x + b
        if i < n - 1:
            x = F.gelu(x, approximate="tanh") if proj.act == "gelu" \
                else F.relu(x)
    return x


# ---------------------------------------------------------------------------
# text towers

class BertTextTower:
    """BERT encoder, pooler and optional projection, in batches. Covers
    HFTextEncoder (cls pooler + mlp head, BioTranslator), ProtST's
    PubMedBERT (mean over the non-special tokens + tower_mlp) and the
    SimCSE / PubMedBERT poolers."""

    def __init__(self, params, cfg: bert.BertConfig, tokenizer, *,
                 pooler: str = "cls", proj: Optional[MLPProj] = None,
                 max_len: int = 256, batch_size: int = 32,
                 exclude_special_from_mean: bool = False):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pooler = pooler
        self.proj = proj
        # texts truncate to the encoder's position table, as BERTScore's
        # do (the reference's tower raises past it: the tiny synthetic
        # encoder's 64 positions against its default of 256)
        self.max_len = min(max_len, cfg.max_position)
        self.batch_size = batch_size
        self.exclude_special = exclude_special_from_mean

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["word"].device

    @torch.no_grad()
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[N, d] f32 on the host."""
        outs = []
        dev = self.device
        for s in range(0, len(texts), self.batch_size):
            chunk = list(texts[s:s + self.batch_size])
            enc = self.tokenizer.batch_encode(chunk, max_len=self.max_len)
            pool_mask = enc.attention_mask.astype(np.float32)
            if self.exclude_special and self.pooler in ("mean", "avg"):
                # ProtST's mean readout skips CLS / SEP (protst.py:216-221)
                for sid in (self.tokenizer.cls_id, self.tokenizer.sep_id):
                    pool_mask[enc.ids == sid] = 0.0
            out = bert.forward(self.params, self.cfg,
                               torch.from_numpy(enc.ids).to(dev))
            pooled = bert.pool(out["hidden"],
                               torch.from_numpy(pool_mask).to(dev),
                               self.pooler, pooled=out["pooled"])
            outs.append(apply_proj(self.proj, pooled.float())
                        .cpu().numpy())
        return np.concatenate(outs, 0) if outs else np.zeros((0, 1))


def _normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


def _synthetic_text_tower(seed, device, *, pooler, proj_kind=None,
                          embed_dim=64, bert_cfg=None, tokenizer=None,
                          exclude_special_from_mean=False):
    """The tiny BERT (f32 on the CPU, bf16 elsewhere: the flash kernel's
    type) with the synthetic WordPiece vocabulary, seeded."""
    from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer

    device = torch.device(device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    bcfg = bert_cfg or bert.tiny_config(dtype=dtype)
    g, _ = make_generator(seed, device)
    proj = None if proj_kind is None else init_mlp_proj(
        g, bcfg.dim, embed_dim, kind=proj_kind, device=device)
    return BertTextTower(bert.init_params(g, bcfg, device=device), bcfg,
                         tokenizer or WordPieceTokenizer.synthetic(),
                         pooler=pooler, proj=proj,
                         exclude_special_from_mean=exclude_special_from_mean)


# ---------------------------------------------------------------------------
# eval-framework wrappers

class BioTranslatorRetrievalEval(AbstractRetrievalModel):
    """Text query -> the BERT text tower; protein target -> the one-hot CNN
    tower; cosine scores (biotranslator.py:324-382)."""

    name = "biotranslator"

    def __init__(self, text_tower: BertTextTower, cnn_params,
                 cnn_cfg: CNNConfig, store, *, batch_size: int = 16):
        self.text_tower = text_tower
        self.cnn_params = cnn_params
        self.cnn_cfg = cnn_cfg
        self.store = store
        self.batch_size = batch_size

    @classmethod
    def synthetic(cls, store, *, seed: int = 0, embed_dim: int = 64,
                  cnn_cfg: Optional[CNNConfig] = None, tokenizer=None,
                  bert_cfg: Optional[bert.BertConfig] = None,
                  device="cuda", **kw):
        """Seeded random towers (no released checkpoint is at hand): the
        whole compute path."""
        tower = _synthetic_text_tower(seed, device, pooler="cls",
                                      proj_kind="mlp", embed_dim=embed_dim,
                                      bert_cfg=bert_cfg, tokenizer=tokenizer)
        ccfg = cnn_cfg or CNNConfig(out_channels=32, max_kernel=33,
                                    seq_length=256, hidden_dim=embed_dim)
        cnn = init_cnn_params(seed + 1, ccfg, device=device)
        return cls(tower, cnn, ccfg, store, **kw)

    @torch.no_grad()
    def _target_embeddings(self, target_order) -> np.ndarray:
        outs = []
        dev = self.cnn_params["fc_w"].device
        for s in range(0, len(target_order), self.batch_size):
            chunk = target_order[s:s + self.batch_size]
            x = np.stack([one_hot_protein(self.store.protein_sequence(a),
                                          self.cnn_cfg.seq_length)
                          for a in chunk])
            outs.append(cnn_forward(self.cnn_params, self.cnn_cfg,
                                    torch.from_numpy(x).to(dev))
                        .float().cpu().numpy())
        return np.concatenate(outs, 0)

    def get_predictions(self, query_order, target_order, dataset=None):
        q = _normalize(self.text_tower.embed_texts(
            [self.store.text(t) for t in query_order]))
        t = _normalize(self._target_embeddings(target_order))
        return q @ t.T


class ProtSTRetrievalEval(AbstractRetrievalModel):
    """ProtST (framework/protst.py): the ESM protein tower (mean over the
    residues + a 2-layer MLP to 512) against the PubMedBERT text tower
    (mean over the non-special tokens + a 2-layer MLP to 512); cosine
    scores."""

    name = "protst"

    def __init__(self, text_tower: BertTextTower, esm_params, esm_cfg,
                 graph_proj: Optional[MLPProj], store, *,
                 batch_size: int = 8, max_protein_len: int = 512):
        self.text_tower = text_tower
        self.esm_params = esm_params
        self.esm_cfg = esm_cfg
        self.graph_proj = graph_proj
        self.store = store
        self.batch_size = batch_size
        self.max_protein_len = max_protein_len

    @classmethod
    def synthetic(cls, store, *, seed: int = 0, embed_dim: int = 64,
                  device="cuda", **kw):
        from procyon_tpu_torch.models import esm2

        device = torch.device(device)
        tower = _synthetic_text_tower(seed, device, pooler="mean",
                                      proj_kind="tower_mlp",
                                      embed_dim=embed_dim,
                                      exclude_special_from_mean=True)
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        ecfg = esm2.tiny_config(dtype=dtype)
        g, _ = make_generator(seed + 1, device)
        eparams = esm2.init_params(g, ecfg, device=device)
        gproj = init_mlp_proj(g, ecfg.dim, embed_dim, kind="tower_mlp",
                              device=device)
        return cls(tower, eparams, ecfg, gproj, store, **kw)

    @torch.no_grad()
    def _target_embeddings(self, target_order) -> np.ndarray:
        from procyon_tpu_torch.data import protein_tokenizer as pt
        from procyon_tpu_torch.models import esm2

        outs = []
        dev = self.esm_params["embed"].device
        for s in range(0, len(target_order), self.batch_size):
            chunk = target_order[s:s + self.batch_size]
            pb = pt.batch_encode(
                [self.store.protein_sequence(a) for a in chunk],
                max_len=self.max_protein_len)
            tokens = torch.from_numpy(pb.tokens).to(dev)
            out = esm2.forward(self.esm_params, self.esm_cfg, tokens)
            # the mean over the residues alone (protst.py:73-79: CLS / EOS
            # stripped)
            valid = ((tokens != esm2.PAD_IDX) & (tokens != esm2.CLS_IDX)
                     & (tokens != esm2.EOS_IDX)).float()[..., None]
            pooled = (out["hidden"].float() * valid).sum(1) \
                / valid.sum(1).clamp_min(1e-6)
            outs.append(apply_proj(self.graph_proj, pooled).cpu().numpy())
        return np.concatenate(outs, 0)

    def get_predictions(self, query_order, target_order, dataset=None):
        q = _normalize(self.text_tower.embed_texts(
            [self.store.text(t) for t in query_order]))
        t = _normalize(self._target_embeddings(target_order))
        return q @ t.T


class TextEncoderRetrievalEval(AbstractRetrievalModel):
    """The PubMedBERT / SimCSE text-encoder baseline: both sides through
    the same pooled BERT, queries by their phenotype descriptions, targets
    by the proteins' functional descriptions (`target_text_fn`), as the
    reference uses SimCSE / PubMedBERT as pure text encoders
    (procyon/model/pubmedbert.py:20-84, simcse.py)."""

    name = "text_encoder"

    def __init__(self, tower: BertTextTower, store,
                 target_text_fn: Callable[[int], str]):
        self.tower = tower
        self.store = store
        self.target_text_fn = target_text_fn

    @classmethod
    def synthetic(cls, store, target_text_fn, *, seed: int = 0,
                  pooler: str = "cls", device="cuda"):
        return cls(_synthetic_text_tower(seed, device, pooler=pooler), store,
                   target_text_fn)

    def get_predictions(self, query_order, target_order, dataset=None):
        q = _normalize(self.tower.embed_texts(
            [self.store.text(t) for t in query_order]))
        t = _normalize(self.tower.embed_texts(
            [self.target_text_fn(a) for a in target_order]))
        return q @ t.T


# ---------------------------------------------------------------------------
# released-checkpoint ingestion (a torch .pth -> the port's trees)

def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """A released `.pth` -> {name: f32 CPU tensor}: a state nested under
    "model" is unwrapped, entries that are not tensors dropped, Parameters
    detached."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    return {k: v.detach().float() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def convert_biotranslator_text(state: Dict, dtype=torch.bfloat16, *,
                               device="cuda"):
    """The released BioTranslator text_encoder `.pth` (TextEncoder:
    `text.transformer.*` BERT weights and the `text.proj.*` mlp head,
    biotranslator.py:171-217) -> (bert params, bert cfg, MLPProj)."""
    bert_state = {k[len("text.transformer."):]: v for k, v in state.items()
                  if k.startswith("text.transformer.")}
    params, cfg = bert.convert_hf_state(bert_state, dtype=dtype,
                                        device=device)
    proj_ws = {int(k.split(".")[2]): torch.as_tensor(v).float().t()
               for k, v in state.items()
               if k.startswith("text.proj.") and k.endswith(".weight")}
    proj = MLPProj(ws=[proj_ws[i].contiguous().to(device)
                       for i in sorted(proj_ws)],
                   bs=[None] * len(proj_ws), act="gelu") \
        if proj_ws else None
    return params, cfg, proj


def convert_biotranslator_cnn(state: Dict, cfg: CNNConfig, *,
                              device="cuda", dtype=torch.float32):
    """The released BioTranslator data_encoder `.pth` (conv1d_{i}.weight
    [out, in, k], torch's layout) -> the CNN tree ([k, in, out] convs and
    the fc)."""
    def t(name):
        return torch.as_tensor(state[name]).to(device=device, dtype=dtype)

    convs = [{"w": t(f"conv1d_{i}.weight").permute(2, 1, 0).contiguous(),
              "b": t(f"conv1d_{i}.bias")}
             for i, _ in enumerate(cfg.kernels)]
    return {"convs": convs, "fc_w": t("fc_seq.0.weight").t().contiguous(),
            "fc_b": t("fc_seq.0.bias")}
