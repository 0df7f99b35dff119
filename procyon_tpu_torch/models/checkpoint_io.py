"""Model files and reference-checkpoint conversion (counterpart of
procyon_tpu/models/checkpoint_io.py), torch and numpy only.

A saved model directory in the port's layout:
  configs.json    the UnifiedConfig tree (`config_to_dict`; dtypes by name,
                  "bfloat16", as the reference writes them)
  state.pt        `torch.save` of the parameter tree in the bridge's layout
                  (bridge.py: `[in, out]` weights, int8 leaves {"q", "s"}),
                  read back with `weights_only=True`; a training
                  checkpoint's state ({"params"[, "frozen"], "opt_state",
                  "step"}, training/checkpointing.py) loads as its model
  tokenizer.json  optional tokenizer spec ({"path", "vocab_size"})

The reference keeps its parameters as an orbax `state/` directory; reading
that format is not ported (it needs orbax). The converters from HF,
fair-esm and released ProCyon (DeepSpeed ZeRO-2) state dicts are: they read
torch pickles and numpy arrays and give the port's tree on the CPU.
"""

import dataclasses
import glob
import json
import os
import pickle
import re
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import contrastive, esm2, llama, lora, unified

STATE_FILE = "state.pt"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype_name(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


def config_to_dict(cfg) -> Dict:
    """A config dataclass tree as JSON-able dicts, dtypes by name."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: (_dtype_name(getattr(cfg, f.name))
                         if f.name == "dtype"
                         else config_to_dict(getattr(cfg, f.name)))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(x) for x in cfg]
    return cfg


def _fix_dtype(sub: Dict) -> Dict:
    sub = dict(sub)
    if isinstance(sub.get("dtype"), str):
        sub["dtype"] = _DTYPES[sub["dtype"].replace("torch.", "")]
    return sub


def _with_lora(sub: Dict) -> Dict:
    sub = _fix_dtype(sub)
    if isinstance(sub.get("lora"), dict):
        sub["lora"] = lora.LoRAConfig(**_fix_dtype(sub["lora"]))
    return sub


def unified_config_from_dict(d: Dict) -> unified.UnifiedConfig:
    lcfg = llama.LlamaConfig(**_with_lora(d["llama"])) if d.get("llama") \
        else None
    ecfg = esm2.ESM2Config(**_with_lora(d["esm"])) if d.get("esm") else None
    ccfg = contrastive.InfoNCEConfig(**_fix_dtype(d["contrastive"]))
    rest = {k: v for k, v in d.items()
            if k not in ("llama", "esm", "contrastive", "dtype")}
    return unified.UnifiedConfig(
        llama=lcfg, esm=ecfg, contrastive=ccfg,
        dtype=_DTYPES.get(str(d.get("dtype")).replace("torch.", ""),
                          torch.bfloat16), **rest)


def write_configs(path: str, cfg: unified.UnifiedConfig, *,
                  tokenizer_info: Optional[Dict] = None):
    """configs.json (and tokenizer.json) of a model directory."""
    with open(os.path.join(path, "configs.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
    if tokenizer_info:
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(tokenizer_info, f, indent=2)


def write_state(path: str, tree):
    """state.pt of a model or checkpoint directory: `torch.save` of a tree
    of CPU tensors, written to a temporary name and renamed."""
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def save_model(path: str, params, cfg: unified.UnifiedConfig, *,
               tokenizer_info: Optional[Dict] = None):
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    write_state(path, bridge.to_torch(params, device="cpu"))
    write_configs(path, cfg, tokenizer_info=tokenizer_info)


def _model_params(state):
    """The parameter tree of a saved state: the tree itself, or a training
    state's trainable "params" merged with its "frozen" tree."""
    if "params" not in state or "opt_state" not in state:
        return state
    return bridge.merge_params(state["params"], state.get("frozen"))


def load_model(path: str, *, device="cuda") -> Tuple[Dict,
                                                    unified.UnifiedConfig,
                                                    Any]:
    """(params on `device`, config, tokenizer or None) of a model directory
    or of a training checkpoint that has its configs.json."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "configs.json")) as f:
        cfg = unified_config_from_dict(json.load(f))
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    params = bridge.to_torch(_model_params(state), device=torch.device(device))
    tokenizer = None
    tok_path = os.path.join(path, "tokenizer.json")
    if os.path.exists(tok_path):
        with open(tok_path) as f:
            info = json.load(f)
        from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
        tokenizer = load_tokenizer(info.get("path"),
                                   info.get("vocab_size", 4096))
    return params, cfg, tokenizer


# ---------------------------------------------------------------------------
# HF / fair-esm state-dict conversion (numpy in, the port's tree out)
# ---------------------------------------------------------------------------


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(dtype)


def convert_hf_llama(state_dict: Dict[str, np.ndarray],
                     cfg: llama.LlamaConfig) -> Dict:
    """HF LlamaForCausalLM state dict (numpy arrays) -> the stacked tree.
    Torch Linear stores [out, in]; the tree keeps [in, out]."""
    L = cfg.n_layers

    def get(name):
        return np.asarray(state_dict[name])

    def stack(fmt, transpose=True):
        mats = [get(fmt.format(i)) for i in range(L)]
        if transpose:
            mats = [m.T for m in mats]
        return _tensor(np.stack(mats), cfg.dtype)

    p = "model.layers.{}."
    layers = {
        "attn": {
            "wq": stack(p + "self_attn.q_proj.weight"),
            "wk": stack(p + "self_attn.k_proj.weight"),
            "wv": stack(p + "self_attn.v_proj.weight"),
            "wo": stack(p + "self_attn.o_proj.weight"),
        },
        "mlp": {
            "w_gate": stack(p + "mlp.gate_proj.weight"),
            "w_up": stack(p + "mlp.up_proj.weight"),
            "w_down": stack(p + "mlp.down_proj.weight"),
        },
        "attn_norm": stack(p + "input_layernorm.weight", transpose=False),
        "mlp_norm": stack(p + "post_attention_layernorm.weight",
                          transpose=False),
    }
    return {
        "embed": _tensor(get("model.embed_tokens.weight"), cfg.dtype),
        "layers": layers,
        "final_norm": _tensor(get("model.norm.weight"), cfg.dtype),
        "lm_head": _tensor(get("lm_head.weight").T, cfg.dtype),
    }


def _esm_tree(state_dict, cfg, names) -> Dict:
    """The ESM2 tree from a state dict whose per-layer names `names` gives
    ({ours: their format string}) and the shared top-level names."""
    L = cfg.n_layers

    def get(name):
        return np.asarray(state_dict[name])

    def stack_w(fmt):
        return _tensor(np.stack([get(fmt.format(i)).T for i in range(L)]),
                       cfg.dtype)

    def stack_b(fmt):
        return _tensor(np.stack([get(fmt.format(i)) for i in range(L)]),
                       cfg.dtype)

    n = names
    layers = {
        "attn": {k: (stack_w if k.startswith("w") else stack_b)(n[k])
                 for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")},
        "mlp": {k: (stack_w if k.startswith("w") else stack_b)(n[k])
                for k in ("w1", "b1", "w2", "b2")},
        "attn_norm": {"w": stack_b(n["attn_norm.w"]),
                      "b": stack_b(n["attn_norm.b"])},
        "mlp_norm": {"w": stack_b(n["mlp_norm.w"]),
                     "b": stack_b(n["mlp_norm.b"])},
    }
    return {
        "embed": _tensor(get(n["embed"]), cfg.dtype),
        "layers": layers,
        "final_norm": {"w": _tensor(get(n["final_norm.w"]), cfg.dtype),
                       "b": _tensor(get(n["final_norm.b"]), cfg.dtype)},
        "lm_head": {
            "dense_w": _tensor(get("lm_head.dense.weight").T, cfg.dtype),
            "dense_b": _tensor(get("lm_head.dense.bias"), cfg.dtype),
            "norm": {"w": _tensor(get("lm_head.layer_norm.weight"),
                                  cfg.dtype),
                     "b": _tensor(get("lm_head.layer_norm.bias"),
                                  cfg.dtype)},
            "bias": _tensor(get("lm_head.bias"), torch.float32),
        },
    }


def convert_hf_esm2(state_dict: Dict[str, np.ndarray],
                    cfg: esm2.ESM2Config) -> Dict:
    """HF EsmForMaskedLM state dict -> the stacked ESM2 tree."""
    p = "esm.encoder.layer.{}."
    a = p + "attention.self."
    return _esm_tree(state_dict, cfg, {
        "wq": a + "query.weight", "bq": a + "query.bias",
        "wk": a + "key.weight", "bk": a + "key.bias",
        "wv": a + "value.weight", "bv": a + "value.bias",
        "wo": p + "attention.output.dense.weight",
        "bo": p + "attention.output.dense.bias",
        "w1": p + "intermediate.dense.weight",
        "b1": p + "intermediate.dense.bias",
        "w2": p + "output.dense.weight", "b2": p + "output.dense.bias",
        "attn_norm.w": p + "attention.LayerNorm.weight",
        "attn_norm.b": p + "attention.LayerNorm.bias",
        "mlp_norm.w": p + "LayerNorm.weight",
        "mlp_norm.b": p + "LayerNorm.bias",
        "embed": "esm.embeddings.word_embeddings.weight",
        "final_norm.w": "esm.encoder.emb_layer_norm_after.weight",
        "final_norm.b": "esm.encoder.emb_layer_norm_after.bias"})


def convert_fairesm_esm2(state_dict: Dict[str, np.ndarray],
                         cfg: esm2.ESM2Config) -> Dict:
    """fair-esm ESM2 state dict (the reference's live protein encoder,
    layers.{i}.self_attn.{q,k,v,out}_proj, fc1 / fc2, ...) -> the stacked
    ESM2 tree; the same numerics as the HF naming."""
    p = "layers.{}."
    a = p + "self_attn."
    return _esm_tree(state_dict, cfg, {
        "wq": a + "q_proj.weight", "bq": a + "q_proj.bias",
        "wk": a + "k_proj.weight", "bk": a + "k_proj.bias",
        "wv": a + "v_proj.weight", "bv": a + "v_proj.bias",
        "wo": a + "out_proj.weight", "bo": a + "out_proj.bias",
        "w1": p + "fc1.weight", "b1": p + "fc1.bias",
        "w2": p + "fc2.weight", "b2": p + "fc2.bias",
        "attn_norm.w": p + "self_attn_layer_norm.weight",
        "attn_norm.b": p + "self_attn_layer_norm.bias",
        "mlp_norm.w": p + "final_layer_norm.weight",
        "mlp_norm.b": p + "final_layer_norm.bias",
        "embed": "embed_tokens.weight",
        "final_norm.w": "emb_layer_norm_after.weight",
        "final_norm.b": "emb_layer_norm_after.bias"})


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch .pt / .bin (or safetensors) file as numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _to_numpy(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Released-checkpoint ingestion
# ---------------------------------------------------------------------------
#
# Released ProCyon checkpoints are DeepSpeed ZeRO-2 directories and torch
# pickles: `checkpoint-N/` holds `model_args.pt`, `data_args.pt` (pickled
# dataclasses of the reference's code) and either a consolidated
# `txllm_model_ckpt.pt` or `global_stepN/` with `mp_rank_00_model_states.pt`
# and `zero_pp_rank_{r}_mp_rank_00_optim_states.pt` shards.


class _StubObject:
    """Stands in for a pickled class that cannot be imported; keeps the
    pickled attributes readable."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)

    def __repr__(self):
        return f"_StubObject({self.__dict__!r})"


def _permissive_torch_load(path: str):
    """torch.load that replaces classes it cannot import with _StubObject
    subclasses (model_args.pt pickles the reference's ModelArgs)."""
    stub_cache: Dict[Tuple[str, str], type] = {}

    class _PermissiveUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                key = (module, name)
                if key not in stub_cache:
                    stub_cache[key] = type(name, (_StubObject,),
                                           {"__module__": module})
                return stub_cache[key]

    shim = types.ModuleType("_procyon_permissive_pickle")
    shim.Unpickler = _PermissiveUnpickler
    shim.load = lambda f, **kw: _PermissiveUnpickler(f, **kw).load()
    shim.loads = lambda b, **kw: pickle.loads(b)
    return torch.load(path, map_location="cpu", pickle_module=shim,
                      weights_only=False)


def load_checkpoint_args(ckpt_dir: str):
    """(model_args, data_args) of a reference checkpoint as attribute
    namespaces; a missing file gives None."""
    out = []
    for fname in ("model_args.pt", "data_args.pt"):
        path = os.path.join(ckpt_dir, fname)
        out.append(_permissive_torch_load(path)
                   if os.path.exists(path) else None)
    return tuple(out)


def consolidate_zero_checkpoint(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """A DeepSpeed ZeRO-2 checkpoint as one f32 state dict (zero_to_fp32's
    semantics for stage <= 2): module weights from
    `mp_rank_00_model_states.pt['module']`, the trainable ones replaced by
    the f32 master partitions of the optimizer shards, concatenated over
    ranks and cut by `param_shapes`."""
    step_dir = None
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            step_dir = os.path.join(ckpt_dir, f.read().strip())
    else:
        cands = sorted(glob.glob(os.path.join(ckpt_dir, "global_step*")))
        if cands:
            step_dir = cands[-1]
    if step_dir is None or not os.path.isdir(step_dir):
        raise FileNotFoundError(
            f"no DeepSpeed step dir (latest file or global_step*) under "
            f"{ckpt_dir}")

    model_files = sorted(glob.glob(os.path.join(step_dir,
                                                "*_model_states.pt")))
    if not model_files:
        raise FileNotFoundError(f"no *_model_states.pt in {step_dir}")
    ms = _permissive_torch_load(model_files[0])
    sd = {k: _to_numpy(v) for k, v in ms["module"].items()}

    param_shapes = ms.get("param_shapes")
    optim_files = glob.glob(os.path.join(step_dir, "*_optim_states.pt"))

    def rank_of(path):
        m = re.search(r"zero_pp_rank_(\d+)", os.path.basename(path))
        return int(m.group(1)) if m else 0

    optim_files.sort(key=rank_of)
    if param_shapes is not None and optim_files:
        if isinstance(param_shapes, dict):
            param_shapes = [param_shapes]
        parts = []
        for f in optim_files:
            osd = _permissive_torch_load(f)["optimizer_state_dict"]
            stage = osd.get("zero_stage", 2)
            if stage not in (0, 1, 2):
                raise NotImplementedError(
                    f"ZeRO stage {stage} consolidation not supported "
                    f"(released configs use stage 2)")
            groups = osd["single_partition_of_fp32_groups"]
            parts.append([_to_numpy(g).ravel() for g in groups])
        for g in range(len(param_shapes)):
            flat = np.concatenate([p[g] for p in parts])
            offset = 0
            for name, shape in param_shapes[g].items():
                shape = tuple(int(s) for s in shape)
                numel = int(np.prod(shape)) if shape else 1
                if offset + numel > flat.size:
                    raise RuntimeError(
                        f"ZeRO group {g} exhausted at param {name}: need "
                        f"{offset + numel} elements, have {flat.size}")
                sd[name] = flat[offset:offset + numel].reshape(shape)
                offset += numel
    return sd


def load_reference_state_dict(
        ckpt_dir: str,
        state_dict_relative_path: str = "txllm_model_ckpt.pt",
) -> Dict[str, np.ndarray]:
    """The f32 state dict of a reference checkpoint directory: the
    consolidated file when there is one (possibly wrapped as
    {'model_state_dict': sd}), else the ZeRO shards."""
    consolidated = os.path.join(ckpt_dir, state_dict_relative_path)
    if os.path.exists(consolidated):
        obj = _permissive_torch_load(consolidated)
        if isinstance(obj, dict) and "model_state_dict" in obj:
            obj = obj["model_state_dict"]
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        return {k: _to_numpy(v) for k, v in obj.items()}
    return consolidate_zero_checkpoint(ckpt_dir)


# model_args.text_encoder_fname -> the head counts weight shapes cannot give
_LLAMA_FAMILIES = {
    "llama-3": dict(n_heads=32, n_kv_heads=8, rope_theta=500000.0,
                    max_seq_len=8192),
    "llama-2": dict(n_heads=32, n_kv_heads=32, rope_theta=10000.0,
                    max_seq_len=4096),
    "llama": dict(n_heads=32, n_kv_heads=32, rope_theta=10000.0,
                  max_seq_len=2048),
}


def unified_config_from_checkpoint(
        margs, weights: Dict[str, np.ndarray], *,
        llama_config: Optional[llama.LlamaConfig] = None,
        esm_config: Optional[esm2.ESM2Config] = None,
        dtype=torch.bfloat16) -> unified.UnifiedConfig:
    """model_args fields and weight shapes -> UnifiedConfig; an explicit
    llama_config / esm_config overrides the name-based inference."""
    def marg(name, default):
        return getattr(margs, name, default) if margs is not None else default

    if llama_config is None:
        name = str(marg("text_encoder_fname", "llama-3-8b")).lower()
        fam = next((dict(_LLAMA_FAMILIES[k]) for k in
                    ("llama-3", "llama-2", "llama") if k in name), None)
        if fam is None:
            raise ValueError(
                f"cannot infer llama config from text_encoder_fname="
                f"{name!r}; pass llama_config explicitly")
        embed = weights["text_encoder.model.model.embed_tokens.weight"]
        layer_ids = {int(m.group(1)) for k in weights
                     if (m := re.match(
                         r"text_encoder\.model\.model\.layers\.(\d+)\.", k))}
        gate = weights["text_encoder.model.model.layers.0.mlp."
                       "gate_proj.weight"]
        kproj = weights["text_encoder.model.model.layers.0.self_attn."
                        "k_proj.weight"]
        dim = embed.shape[1]
        head_dim = dim // fam["n_heads"]
        llama_config = llama.LlamaConfig(
            vocab_size=embed.shape[0], dim=dim,
            n_layers=max(layer_ids) + 1, n_heads=fam["n_heads"],
            n_kv_heads=kproj.shape[0] // head_dim,
            intermediate=gate.shape[0], rope_theta=fam["rope_theta"],
            max_seq_len=fam["max_seq_len"], dtype=dtype)

    live_esm = any(k.startswith("protein_seq_encoder.model.")
                   for k in weights)
    if live_esm and esm_config is None:
        esm_prefix = "protein_seq_encoder.model."
        if esm_prefix + "embed_tokens.weight" in weights:
            edim = weights[esm_prefix + "embed_tokens.weight"].shape[1]
        else:
            edim = weights[
                esm_prefix + "esm.embeddings.word_embeddings.weight"].shape[1]
        by_dim = {v["dim"]: name for name, v in esm2._SIZES.items()}
        if edim not in by_dim:
            raise ValueError(
                f"unknown ESM2 width {edim}; pass esm_config explicitly")
        esm_config = esm2.esm2_config(by_dim[edim], dtype=dtype)

    def proj_dims(prefix):
        first = weights.get(prefix + "0.weight")
        if first is None:
            return None
        idxs = sorted({int(k[len(prefix):].split(".")[0])
                       for k in weights if k.startswith(prefix)
                       and k[len(prefix):].split(".")[0].isdigit()})
        last = weights[f"{prefix}{idxs[-1]}.weight"]
        hidden = first.shape[0] if len(idxs) > 1 else 0
        return dict(n_layers=len(idxs), in_dim=first.shape[1],
                    out_dim=last.shape[0], hidden=hidden)

    tok = proj_dims("token_projectors.aaseq.")
    shared = proj_dims("aaseq_shared_projector.")
    lm = proj_dims("aaseq_lm_projector.")
    struct = proj_dims("token_projectors.prot_structure.")
    drug = proj_dims("token_projectors.drug.")
    if tok is None or shared is None or lm is None:
        missing = [n for n, v in [("token_projectors.aaseq", tok),
                                  ("aaseq_shared_projector", shared),
                                  ("aaseq_lm_projector", lm)] if v is None]
        raise KeyError(
            f"checkpoint is missing projector weights: {missing}; refusing "
            f"to build a config (conversion would give random projectors)")

    return unified.UnifiedConfig(
        llama=llama_config,
        esm=esm_config if live_esm else None,
        protein_embed_dim=tok["in_dim"],
        token_projector_layers=tok["n_layers"],
        token_projector_hidden=tok["hidden"],
        retrieval_dim=shared["out_dim"],
        retrieval_projector_layers=shared["n_layers"],
        shared_projector_layers=shared["n_layers"],
        shared_projector_hidden=shared["hidden"],
        lm_projector_layers=lm["n_layers"],
        lm_projector_hidden=lm["hidden"],
        use_protein_struct=struct is not None,
        struct_embed_dim=struct["in_dim"] if struct else 512,
        use_drug_embeddings=drug is not None,
        drug_embed_dim=drug["in_dim"] if drug else 512,
        protein_pooling=str(marg("protein_pooling_opt", "mean")),
        dtype=dtype)


def _convert_projector(sub: Dict[str, np.ndarray], dtype, *, name: str):
    """A create_mlp Sequential state dict -> the projector's layer list.
    Intermediate layers come as [Linear, Dropout, GELU] triples (indices
    stride by 3), the last Linear bare; a 1-layer projector is one Linear
    without a bias."""
    idxs = sorted({int(k.split(".")[0]) for k in sub
                   if k.split(".")[0].isdigit()})
    if not idxs:
        raise KeyError(f"projector {name!r}: no Sequential weights found")
    layers = []
    for i in idxs:
        w = sub.get(f"{i}.weight")
        if w is None:
            raise KeyError(f"projector {name!r}: missing {i}.weight")
        layer = {"w": _tensor(np.asarray(w).T, dtype)}
        if f"{i}.bias" in sub:
            layer["b"] = _tensor(sub[f"{i}.bias"], dtype)
        layers.append(layer)
    if len(layers) > 1 and any("b" not in l for l in layers):
        raise ValueError(f"projector {name!r}: multi-layer projector with "
                         f"missing biases: unexpected reference layout")
    return layers


# frozen modality tables exported beside the converted model
_FROZEN_TABLES = {
    "protein_seq_embeddings.weight": "protein_seq_embeddings.npy",
    "domain_embeddings.weight": "domain_embeddings.npy",
    "peptide_embeddings.weight": "peptide_embeddings.npy",
    "protein_struct_embeddings.weight": "protein_struct_embeddings.npy",
    "drug_structure_embeddings.weight": "drug_structure_embeddings.npy",
}

# keys with no place in the tree that are safe to drop (rotary caches,
# the unused contact head, position ids)
_IGNORABLE_SUFFIXES = (
    "rotary_emb.inv_freq", "rot_emb.inv_freq", "masked_spec_embed",
    "contact_head.regression.weight", "contact_head.regression.bias",
    "embeddings.position_ids", "position_embeddings.weight",
)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def convert_reference_checkpoint(
        ckpt_dir: str, out_dir: str,
        cfg: Optional[unified.UnifiedConfig] = None, *,
        llama_config: Optional[llama.LlamaConfig] = None,
        esm_config=None, tokenizer_info=None, dtype=torch.bfloat16,
        state_dict_relative_path: str = "txllm_model_ckpt.pt"):
    """A released ProCyon checkpoint directory -> a model directory in the
    port's layout. Consolidates ZeRO-2 shards when needed, builds the config
    from model_args.pt when cfg is None, and maps every trained group:
      text_encoder.model.*          -> the decoder (the embedding sized from
                                       the checkpoint: the reference resizes
                                       to len(tokenizer) - 1, [EXT] has no
                                       row)
      protein_seq_encoder.model.*   -> the ESM2 tree (fair-esm or HF names)
      token_projectors.{aaseq,prot_structure,drug}.*, aaseq_shared_projector.*,
      aaseq_lm_projector.*          -> the projectors
      contrastive_head.temperature  -> contrastive.log_temp
    Frozen modality tables go to {out_dir}/embeddings/*.npy. Raises on a
    missing group or an unmapped key; returns (out_dir, report)."""
    weights = load_reference_state_dict(
        ckpt_dir, state_dict_relative_path=state_dict_relative_path)
    margs, _dargs = load_checkpoint_args(ckpt_dir)
    if cfg is None:
        cfg = unified_config_from_checkpoint(
            margs, weights, llama_config=llama_config,
            esm_config=esm_config, dtype=dtype)

    consumed = set()

    def subdict(prefix):
        sub = {}
        for k, v in weights.items():
            if k.startswith(prefix):
                sub[k[len(prefix):]] = v
                consumed.add(k)
        return sub

    report = {"converted": [], "skipped": [], "exported_tables": []}
    params = unified.init_params(0, cfg, device="cpu")
    want_shapes = _shapes(params)

    llama_sd = subdict("text_encoder.model.")
    if not llama_sd:
        raise KeyError(
            "checkpoint has no text_encoder.model.* keys: not a ProCyon "
            "checkpoint (or the state dict failed to load)")
    embed_rows = llama_sd["model.embed_tokens.weight"].shape[0]
    if embed_rows != cfg.llama.vocab_size:
        raise ValueError(
            f"decoder vocab mismatch: checkpoint embed has {embed_rows} "
            f"rows, config says {cfg.llama.vocab_size}. The reference "
            f"resizes to len(tokenizer)-1; size the config from the "
            f"checkpoint, not the tokenizer.")
    params["llama"] = convert_hf_llama(llama_sd, cfg.llama)
    report["converted"].append("llama")

    esm_sd = subdict("protein_seq_encoder.model.")
    if esm_sd:
        if cfg.esm is None:
            raise ValueError(
                "checkpoint has live ESM weights but config is in "
                "frozen-embedding mode (use_aaseq_embeddings)")
        if any(k.startswith("esm.") for k in esm_sd):
            params["esm"] = convert_hf_esm2(esm_sd, cfg.esm)
        else:
            params["esm"] = convert_fairesm_esm2(esm_sd, cfg.esm)
        report["converted"].append("esm")
    elif cfg.esm is not None:
        raise KeyError(
            "config expects a live ESM encoder but the checkpoint has no "
            "protein_seq_encoder.model.* keys")

    proj_map = {
        "token_projector": "token_projectors.aaseq.",
        "shared_projector": "aaseq_shared_projector.",
        "lm_projector": "aaseq_lm_projector.",
    }
    if cfg.use_protein_struct:
        proj_map["struct_projector"] = "token_projectors.prot_structure."
    if cfg.use_drug_embeddings:
        proj_map["drug_projector"] = "token_projectors.drug."
    for ours, prefix in proj_map.items():
        sub = subdict(prefix)
        if not sub:
            raise KeyError(
                f"checkpoint is missing {prefix}* weights for the "
                f"{ours!r} projector: the converted model would have random "
                f"projectors; refusing.")
        params["projectors"][ours] = _convert_projector(sub, cfg.dtype,
                                                        name=ours)
        report["converted"].append(ours)

    t_key = "contrastive_head.temperature"
    if t_key not in weights:
        raise KeyError(
            f"checkpoint is missing {t_key}: retrieval scores would use a "
            f"random temperature; refusing.")
    t = float(np.asarray(weights[t_key]).reshape(-1)[0])
    consumed.add(t_key)
    ccfg = cfg.contrastive
    params["contrastive"]["log_temp"] = torch.tensor(
        float(np.log(np.clip(t, ccfg.min_temperature, ccfg.max_temperature))),
        dtype=torch.float32)
    report["converted"].append("contrastive")

    # optional projection heads (off in the released configs): flagged
    for k in weights:
        if k.startswith("contrastive_head.") and k not in consumed:
            report["skipped"].append(k)
            consumed.add(k)

    emb_dir = os.path.join(out_dir, "embeddings")
    for key, fname in _FROZEN_TABLES.items():
        if key in weights:
            os.makedirs(emb_dir, exist_ok=True)
            np.save(os.path.join(emb_dir, fname),
                    np.asarray(weights[key], np.float32))
            consumed.add(key)
            report["exported_tables"].append(fname)

    leftover = [k for k in weights if k not in consumed
                and not k.endswith(_IGNORABLE_SUFFIXES)]
    if leftover:
        raise KeyError(
            f"{len(leftover)} checkpoint keys were not mapped (first 20): "
            f"{sorted(leftover)[:20]}; extend the converter instead of "
            f"dropping weights silently.")

    if _shapes(params) != want_shapes:
        raise ValueError(
            "converted parameter tree does not match the config's init "
            "structure: shapes / dtypes diverged; check the config "
            "extraction.")

    save_model(out_dir, params, cfg, tokenizer_info=tokenizer_info)
    with open(os.path.join(out_dir, "conversion_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return out_dir, report


def resize_token_embeddings(llama_params, new_vocab_size: int, *,
                            init_scale: float = 0.02, seed: int = 0):
    """Grow (or cut) the decoder's vocabulary rows. The reference adds its
    special tokens after loading HF weights and resizes with an off-by-one
    ([EXT], added last, gets no embedding row); when converting released
    checkpoints, size embed / lm_head to the checkpoint. New rows are
    N(0, init_scale^2) from a torch generator seeded with `seed` (not
    jax.random's numbers)."""
    embed = llama_params["embed"]
    old, dim = embed.shape
    if new_vocab_size == old:
        return llama_params
    out = dict(llama_params)
    if new_vocab_size < old:
        out["embed"] = embed[:new_vocab_size]
        out["lm_head"] = llama_params["lm_head"][:, :new_vocab_size]
        return out
    g = torch.Generator(device=embed.device).manual_seed(seed)
    extra = (torch.randn((new_vocab_size - old, dim), generator=g,
                         device=embed.device) * init_scale).to(embed.dtype)
    out["embed"] = torch.cat([embed, extra], 0)
    extra_h = (torch.randn((dim, new_vocab_size - old), generator=g,
                           device=embed.device) * init_scale).to(embed.dtype)
    out["lm_head"] = torch.cat([llama_params["lm_head"], extra_h], 1)
    return out
