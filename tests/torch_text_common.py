"""Shared by the port's BERT, BERTScore and text-baseline test files: the
port's BertConfig for a JAX one, the JAX encoder's forward under jax.jit,
tiny HF BERT state dicts in numpy, the JAX projection heads carried
across, and the JAX package's scripts loaded by path."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import torch

from procyon_tpu.models import bert as jbert
from procyon_tpu_torch import bridge
from procyon_tpu_torch.evaluate.baselines import text_models as ttm
from procyon_tpu_torch.models import bert as tbert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

jforward = jax.jit(jbert.forward, static_argnames=("cfg",
                                                   "return_all_hidden"))


def port_bert_config(jcfg) -> tbert.BertConfig:
    """The port's config with the JAX config's fields, f32."""
    names = {f.name for f in dataclasses.fields(tbert.BertConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name != "dtype"}
    return tbert.BertConfig(**kw, dtype=torch.float32)


def proj_to_torch(proj, *, device=None):
    """A JAX projection head (procyon_tpu's MLPProj: weights `ws` [in, out],
    biases `bs` or None, activation `act`), or None, -> the port's MLPProj
    with the same fields."""
    if proj is None:
        return None
    return ttm.MLPProj(ws=[bridge.to_torch(w, device=device)
                           for w in proj.ws],
                       bs=[bridge.to_torch(b, device=device)
                           for b in proj.bs],
                       act=proj.act)


def hf_bert_state(dim=64, layers=2, vocab=128, positions=64, seed=0, *,
                  prefix="", gamma_beta=False, pooler=True):
    """A random HF-layout BERT state dict (numpy f32): `prefix` before every
    name (e.g. "bert."), legacy gamma / beta LayerNorm names, with or
    without the pooler."""
    rng = np.random.default_rng(seed)
    ffn = 4 * dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    g, b = ("gamma", "beta") if gamma_beta else ("weight", "bias")
    s = {"embeddings.word_embeddings.weight": w(vocab, dim),
         "embeddings.position_embeddings.weight": w(positions, dim),
         "embeddings.token_type_embeddings.weight": w(2, dim),
         f"embeddings.LayerNorm.{g}": 1 + w(dim),
         f"embeddings.LayerNorm.{b}": w(dim)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            s[p + f"attention.self.{name}.weight"] = w(dim, dim)
            s[p + f"attention.self.{name}.bias"] = w(dim)
        s[p + "attention.output.dense.weight"] = w(dim, dim)
        s[p + "attention.output.dense.bias"] = w(dim)
        s[p + f"attention.output.LayerNorm.{g}"] = 1 + w(dim)
        s[p + f"attention.output.LayerNorm.{b}"] = w(dim)
        s[p + "intermediate.dense.weight"] = w(ffn, dim)
        s[p + "intermediate.dense.bias"] = w(ffn)
        s[p + "output.dense.weight"] = w(dim, ffn)
        s[p + "output.dense.bias"] = w(dim)
        s[p + f"output.LayerNorm.{g}"] = 1 + w(dim)
        s[p + f"output.LayerNorm.{b}"] = w(dim)
    if pooler:
        s["pooler.dense.weight"] = w(dim, dim)
        s["pooler.dense.bias"] = w(dim)
    s["cls.predictions.bias"] = w(vocab)          # an MLM head, ignored
    return {prefix + k: v for k, v in s.items()}


def jax_script(name):
    """scripts/<name>.py of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
