"""Shared by the port's evaluation test files: a tiny fusion model's config
in both packages (f32, the reference attention), with frozen protein tables
or a tiny live ESM2, and the JAX script `scripts/run_eval_framework.py`
loaded by path."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import unified as tuni

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512
TABLE_DIM = 32        # frozen protein tables
ESM_DIM = 64          # the tiny live ESM2's width
ESM_MAX_LEN = 62      # residues a row: width 64, the tiny ESM2's max_seq_len


def port_config(jcfg):
    """The port's UnifiedConfig with the reference config's fields (f32)."""
    lf = {f.name: getattr(jcfg.llama, f.name)
          for f in dataclasses.fields(jcfg.llama)}
    lf.update(dtype=torch.float32, lora=None)
    esm = None
    if jcfg.esm is not None:
        names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
        ef = {k: v for k, v in dataclasses.asdict(jcfg.esm).items()
              if k in names and k not in ("dtype", "lora")}
        esm = tesm.ESM2Config(**ef, dtype=torch.float32)
    uf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    uf.update(llama=tllama.LlamaConfig(**lf), esm=esm,
              contrastive=tcon.InfoNCEConfig(**{
                  f.name: getattr(jcfg.contrastive, f.name)
                  for f in dataclasses.fields(jcfg.contrastive)
                  if f.name != "dtype"}, dtype=torch.float32),
              dtype=torch.float32)
    return tuni.UnifiedConfig(**uf)


def tiny_configs(live_esm=False):
    """(JAX config, port config) of a 2-layer fusion model."""
    jcfg = juni.UnifiedConfig(
        llama=jllama.tiny_config(vocab_size=VOCAB, attn_backend="ref",
                                 remat=False, max_seq_len=512),
        esm=jesm.tiny_config(attn_backend="ref", remat=False)
        if live_esm else None,
        protein_embed_dim=TABLE_DIM, token_projector_layers=2,
        token_projector_hidden=24, retrieval_dim=16, dtype=jnp.float32)
    return jcfg, port_config(jcfg)


def jax_eval_script():
    """scripts/run_eval_framework.py of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_eval_framework",
        os.path.join(ROOT, "scripts", "run_eval_framework.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
