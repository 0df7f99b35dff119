"""Shared by the port's bench-script test files: the JAX package's
top-level scripts loaded by path (they are files, not modules of a
package), and the tiny fusion config the decode and caption tests give
both packages (f32, the reference attention, vocabulary 32000 as the
scripts fix it)."""

import importlib.util
import json
import os

import jax.numpy as jnp
import torch

import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """scripts/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_decoder_config(tcfg):
    """The JAX UnifiedConfig of a port bench config (no encoder), f32 on
    the reference attention."""
    lc = tcfg.llama
    return juni.UnifiedConfig(
        llama=jllama.LlamaConfig(
            vocab_size=lc.vocab_size, dim=lc.dim, n_layers=lc.n_layers,
            n_heads=lc.n_heads, n_kv_heads=lc.n_kv_heads,
            intermediate=lc.intermediate, rope_theta=lc.rope_theta,
            max_seq_len=lc.max_seq_len, dtype=jnp.float32,
            attn_backend="ref", remat=False),
        esm=None, protein_embed_dim=tcfg.protein_embed_dim,
        token_projector_layers=tcfg.token_projector_layers,
        token_projector_hidden=tcfg.token_projector_hidden,
        retrieval_dim=tcfg.retrieval_dim, dtype=jnp.float32)


def last_json(capsys):
    """The last line a CLI printed, as JSON."""
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def as_numpy(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t
