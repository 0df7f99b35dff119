"""Shared by tests/test_torch_generation.py, test_torch_paged_beam.py and
test_torch_caption_cli.py: one tiny fusion model in both packages (the JAX
package's random parameters, bridged), and left-padded soft-token prompt
batches made with numpy, in the layout of the caption collator's
for_generation batches (after tests/test_paged_beam.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from procyon_tpu.inference import generation as jgen
from procyon_tpu.models import unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.inference import generation as tgen
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import unified as tuni


def port_config(jcfg, attn_backend="ref"):
    """The port's UnifiedConfig of a JAX UnifiedConfig (frozen-embedding
    mode), f32."""
    lfields = {f.name: getattr(jcfg.llama, f.name)
               for f in dataclasses.fields(jcfg.llama)}
    lfields.update(dtype=torch.float32, attn_backend=attn_backend)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields.update(llama=tllama.LlamaConfig(**lfields),
                  contrastive=tcon.InfoNCEConfig(), dtype=torch.float32)
    return tuni.UnifiedConfig(**fields)


def setup_model(seed=0, protein_embed_dim=16, **llama_kw):
    """(jcfg, jparams, tcfg, tparams): the reference's tiny model (CPU
    reference attention on both sides) and the same weights in the port."""
    jcfg = juni.tiny_config(esm=None, protein_embed_dim=protein_embed_dim)
    if llama_kw:
        jcfg = dataclasses.replace(jcfg, llama=dataclasses.replace(
            jcfg.llama, **llama_kw))
    jparams = juni.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, port_config(jcfg), bridge.to_torch(jparams)


def gen_configs(**kw):
    return jgen.GenerationConfig(**kw), tgen.GenerationConfig(**kw)


def both(batch):
    """A numpy batch as (JAX arrays, torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def make_soft_batch(cfg, rng, B=2, L=12, n_prot=3, ragged=True):
    """Left-padded fused prompts with one protein soft token per row."""
    ids = np.asarray(rng.integers(4, cfg.llama.vocab_size, (B, L)), np.int32)
    seg = np.ones((B, L), np.int32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    soft = np.full((B, L), -1, np.int32)
    for b in range(B):
        pad = (b * 3) % (L // 2) if ragged else 0
        ids[b, :pad] = 0
        seg[b, :pad] = 0
        pos[b] = np.maximum(pos[b] - pad, 0)
        soft[b, pad + 1] = b % n_prot
    return {"input_ids": ids, "seg_ids": seg, "positions": pos,
            "soft_map": soft,
            "protein_embeds": rng.standard_normal(
                (n_prot, cfg.encoder_out_dim)).astype(np.float32)}


def make_shared_batch(cfg, rng, tails, S=9, n_prot=3, shared=None,
                      L_pad=None):
    """Fused prompts sharing a common S-token instruction prefix, then a
    per-row protein soft token and a random tail (the bulk-caption shape).
    The same `shared` ids build several batches over one template; L_pad
    forces the padded width (a session needs every batch at the first
    batch's width bound)."""
    B = len(tails)
    lens = [S + 1 + t for t in tails]
    L = L_pad or max(lens)
    ids = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    soft = np.full((B, L), -1, np.int32)
    if shared is None:
        shared = np.asarray(rng.integers(4, cfg.llama.vocab_size, S),
                            np.int32)
    for b in range(B):
        pad = L - lens[b]                       # left padding
        ids[b, pad:pad + S] = shared
        ids[b, pad + S + 1:] = rng.integers(4, cfg.llama.vocab_size,
                                            tails[b])
        seg[b, pad:] = 1
        pos[b, pad:] = np.arange(lens[b])
        soft[b, pad + S] = b % n_prot
    return {"input_ids": ids, "seg_ids": seg, "positions": pos,
            "soft_map": soft,
            "protein_embeds": rng.standard_normal(
                (n_prot, cfg.encoder_out_dim)).astype(np.float32)}
