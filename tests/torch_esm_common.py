"""Shared by the port's live-encoder tests (test_torch_esm_lora.py,
test_torch_mlm.py, test_torch_esm_trainer.py): a tiny ESM2 config in both
packages (2 layers of width 64, 4 heads, f32, attn_backend "ref"), the JAX
package's random parameters with the LoRA banks' B, the prefix rows and the
adapter's up projection made nonzero (at init B = 0 and up = 0, so the
gradients of A and of the down projection vanish), residue tokens with
padding and <mask> rows, and the port's config from the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.lora as jlora
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import lora as tlora

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4


def jax_cfg(**kw):
    base = dict(dim=64, n_layers=2, n_heads=4, dtype=jnp.float32,
                max_seq_len=32, attn_backend="ref", remat=False)
    base.update(kw)
    return jesm.ESM2Config(**base)


def jax_lora(rank=4, alpha=8.0, num_experts=3):
    return jlora.LoRAConfig(rank=rank, alpha=alpha, num_experts=num_experts,
                            dtype=jnp.float32)


def port_lora(lcfg):
    """The port's LoRAConfig of a reference one (f32)."""
    if lcfg is None:
        return None
    return tlora.LoRAConfig(rank=lcfg.rank, alpha=lcfg.alpha,
                            num_experts=lcfg.num_experts,
                            dtype=torch.float32)


def port_cfg(jcfg, **kw):
    """The port's ESM2Config with the reference config's fields."""
    names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
    base = {k: getattr(jcfg, k) for k in names
            if k not in ("dtype", "lora")}
    base.update(dtype=torch.float32, lora=port_lora(jcfg.lora))
    base.update(kw)
    return tesm.ESM2Config(**base)


def tokens(rng, B=3, S=16, masks=True):
    """Residue tokens [B, S]: cls / eos, the first row right-padded by 4,
    two <mask> tokens a row."""
    t = rng.integers(4, 24, (B, S)).astype(np.int32)
    t[:, 0] = jesm.CLS_IDX
    t[:, -1] = jesm.EOS_IDX
    t[0, -5] = jesm.EOS_IDX
    t[0, -4:] = jesm.PAD_IDX
    if masks:
        for i in range(B):
            t[i, rng.integers(1, S - 5, 2)] = jesm.MASK_IDX
    return t


def perturbed_params(jcfg, seed=0, scale=0.1):
    """The reference's init with every LoRA B, the prefix rows and the
    adapter's up projection drawn N(0, scale^2): each expert then differs
    and every trained leaf has a gradient."""
    params = jesm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    layers = dict(params["layers"])
    for k, v in layers.items():
        if k.startswith("lora_"):
            layers[k] = {**v, "B": jnp.asarray(
                scale * rng.standard_normal(v["B"].shape), jnp.float32)}
    if "adapter" in layers:
        a = layers["adapter"]
        layers["adapter"] = {**a, "wu": jnp.asarray(
            scale * rng.standard_normal(a["wu"].shape), jnp.float32)}
    if "prefix" in layers:
        layers["prefix"] = {n: jnp.asarray(
            rng.standard_normal(v.shape), jnp.float32)
            for n, v in layers["prefix"].items()}
    return {**params, "layers": layers}


def trained(tree, pred):
    """{path: leaf} of the leaves whose '/'-joined path satisfies pred."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif pred("/".join(path)):
            out["/".join(path)] = node
    walk(tree, ())
    return out


def set_path(tree, path, value):
    """A copy of a nested dict with the leaf at '/'-joined path replaced."""
    keys = path.split("/")
    out = dict(tree)
    node = out
    for k in keys[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[keys[-1]] = value
    return out


def assert_grads_close(got, want, rtol=GRAD_RTOL):
    """Each gradient within rtol of the reference's largest element."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].detach().numpy()
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(w).max() > 0, f"{k}: the reference's gradient is 0"
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0,
                                   err_msg=k)


def live_models(prot_lora=None, llama_lora=None, esm_seed=5, **esm_kw):
    """(JAX UnifiedConfig, the port's, the JAX package's parameters) of the
    tiny fusion model with a live encoder of width 32 (2 layers, 4 heads;
    its banks, prefix and adapter perturbed) and, with llama_lora, LoRA
    banks on the decoder with nonzero B."""
    import procyon_tpu.models.llama as jllama
    import procyon_tpu.models.unified as juni
    from procyon_tpu_torch.models import contrastive as tcon
    from procyon_tpu_torch.models import llama as tllama
    from procyon_tpu_torch.models import unified as tuni

    ecfg = jesm.ESM2Config(dim=32, n_layers=2, n_heads=4, dtype=jnp.float32,
                           max_seq_len=64, attn_backend="ref", remat=False,
                           lora=prot_lora, **esm_kw)
    jl = jllama.tiny_config(attn_backend="ref", remat=False, vocab_size=512,
                            max_seq_len=256, lora=llama_lora)
    jcfg = juni.tiny_config(llama=jl, esm=ecfg, protein_embed_dim=32)
    params = juni.init_params(jax.random.PRNGKey(0), jcfg)
    params = {**params, "esm": perturbed_params(ecfg, seed=esm_seed)}
    if llama_lora is not None:
        rng = np.random.default_rng(esm_seed + 200)
        layers = dict(params["llama"]["layers"])
        for name in ("lora_wq", "lora_wv"):
            layers[name] = {**layers[name], "B": jnp.asarray(
                0.1 * rng.standard_normal(layers[name]["B"].shape),
                jnp.float32)}
        params = {**params, "llama": {**params["llama"], "layers": layers}}
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    lf = {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)}
    lf.update(dtype=torch.float32, lora=port_lora(llama_lora))
    fields.update(llama=tllama.LlamaConfig(**lf), esm=port_cfg(ecfg),
                  contrastive=tcon.InfoNCEConfig(), dtype=torch.float32)
    return jcfg, tuni.UnifiedConfig(**fields), params
