"""Shared by tests/test_torch_train_step.py and test_torch_train_grads.py:
a tiny fusion config in both packages (2 decoder layers of width 64, GQA
4/2, vocab 512, task-banked LoRA r4 x 4 whose B banks are nonzero: at B = 0
the gradient of A is 0), the JAX package's random parameters, collator
batches for qa, caption and retrieval, the train states of both packages
and the tolerances the two files state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import procyon_tpu.models.llama as jllama
import procyon_tpu.models.lora as jlora
import procyon_tpu.models.unified as juni
from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jdatasets
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.training import optimizer as jopt
from procyon_tpu.training import train_step as jts
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import lora as tlora
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.training import optimizer as topt

TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL = 5e-5
GRAD_SHARE = 5e-4
VOCAB = 512
STEPS = 3
OPT = dict(lr=1e-3, projector_lr=2e-3, warmup_steps=1, total_steps=8,
           schedule="cosine", grad_clip=1.0)


def configs(attn_backend="ref"):
    jl = jllama.tiny_config(
        vocab_size=VOCAB, attn_backend="ref", remat=False, max_seq_len=256,
        lora=jlora.LoRAConfig(rank=4, alpha=8.0, num_experts=4,
                              dtype=jnp.float32))
    jcfg = juni.UnifiedConfig(
        llama=jl, esm=None, protein_embed_dim=32, token_projector_layers=2,
        token_projector_hidden=24, retrieval_dim=16, dtype=jnp.float32)
    lfields = {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)}
    lfields.update(dtype=torch.float32, attn_backend=attn_backend, remat=True,
                   lora=tlora.LoRAConfig(rank=4, alpha=8.0, num_experts=4,
                                         dtype=torch.float32))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields.update(llama=tllama.LlamaConfig(**lfields),
                  contrastive=tcon.InfoNCEConfig(), dtype=torch.float32)
    return jcfg, tuni.UnifiedConfig(**fields)


def make_setup():
    jcfg, tcfg = configs()
    params = juni.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for name in ("lora_wq", "lora_wv"):
        bank = params["llama"]["layers"][name]
        bank["B"] = jnp.asarray(
            0.1 * rng.standard_normal(bank["B"].shape), jnp.float32)
    store = jdatasets.SyntheticStore(n_proteins=32, embed_dim=32)
    tok = jload_tokenizer(vocab_size=VOCAB)
    lib = jinstruct.TaskLibrary()
    ccfg = jC.CollatorConfig(max_text_len=96, protein_embed_dim=32)
    batches = {}
    for kind, coll_cls, samples in (
            ("qa", jC.QACollator, [(1, 2, True), (3, 4, False),
                                   (5, 2, True), (6, 7, False)]),
            ("caption", jC.CaptionCollator, [(1, 2), (3, 4), (5, 6)]),
            ("retrieval", jC.RetrievalCollator,
             [(1, 2), (3, 4), (5, 6), (7, 2)])):
        task = lib.get(f"disgenet_all_{kind}")
        prompt = jinstruct.get_prompt(task, num_examples=1)
        batches[kind] = coll_cls(ccfg, tok, store, task)(samples, prompt)
    return jcfg, tcfg, params, batches


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()
            if k != "reference_indices"}


def compare_trees(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            compare_trees(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            compare_trees(g, w, f"{where}/{i}")
    else:
        w = np.asarray(want)
        g = np.asarray(got)
        assert g.shape == w.shape and g.dtype == w.dtype, (where, g.dtype,
                                                           w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(g, w, err_msg=where)


def states(jcfg, params, mode):
    """(JAX state, port state, JAX optimizer, port optimizer)."""
    ocfg_j = jopt.OptimizerConfig(**OPT)
    ocfg_t = topt.OptimizerConfig(**OPT)
    if mode == "qlora":
        params = dict(params)
        params["llama"] = jllama.quantize_params(params["llama"],
                                                 jcfg.llama)
        trainable, _ = jts.partition_params(params,
                                            jts.lora_trainable_predicate)
        jo = jopt.build_optimizer(ocfg_j, trainable)
        jstate = jts.init_train_state(
            params, jo, trainable_predicate=jts.lora_trainable_predicate)
    else:
        jo = jopt.build_optimizer(ocfg_j, params)
        jstate = jts.init_train_state(params, jo)
    to = topt.build_optimizer(ocfg_t)
    tstate = bridge.train_state_to_torch(jstate)
    assert tstate["opt_state"]["count"] == 0
    compare_trees(bridge.to_numpy(tstate["opt_state"]["mu"]),
                   bridge.to_numpy(to.init(tstate["params"])["mu"]))
    return jstate, tstate, jo, to


def check_metrics(tm, jm):
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), **TOL,
                                   err_msg=k)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + (str(i),))
    else:
        yield prefix, tree
