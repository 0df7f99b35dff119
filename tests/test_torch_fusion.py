"""procyon_tpu_torch's fusion model (soft-token injection, LM and retrieval
forward, the retrieval query embedding, the InfoNCE heads) against
procyon_tpu.models.unified on the CPU in f32, with the reference's
parameters carried across through the bridge and the same collator batches.

Tolerance 1e-4 (abs and rel): the same f32 function with sums in another
order, through two decoder layers, projectors and a softmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.contrastive as jcon
import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jdatasets
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu_torch import bridge
from procyon_tpu_torch.evaluate.qa import qa_yes_prob
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import unified as tuni

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 512


def _configs(**kw):
    jcfg = juni.UnifiedConfig(
        llama=jllama.tiny_config(vocab_size=VOCAB, attn_backend="ref",
                                 remat=False, max_seq_len=256),
        esm=None, protein_embed_dim=32, token_projector_layers=2,
        token_projector_hidden=24, retrieval_dim=16, dtype=jnp.float32,
        struct_embed_dim=16, drug_embed_dim=16, **kw)
    lfields = {f.name: getattr(jcfg.llama, f.name)
               for f in dataclasses.fields(jcfg.llama)}
    lfields.update(dtype=torch.float32, attn_backend=None)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields.update(llama=tllama.LlamaConfig(**lfields),
                  contrastive=tcon.InfoNCEConfig(), dtype=torch.float32)
    return jcfg, tuni.UnifiedConfig(**fields)


def _both(batch):
    skip = ("reference_indices",)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k not in skip}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
          if k not in skip}
    return jb, tb


def _collate(kind, store, tok, **cfg_kw):
    lib = jinstruct.TaskLibrary()
    task = lib.get(f"disgenet_all_{kind}")
    prompt = jinstruct.get_prompt(task, num_examples=1)
    ccfg = jC.CollatorConfig(max_text_len=160, protein_embed_dim=32,
                             struct_embed_dim=16, drug_embed_dim=16,
                             **cfg_kw)
    if kind == "qa":
        coll = jC.QACollator(ccfg, tok, store, task)
        return coll([(1, 2, True), (3, 4, False), (5, 2, True)], prompt)
    coll = jC.RetrievalCollator(ccfg, tok, store, task)
    return coll([(1, 2), (3, 4), (5, 6), (7, 2)], prompt)


@pytest.fixture(scope="module")
def fixtures():
    store = jdatasets.SyntheticStore(n_proteins=32, embed_dim=32,
                                     struct_dim=16, drug_dim=16)
    return store, jload_tokenizer(vocab_size=VOCAB)


def test_lm_forward_with_protein_struct_and_drug_soft_tokens(fixtures):
    store, tok = fixtures
    jcfg, tcfg = _configs(use_protein_struct=True, use_drug_embeddings=True)
    params = juni.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(params)
    batch = _collate("qa", store, tok, use_protein_struct=True,
                     use_drug_embeddings=True)
    n_prot = batch["protein_embeds"].shape[0]
    banks = batch["soft_map"][batch["soft_map"] >= 0] // n_prot
    assert set(banks.tolist()) == {0, 1, 2}      # all three modalities
    jb, tb = _both(batch)

    want_bank = juni.build_soft_bank(params, jcfg, jb["protein_embeds"],
                                     drug_embeds=jb["drug_embeds"],
                                     struct_embeds=jb["struct_embeds"])
    got_bank = tuni.build_soft_bank(tparams, tcfg, tb["protein_embeds"],
                                    drug_embeds=tb["drug_embeds"],
                                    struct_embeds=tb["struct_embeds"])
    np.testing.assert_allclose(got_bank.numpy(), np.asarray(want_bank),
                               **TOL)
    np.testing.assert_allclose(
        tuni.assemble_input_embeds(tparams, tcfg, tb).numpy(),
        np.asarray(juni.assemble_input_embeds(params, jcfg, jb)), **TOL)

    want = juni.forward(params, jcfg, jb)
    got = tuni.forward(tparams, tcfg, tb)
    valid = batch["seg_ids"] > 0
    np.testing.assert_allclose(got["logits"].numpy()[valid],
                               np.asarray(want["logits"])[valid], **TOL)
    for key in ("lm_loss", "lm_loss_per_row", "lm_token_count"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    # the QA readout on the same forward
    rows = np.arange(len(batch["answer_pos"]))
    yes, no = int(batch["yes_token"]), int(batch["no_token"])
    np.testing.assert_allclose(
        qa_yes_prob(got["logits"].numpy()[rows, batch["answer_pos"]],
                    yes, no),
        qa_yes_prob(np.asarray(want["logits"])[rows, batch["answer_pos"]],
                    yes, no), **TOL)


@pytest.mark.parametrize("explicit_negatives", [False, True])
def test_retrieval_forward_and_query_embedding(fixtures, explicit_negatives):
    store, tok = fixtures
    jcfg, tcfg = _configs()
    params = juni.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = bridge.to_torch(params)
    batch = _collate("retrieval", store, tok)
    batch["ret_valid"][3] = False
    assert batch["conflict_mask"][0, 3] == 0     # rows 0 and 3 share a text
    if explicit_negatives:
        U = batch["protein_embeds"].shape[0]
        batch["ret_negative_pos"] = (
            np.arange(4)[:, None] + np.arange(1, 3)[None]).astype(
                np.int32) % U
    jb, tb = _both(batch)
    want = juni.forward(params, jcfg, jb, retrieval=True)
    got = tuni.forward(tparams, tcfg, tb, retrieval=True)
    for key in ("query_embeds", "target_embeds", "retrieval_loss"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    assert set(got["retrieval_metrics"]) == set(want["retrieval_metrics"])
    for key, val in want["retrieval_metrics"].items():
        np.testing.assert_allclose(got["retrieval_metrics"][key].numpy(),
                                   np.asarray(val), **TOL)
    q_want = juni.retrieval_query_embedding(params, jcfg, jb)
    q_got = tuni.retrieval_query_embedding(tparams, tcfg, tb)
    np.testing.assert_allclose(q_got.numpy(), np.asarray(q_want), **TOL)
    np.testing.assert_allclose(q_got.numpy(), got["query_embeds"].numpy(),
                               atol=1e-6)


def test_info_nce_heads_against_reference():
    rng = np.random.default_rng(5)
    N, K, D = 6, 3, 16
    s, t = (rng.standard_normal((N, D)).astype(np.float32) for _ in "st")
    negs = rng.standard_normal((N, K, D)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    ids = np.array([7, 8, 9, 7, 10, 11], np.int64)
    mask = (rng.random((N, N)) > 0.2).astype(np.float32)
    jp = jcon.init_params(jcon.InfoNCEConfig())
    tp = tcon.init_params(tcon.InfoNCEConfig(), device="cpu")
    for kw in (dict(), dict(valid=valid), dict(valid=valid, conflict_ids=ids),
               dict(conflict_mask=mask, conflict_ids=ids)):
        want, wm = jcon.info_nce_in_batch(
            jp, jcon.InfoNCEConfig(), jnp.asarray(s), jnp.asarray(t),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got, gm = tcon.info_nce_in_batch(
            tp, tcon.InfoNCEConfig(), torch.from_numpy(s),
            torch.from_numpy(t),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in wm:
            np.testing.assert_allclose(gm[key].numpy(), np.asarray(wm[key]),
                                       **TOL)
    want, _ = jcon.info_nce_explicit(jp, jcon.InfoNCEConfig(symmetric=False),
                                     jnp.asarray(s), jnp.asarray(t),
                                     jnp.asarray(negs))
    got, _ = tcon.info_nce_explicit(tp, tcon.InfoNCEConfig(symmetric=False),
                                    torch.from_numpy(s), torch.from_numpy(t),
                                    torch.from_numpy(negs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="training"):
        tcon.info_nce_in_batch(tp, tcon.InfoNCEConfig(), torch.from_numpy(s),
                               torch.from_numpy(t), axis_name="data")


def test_port_init_params_tree_and_quantize():
    """The port's own init gives the reference tree's keys and shapes (in
    frozen-embedding mode, with struct and drug projectors), on the device
    it is told; quantize_params leaves the projectors alone."""
    jcfg, tcfg = _configs(use_protein_struct=True, use_drug_embeddings=True)
    ref = juni.init_params(jax.random.PRNGKey(0), jcfg)
    p = tuni.init_params(0, tcfg, device="cpu")
    flat_t = dict(jax.tree_util.tree_leaves_with_path(bridge.to_numpy(p)))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert set(flat_t) == set(flat_j)
    for path, leaf in flat_t.items():
        assert leaf.shape == flat_j[path].shape, path
    q = tuni.quantize_params(p, tcfg)
    assert set(q["llama"]["lm_head"]) == {"q", "s"}
    assert q["projectors"] is p["projectors"]
    assert tuni.tiny_config().esm is not None
