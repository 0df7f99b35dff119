"""The plain reference against the port at a tiny size in f32 on the CPU:
the encoder's hidden states, the protein embedding through the index entry,
and the masked-LM loss."""

import numpy as np
import torch

from benchmark.models import esm2 as model
from benchmark.reference import esm2 as ref
from benchmark.traffic import generator
from conftest import TINY_MODEL

CFG = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
       "intermediate_size": 256, "vocab_size": 33, "layer_norm_eps": 1e-5,
       "max_position_embeddings": 130, "token_dropout": True,
       "layout": {"weights": "bf16", "fused_qkv": False,
                  "attn_backend": "ref"},
       "projector": {"retrieval_dim": 16, "layers": 1}}
assert all(CFG[k] == v for k, v in TINY_MODEL.items())


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def test_encoder_hidden_matches_port():
    from procyon_tpu_torch.models import esm2
    raw = f32(model.raw_weights(CFG, 11, "cpu"))
    cfg = model.port_esm_config(CFG, dtype=torch.float32)
    seqs = ["MKTAYIAKQRQISFVKSHFSRQ", "GAVLI" * 9, "W"]
    rows = [r for s in seqs for r in ref.chunk_rows(s, 30)]
    toks = ref.pad_rows(rows, "cpu")
    got = esm2.forward(raw, cfg, toks)["hidden"]
    m = (toks != ref.PAD).float()[..., None]
    got = (got * m).sum(1) / m.sum(1)
    want = ref.encode_rows(raw, model.dims(CFG), rows, "f32", device="cpu")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_protein_embeddings_match_index_entry():
    from procyon_tpu_torch.training import evaluation
    raw = f32(model.raw_weights(CFG, 12, "cpu"))
    proj = model.raw_projector(CFG, 12, "cpu").float()
    cfg = model.port_unified_config(
        CFG, model.port_esm_config(CFG, dtype=torch.float32),
        dtype=torch.float32)
    seqs = generator.sequences(
        {"lengths": {"median": 40, "sigma": 0.7, "min": 10, "max": 200},
         "proteins": 9}, 5, 0)

    class Store:
        def protein_sequence(self, i):
            return seqs[i]

    params = {"esm": raw, "projectors": {"shared_projector": [{"w": proj}]}}
    got = evaluation.all_protein_target_embeddings(
        params, cfg, Store(), list(range(9)), batch=4, max_protein_len=30,
        device="cpu")
    want = ref.protein_embeddings(raw, proj, model.dims(CFG), seqs, 30,
                                  "f32", device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_mlm_loss_matches_port():
    from procyon_tpu_torch.models import esm2, unified
    from procyon_tpu_torch.training import train_step as ts
    lora = {"rank": 4, "alpha": 8.0, "experts": 3, "targets": "default"}
    raw = f32(model.raw_weights(CFG, 13, "cpu", lora=lora))
    for n in list(raw["layers"]):
        if n.startswith("lora_"):
            raw["layers"][n]["B"] = 0.05 * torch.randn_like(
                raw["layers"][n]["B"])
    cfg = model.port_esm_config(CFG, dtype=torch.float32, lora=lora)
    mix = {"lengths": {"median": 40, "sigma": 0.7, "min": 10, "max": 200},
           "proteins": 4, "max_protein_len": 60,
           "mask": {"select": 0.15, "mask": 0.8, "random": 0.1}}
    b = generator.mlm_batch(mix, 3, 0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    ucfg = unified.UnifiedConfig(esm=cfg, dtype=torch.float32)
    got, _ = ts.mlm_loss_fn({"esm": raw}, ucfg, batch, 1.0, lora_expert=1)
    banks = {n[len("lora_"):]: raw["layers"][n] for n in raw["layers"]
             if n.startswith("lora_")}
    base = {**raw, "layers": {k: v for k, v in raw["layers"].items()
                              if not k.startswith("lora_")}}
    want = ref.mlm_loss(base, banks, model.dims(CFG),
                        batch["protein_tokens"].long(),
                        batch["mlm_labels"].long(), "f32", expert=1,
                        scaling=lora["alpha"] / lora["rank"])
    assert esm2.MASK_IDX == ref.MASK
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_precisions_round_products():
    x = torch.randn(5, 64)
    w = torch.randn(64, 32)
    exact = x @ w
    gaps = {p: float((ref.linear(x, ref.prepare_weight(w, p), p) - exact)
                     .norm() / exact.norm()) for p in ref.PRECISIONS}
    assert gaps["f32"] == 0.0
    assert 0 < gaps["w8a8"] < gaps["fp8"] < gaps["w4a8"] < 0.3
