"""procyon_tpu_torch's models/checkpoint_io against procyon_tpu's on the
CPU: the HF / fair-esm converters on the goldens in tests/goldens/ and on
the reference's own trees (exactly the reference's leaves); released-
checkpoint ingestion on the synthetic DeepSpeed ZeRO-2 and consolidated
checkpoints of tests/test_checkpoint_ingest.py (round trip exact, the
config extraction equal to the reference's, the same loud refusals); the
traps ROADMAP.md lists for this module: the vocabulary sized from the
checkpoint ([EXT] has no embedding row), the 1-layer projector without a
bias, the two token-dropout semantics; save_model -> load_model round trips
(bit for bit); a run_pretrain --synthetic true --device cpu checkpoint that
loads as the in-memory model; and the two entry points that load models
(app/main with CHECKPOINT_PATH, caption_bulk --checkpoint).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu.models import checkpoint_io as jcio
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import checkpoint_io as tcio
from procyon_tpu_torch.models import contrastive as tcon
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import lora as tlora
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.training import optimizer as topt
from test_checkpoint_ingest import (_export_reference_sd, _frozen_tables,
                                    _tiny_cfg, _write_model_args,
                                    _write_zero2_checkpoint)
from torch_cpu_common import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    blob = np.load(os.path.join(GOLDEN_DIR, name))
    return blob, {k[3:]: blob[k] for k in blob.files if k.startswith("sd/")}


def _assert_same_tree(got, want):
    """Equal paths, shapes, dtypes and values, bit for bit."""
    g = dict(topt.tree_items(got))
    w = dict(topt.tree_items(want))
    assert set(g) == set(w)
    for k in w:
        a, b = g[k], w[k]
        if isinstance(b, dict):
            assert set(a) == set(b), k
            for kk in b:
                assert torch.equal(a[kk], b[kk]), (k, kk)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), k


def _port_esm(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tesm.ESM2Config)}
    base = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k in names and k not in ("dtype", "lora")}
    base.update(dtype=torch.float32, **kw)
    return tesm.ESM2Config(**base)


def _port_unified(jcfg):
    """The port's UnifiedConfig with the reference config's fields (f32)."""
    lf = {f.name: getattr(jcfg.llama, f.name)
          for f in dataclasses.fields(jcfg.llama)}
    lf.update(dtype=torch.float32, lora=None)
    uf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    uf.update(llama=tllama.LlamaConfig(**lf),
              esm=_port_esm(jcfg.esm) if jcfg.esm is not None else None,
              contrastive=tcon.InfoNCEConfig(**{
                  f.name: getattr(jcfg.contrastive, f.name)
                  for f in dataclasses.fields(jcfg.contrastive)
                  if f.name != "dtype"}, dtype=torch.float32),
              dtype=torch.float32)
    return tuni.UnifiedConfig(**uf)


@pytest.mark.parametrize("name,kv", [("llama_mha.npz", 4),
                                     ("llama_gqa.npz", 2)])
def test_convert_hf_llama_matches_reference_and_golden(name, kv):
    blob, sd = _golden(name)
    jcfg = jllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                              n_kv_heads=kv, intermediate=128,
                              max_seq_len=64, dtype=jnp.float32,
                              attn_backend="ref", remat=False)
    tcfg = tllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                              n_kv_heads=kv, intermediate=128,
                              max_seq_len=64, dtype=torch.float32,
                              attn_backend="ref", remat=False)
    got = tcio.convert_hf_llama(sd, tcfg)
    _assert_same_tree(got, bridge.to_torch(jcio.convert_hf_llama(sd, jcfg)))
    out = tllama.forward(got, tcfg,
                         tokens=torch.from_numpy(np.array(blob["tokens"])))
    np.testing.assert_allclose(out["logits"].numpy(), blob["logits"],
                               atol=3e-4, rtol=3e-4)


def test_convert_hf_esm2_and_the_two_token_dropout_semantics():
    """The HF golden follows the full-length token-dropout semantics: the
    converted model gives its logits with pad_aware_token_dropout=False
    (3e-4, tests/test_goldens.py) and not with the pad-aware semantics
    (4e-3 off at the padded positions' rows); the flag survives
    save_model -> load_model."""
    blob, sd = _golden("esm2_tiny.npz")
    jcfg = jesm.ESM2Config(vocab_size=33, dim=64, n_layers=2, n_heads=4,
                           max_seq_len=130, dtype=jnp.float32,
                           attn_backend="ref", remat=False,
                           pad_aware_token_dropout=False)
    got = tcio.convert_hf_esm2(sd, _port_esm(jcfg))
    _assert_same_tree(got, bridge.to_torch(jcio.convert_hf_esm2(sd, jcfg)))
    valid = blob["tokens"] != jesm.PAD_IDX
    errs = {}
    for pad_aware in (False, True):
        out = tesm.forward(got, _port_esm(
            jcfg, pad_aware_token_dropout=pad_aware),
            torch.from_numpy(blob["tokens"]), return_logits=True)
        errs[pad_aware] = np.abs(out["logits"].numpy()[valid]
                                 - blob["logits"][valid]).max()
    assert errs[False] <= 3e-4 < errs[True]
    for pad_aware in (False, True):
        cfg = tuni.UnifiedConfig(esm=_port_esm(
            jcfg, pad_aware_token_dropout=pad_aware))
        back = tcio.unified_config_from_dict(tcio.config_to_dict(cfg))
        assert back == cfg


def test_convert_fairesm_matches_reference():
    jcfg = _tiny_cfg(live_esm=True)
    params = juni.init_params(jax.random.PRNGKey(9), jcfg)
    sd = _export_reference_sd(params, jcfg)
    pre = "protein_seq_encoder.model."
    esm_sd = {k[len(pre):]: np.asarray(v) for k, v in sd.items()
              if k.startswith(pre)}
    got = tcio.convert_fairesm_esm2(esm_sd, _port_esm(jcfg.esm))
    _assert_same_tree(got, bridge.to_torch(
        jcio.convert_fairesm_esm2(esm_sd, jcfg.esm)))
    _assert_same_tree(got, bridge.to_torch(params["esm"]))


def _reference_checkpoint(tmp_path, layout, seed):
    jcfg = _tiny_cfg(live_esm=layout == "live_esm")
    params = juni.init_params(jax.random.PRNGKey(seed), jcfg)
    sd = _export_reference_sd(params, jcfg)
    ckpt = tmp_path / "checkpoint-7"
    ckpt.mkdir()
    tables = {}
    if layout == "consolidated":
        torch.save({"model_state_dict": {
            k: torch.from_numpy(np.array(v, order="C"))
            for k, v in sd.items()}}, str(ckpt / "txllm_model_ckpt.pt"))
    else:
        tables = _frozen_tables(np.random.default_rng(0)) \
            if layout == "frozen" else {}
        sd.update(tables)
        _write_zero2_checkpoint(str(ckpt), sd, frozen_keys=set(tables))
    _write_model_args(str(ckpt), text_encoder_fname="llama-debug",
                      use_aaseq_embeddings=layout != "live_esm",
                      protein_pooling_opt="mean")
    return jcfg, params, sd, ckpt, tables


@pytest.mark.parametrize("layout", ["frozen", "live_esm", "consolidated"])
def test_convert_reference_checkpoint_round_trip(tmp_path, layout):
    """ZeRO-2 shards (the optimizer's f32 partitions, not the zeroed module
    copies) or a consolidated file -> the port's model directory ->
    load_model: the reference's parameters exactly, the config the
    reference extracts, the frozen tables exported."""
    jcfg, params, _, ckpt, tables = _reference_checkpoint(
        tmp_path, layout, {"frozen": 3, "live_esm": 9,
                           "consolidated": 2}[layout])
    tcfg = _port_unified(jcfg)
    out = tmp_path / "converted"
    kw = dict(llama_config=tcfg.llama, dtype=torch.float32) \
        if layout == "frozen" else dict(cfg=tcfg)
    out_dir, report = tcio.convert_reference_checkpoint(str(ckpt), str(out),
                                                        **kw)
    assert set(report["converted"]) >= {
        "llama", "token_projector", "shared_projector", "lm_projector",
        "struct_projector", "drug_projector", "contrastive"}
    got, cfg, tok = tcio.load_model(out_dir, device="cpu")
    assert tok is None
    if layout == "frozen":    # extracted from model_args and the shapes
        assert (cfg.llama, cfg.protein_embed_dim, cfg.retrieval_dim,
                cfg.token_projector_layers, cfg.use_protein_struct,
                cfg.use_drug_embeddings) == (
            tcfg.llama, tcfg.protein_embed_dim, tcfg.retrieval_dim, 3,
            True, True)
    else:
        assert cfg == tcfg
    _assert_same_tree(got, bridge.to_torch(params))
    for fname, key in (("protein_seq_embeddings.npy",
                        "protein_seq_embeddings.weight"),
                       ("domain_embeddings.npy", "domain_embeddings.weight")):
        if tables:
            np.testing.assert_array_equal(
                np.load(os.path.join(out_dir, "embeddings", fname)),
                tables[key])


def test_config_extraction_matches_reference(tmp_path):
    jcfg, _, sd, ckpt, _ = _reference_checkpoint(tmp_path, "frozen", 3)
    weights = jcio.load_reference_state_dict(str(ckpt))
    tw = tcio.load_reference_state_dict(str(ckpt))
    assert set(tw) == set(weights)
    for k in weights:
        np.testing.assert_array_equal(tw[k], weights[k])
    margs, _ = jcio.load_checkpoint_args(str(ckpt))
    tmargs, _ = tcio.load_checkpoint_args(str(ckpt))
    want = jcio.unified_config_from_checkpoint(
        margs, weights, llama_config=jcfg.llama, dtype=jnp.float32)
    got = tcio.unified_config_from_checkpoint(
        tmargs, tw, llama_config=_port_unified(jcfg).llama,
        dtype=torch.float32)
    assert tcio.config_to_dict(got) == jcio.config_to_dict(want)


def test_conversion_refuses_loudly(tmp_path):
    jcfg = _tiny_cfg()
    tcfg = _port_unified(jcfg)
    params = juni.init_params(jax.random.PRNGKey(2), jcfg)
    sd = _export_reference_sd(params, jcfg)
    cases = {
        "aaseq_lm_projector": (KeyError, {k: v for k, v in sd.items()
                                          if not k.startswith(
                                              "aaseq_lm_projector")}),
        "temperature": (KeyError, {k: v for k, v in sd.items()
                                   if k != "contrastive_head.temperature"}),
        "not mapped": (KeyError, {**sd, "some.unknown.module.weight":
                                  np.zeros((3, 3), np.float32)}),
        # [EXT] has no embedding row: a checkpoint of len(tokenizer) - 1
        # rows against a config sized from the tokenizer
        "vocab mismatch": (ValueError, {
            **sd, "text_encoder.model.model.embed_tokens.weight":
            np.asarray(sd["text_encoder.model.model.embed_tokens.weight"])[
                :-1]}),
    }
    for i, (match, (err, bad)) in enumerate(cases.items()):
        ckpt = tmp_path / f"checkpoint-{i}"
        ckpt.mkdir()
        _write_zero2_checkpoint(str(ckpt), bad)
        with pytest.raises(err, match=match):
            tcio.convert_reference_checkpoint(str(ckpt),
                                              str(tmp_path / f"out{i}"),
                                              cfg=tcfg)


def test_one_layer_projector_has_no_bias():
    """A 1-layer create_mlp projector is one Linear without a bias; the
    port's init leaves it out too, so the converted tree matches it. A
    multi-layer projector without biases is refused."""
    w = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    layers = tcio._convert_projector({"0.weight": w}, torch.float32,
                                     name="shared_projector")
    assert len(layers) == 1 and set(layers[0]) == {"w"}
    np.testing.assert_array_equal(layers[0]["w"].numpy(), w.T)
    jl = jcio._convert_projector({"0.weight": w}, jnp.float32,
                                 name="shared_projector")
    assert set(jl[0]) == set(layers[0])
    cfg = tuni.tiny_config(esm=None)
    init = tuni.init_params(0, cfg, device="cpu")
    assert set(init["projectors"]["shared_projector"][0]) == {"w"}
    with pytest.raises(ValueError, match="missing biases"):
        tcio._convert_projector({"0.weight": w, "3.weight": w.T,
                                 "3.bias": np.zeros(8, np.float32)},
                                torch.float32, name="token_projector")


def test_permissive_unpickler(tmp_path):
    _write_model_args(str(tmp_path), text_encoder_fname="llama-3-8b",
                      num_layers_token_projector=3)
    margs, dargs = tcio.load_checkpoint_args(str(tmp_path))
    assert margs.text_encoder_fname == "llama-3-8b"
    assert margs.num_layers_token_projector == 3 and dargs is None


def test_resize_token_embeddings():
    jcfg = jllama.tiny_config()
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jp)
    V = jcfg.vocab_size
    small = tcio.resize_token_embeddings(tp, V - 5)
    jsmall = bridge.to_torch(jcio.resize_token_embeddings(jp, V - 5))
    assert torch.equal(small["embed"], jsmall["embed"])
    assert torch.equal(small["lm_head"], jsmall["lm_head"])
    assert tcio.resize_token_embeddings(tp, V) is tp
    big = tcio.resize_token_embeddings(tp, V + 300)
    assert big["embed"].shape == (V + 300, jcfg.dim)
    assert big["lm_head"].shape == (jcfg.dim, V + 300)
    assert torch.equal(big["embed"][:V], tp["embed"])
    assert torch.equal(big["lm_head"][:, :V], tp["lm_head"])
    assert abs(float(big["embed"][V:].std()) - 0.02) <= 0.005


def test_save_load_round_trip(tmp_path):
    """A tree with an ESM2 encoder, LoRA banks, projector lists and int8
    leaves: the same config and the same tensors, bit for bit, and the
    tokenizer from tokenizer.json."""
    lcfg = tllama.tiny_config(lora=tlora.LoRAConfig(
        rank=2, num_experts=2, dtype=torch.float32))
    cfg = tuni.tiny_config(llama=lcfg)
    params = tuni.quantize_params(tuni.init_params(0, cfg, device="cpu"),
                                  cfg)
    tcio.save_model(str(tmp_path), params, cfg,
                    tokenizer_info={"vocab_size": lcfg.vocab_size})
    with open(tmp_path / "configs.json") as f:
        assert json.load(f)["llama"]["dtype"] == "float32"
    got, cfg2, tok = tcio.load_model(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    assert tok is not None and tok._vocab == lcfg.vocab_size
    _assert_same_tree(got, params)


def test_lora_config_survives_the_round_trip():
    """A decoder with LoRA banks: the port's unified_config_from_dict
    rebuilds its LoRAConfig; the reference's passes the dict through
    (procyon_tpu/models/checkpoint_io.py:50), so its loaded config has no
    `lora.rank` (ROADMAP.md section 3)."""
    from procyon_tpu.models import lora as jlora
    tcfg = tuni.tiny_config(llama=tllama.tiny_config(lora=tlora.LoRAConfig(
        rank=2, num_experts=3, dtype=torch.float32)))
    back = tcio.unified_config_from_dict(tcio.config_to_dict(tcfg))
    assert back == tcfg and back.llama.lora.rank == 2
    jcfg = juni.tiny_config(llama=jllama.tiny_config(lora=jlora.LoRAConfig(
        rank=2, num_experts=3)))
    jback = jcio.unified_config_from_dict(jcio.config_to_dict(jcfg))
    assert isinstance(jback.llama.lora, dict)


def _batch(cfg, B=2, L=12, seed=0):
    rng = np.random.default_rng(seed)
    soft = np.full((B, L), -1, np.int32)
    soft[:, 2] = 0
    return {"input_ids": torch.as_tensor(
                rng.integers(4, cfg.llama.vocab_size, (B, L)),
                dtype=torch.int32),
            "soft_map": torch.as_tensor(soft),
            "protein_embeds": torch.as_tensor(rng.standard_normal(
                (1, cfg.protein_embed_dim)), dtype=torch.float32)}


def test_run_pretrain_checkpoint_loads_as_the_in_memory_model(tmp_path):
    """run_pretrain --synthetic true --device cpu writes checkpoint-2; the
    same run in this process (the same seeds, batches and f32 operations)
    holds the same model in memory: load_model gives its logits, bit for
    bit."""
    from procyon_tpu_torch.scripts import run_pretrain
    from procyon_tpu_torch.training import checkpointing
    from procyon_tpu_torch.bridge import merge_params
    from procyon_tpu_torch.training.train_step import batch_to_device
    from procyon_tpu_torch.training.trainer import Trainer
    argv = ["--synthetic", "true", "--device", "cpu", "--max_steps", "2",
            "--save_steps", "2", "--warmup_steps", "1", "--qa_batch_size",
            "2", "--retrieval_batch_size", "2", "--caption_batch_size", "2"]
    out = str(tmp_path / "cli")
    assert run_pretrain.main(argv + ["--output_dir", out]) == 0
    path = checkpointing.latest_checkpoint(out)
    assert path.endswith("checkpoint-2")
    params, cfg, tok = tcio.load_model(path, device="cpu")
    assert tok is not None

    run = run_pretrain.setup(argv + ["--output_dir", str(tmp_path / "mem")])
    trainer = Trainer(cfg=run["ucfg"], params=run["params"],
                      optimizer=run["optimizer"], loop=run["loop"],
                      task_streams=run["streams"], weights=run["weights"],
                      stream_states=run["stream_states"],
                      to_device=lambda b: batch_to_device(b, "cpu"))
    trainer.train()
    live = merge_params(trainer.state["params"],
                        trainer.state.get("frozen"))
    assert cfg == run["ucfg"]
    batch = _batch(cfg)
    with torch.no_grad():
        want = tuni.forward(live, cfg, batch)["logits"]
        got = tuni.forward(params, cfg, batch)["logits"]
    assert torch.equal(got, want)
    init = tuni.forward(run_pretrain.setup(argv + [
        "--output_dir", str(tmp_path / "x")])["params"], cfg,
        batch)["logits"]
    assert not torch.equal(got, init)


def _cpu_model(tmp_path):
    """A tiny f32 model on the CPU's reference attention, saved."""
    cfg = tuni.UnifiedConfig(
        llama=tllama.LlamaConfig(vocab_size=4096, dim=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, intermediate=128,
                                 max_seq_len=512, dtype=torch.float32,
                                 attn_backend="ref"),
        esm=None, protein_embed_dim=64, token_projector_layers=2,
        token_projector_hidden=64, retrieval_dim=32, dtype=torch.float32)
    params = tuni.init_params(5, cfg, device="cpu")
    path = tmp_path / "model"
    tcio.save_model(str(path), params, cfg,
                    tokenizer_info={"vocab_size": 4096})
    return str(path), params, cfg


def test_app_main_loads_a_saved_model(tmp_path, monkeypatch):
    """app/main's service from CHECKPOINT_PATH over a DATA_DIR that holds
    the frozen protein embeddings: the saved model's parameters, and its
    target embeddings of those proteins, cached beside the checkpoint.
    (A query needs the store's texts for its one-shot prompt, which
    ProCyonDataStore gives only through TextTableStore, here as in the
    reference.)"""
    from procyon_tpu_torch.app import main as app_main
    path, params, cfg = _cpu_model(tmp_path)
    emb_dir = tmp_path / "data" / "generated_data" / "aaseq_embeddings"
    emb_dir.mkdir(parents=True)
    table = torch.randn((40, 64), generator=torch.Generator().manual_seed(0))
    torch.save(table, str(emb_dir / "protein_esm2-3b_mean.pt"))
    monkeypatch.delenv("PROCYON_SYNTHETIC", raising=False)
    monkeypatch.setenv("CHECKPOINT_PATH", path)
    monkeypatch.setenv("DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("NUM_PROTEINS", "40")
    service = app_main._build_service(device="cpu")
    assert os.path.exists(tmp_path / "protein_target_embeddings.pkl")
    _assert_same_tree(service.params, params)
    assert service.protein_ids == list(range(40))
    with torch.no_grad():
        want = tuni.target_protein_embeddings(params, cfg, table)
    np.testing.assert_allclose(np.asarray(service.all_protein_embeddings),
                               want.numpy(), atol=1e-6, rtol=1e-6)


def test_caption_bulk_loads_a_saved_model(tmp_path, monkeypatch):
    """caption_bulk --checkpoint: the saved model captions the listed
    proteins (the data store stands in for DATA_DIR's)."""
    from procyon_tpu_torch.data import datasets
    from procyon_tpu_torch.scripts import caption_bulk
    path, _, _ = _cpu_model(tmp_path)
    monkeypatch.setattr(datasets, "ProCyonDataStore",
                        lambda: datasets.SyntheticStore(n_proteins=64,
                                                        embed_dim=64))
    ids = tmp_path / "ids.txt"
    ids.write_text("3\n5\n")
    out = tmp_path / "captions.csv"
    caption_bulk.main(["--checkpoint", path, "--protein_ids", str(ids),
                       "--device", "cpu", "--max_new_tokens", "3",
                       "--beam_size", "2", "--beam_group_size", "1",
                       "--out", str(out)])
    rows = out.read_text().strip().splitlines()
    assert rows[0] == "protein_id,caption" and len(rows) == 3
    assert [r.split(",")[0] for r in rows[1:]] == ["3", "5"]
    assert all(r.split(",", 1)[1] for r in rows[1:])
