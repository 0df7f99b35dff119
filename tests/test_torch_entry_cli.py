"""The port's entry() and its disease-phenotype retrieval CLI against the
JAX package on the CPU.

entry(): the same config and example batch as __graft_entry__.entry(),
and on its parameters (bridged, bf16) the forward's logits and retrieval
loss as close to the JAX forward's (both bf16 on the CPU, their sums in
other orders) as the JAX forward is to the same forward in f32. The CLI:
`run` on the reference script's tiny model (its parameters bridged, f32,
the reference attention) ranks the proteins the JAX script prints, with
the same scores within 1e-4."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.llama as jllama
import procyon_tpu.models.unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data import datasets as tdata
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
from procyon_tpu_torch.entry import entry, entry_config, example_batch
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.scripts import protein_retrieval_disease_pheno as cli
from torch_bench_common import ROOT, jax_script
from torch_cpu_common import one_torch_thread  # noqa: F401

def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_reference():
    jfn, (jparams, jbatch) = _graft_entry().entry()
    jlogits, jloss = jax.jit(jfn)(jparams, jbatch)
    fn, (_, batch) = entry("cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]),
                                      err_msg=k)
    tcfg = entry_config()
    assert (tcfg.llama.dim, tcfg.llama.n_heads, tcfg.llama.n_kv_heads,
            tcfg.esm.dim, tcfg.retrieval_dim) == (256, 8, 2, 128, 128)
    params = bridge.to_torch(jparams)
    assert params["llama"]["embed"].dtype == torch.bfloat16
    logits, loss = fn(params, batch)
    got = logits.float().numpy()
    want = np.asarray(jlogits, np.float32)
    assert got.shape == want.shape == (2, 64, 1024)
    # the tolerance: the JAX bf16 forward's own distance from the same
    # forward in f32 (the port's plain path on f32 copies of the weights).
    # Both bf16 runs round every product and sum, so each sits about that
    # far from f32; they agree with each other more closely (logits max /
    # mean 0.50 / 0.021 apart against 1.40 / 0.077, the loss 0.0027
    # against 0.077)
    f32 = dataclasses.replace(
        tcfg, dtype=torch.float32,
        llama=dataclasses.replace(tcfg.llama, dtype=torch.float32),
        esm=dataclasses.replace(tcfg.esm, dtype=torch.float32))
    ref = tuni.forward(bridge.map_tensors(
        lambda t: t.float() if t.is_floating_point() else t, params), f32,
        batch, retrieval=True)
    noise = np.abs(want - ref["logits"].numpy())
    err = np.abs(got - want)
    assert err.max() <= noise.max(), (err.max(), noise.max())
    assert err.mean() <= noise.mean(), (err.mean(), noise.mean())
    assert abs(float(loss) - float(jloss)) <= abs(
        float(jloss) - float(ref["retrieval_loss"]))


def test_example_batch_draws_from_the_callers_rng():
    cfg = entry_config()
    a = example_batch(cfg, B=3, L=16, U=2, rng=np.random.default_rng(9),
                      device="cpu")
    b = example_batch(cfg, B=3, L=16, U=2, rng=np.random.default_rng(9),
                      device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (a["labels"][:, :8] == -100).all()
    assert a["soft_map"][:, 2].tolist() == [0, 1, 0]


def test_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(Exception):
        entry()


def _jax_synthetic_params():
    """The JAX script's --synthetic model and parameters
    (scripts/protein_retrieval_disease_pheno.py:47-58)."""
    jcfg = juni.UnifiedConfig(
        llama=jllama.LlamaConfig(vocab_size=4096, dim=128, n_layers=2,
                                 n_heads=4, n_kv_heads=2, intermediate=256,
                                 max_seq_len=512, dtype=jnp.float32,
                                 attn_backend="ref"),
        esm=None, protein_embed_dim=64, token_projector_layers=2,
        token_projector_hidden=64, retrieval_dim=32, dtype=jnp.float32)
    return jcfg, juni.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("source,desc", [
    ("disgenet", "progressive muscle weakness with elevated CK"),
    ("omim", "early onset cardiomyopathy with conduction defects")])
def test_retrieval_cli_ranks_the_references(monkeypatch, capsys, source,
                                            desc):
    monkeypatch.setattr(sys, "argv", [
        "protein_retrieval_disease_pheno", "--synthetic", "--disease_desc",
        desc, "--instruction_source_dataset", source, "--k", "8"])
    jax_script("protein_retrieval_disease_pheno").main()
    want = json.loads(capsys.readouterr().out)
    jcfg, jparams = _jax_synthetic_params()
    tcfg = cli.synthetic_config("cpu")
    assert (tcfg.llama.dim, tcfg.retrieval_dim, tcfg.llama.attn_backend) \
        == (jcfg.llama.dim, jcfg.retrieval_dim, "ref")
    got = cli.run(bridge.to_torch(jparams), tcfg,
                  load_tokenizer(vocab_size=4096),
                  tdata.SyntheticStore(n_proteins=128, embed_dim=64),
                  list(range(128)), disease_desc=desc,
                  instruction_source_dataset=source, k=8, device="cpu")
    assert [r["protein_id"] for r in got] == \
        [r["protein_id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-4)


def test_retrieval_cli_main_runs_on_the_cpu(capsys, tmp_path):
    path = tmp_path / "desc.txt"
    path.write_text("retinal degeneration with night blindness\n")
    out = cli.main(["--synthetic", "--device", "cpu", "--disease_desc_infile",
                    str(path), "--k", "3"])
    assert json.loads(capsys.readouterr().out) == out
    assert [r["rank"] for r in out] == [1, 2, 3]
    with pytest.raises(SystemExit):
        cli.main(["--synthetic", "--device", "cpu"])
