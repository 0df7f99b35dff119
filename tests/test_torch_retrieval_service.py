"""procyon_tpu_torch's /retrieve path (prompt -> collator batch -> fusion
model -> lm projector -> cosine top-k, and the HTTP server in front of it)
against procyon_tpu's on the tiny synthetic config of
tests/test_aux.py::TestPerturbationCI, on the CPU in f32.

The host code (tokenizer, task library, collators, store) is a copy, so its
arrays are held to the reference's exactly. Scores agree to 1e-5: cosines
of f32 embeddings that agree to about 1e-6.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jdatasets
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu.inference import prompts as jprompts
from procyon_tpu.inference.retrieval_service import \
    startup_retrieval as jstartup
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.app import main as tmain
from procyon_tpu_torch.app import server as tserver
from procyon_tpu_torch.data import collators as tC
from procyon_tpu_torch.data import datasets as tdatasets
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data.text_tokenizer import \
    load_tokenizer as tload_tokenizer
from procyon_tpu_torch.inference import prompts as tprompts
from procyon_tpu_torch.inference.retrieval_service import \
    startup_retrieval as tstartup
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import unified as tuni

DESC = "progressive neurological decline with seizures"
N = 32


def _services():
    jcfg = juni.UnifiedConfig(
        llama=jllama.tiny_config(vocab_size=4096, attn_backend="ref",
                                 remat=False),
        esm=None, protein_embed_dim=32, token_projector_layers=1,
        token_projector_hidden=32, retrieval_dim=16, dtype=jnp.float32)
    tcfg = tuni.UnifiedConfig(
        llama=tllama.tiny_config(vocab_size=4096),
        esm=None, protein_embed_dim=32, token_projector_layers=1,
        token_projector_hidden=32, retrieval_dim=16, dtype=torch.float32)
    params = juni.init_params(jax.random.PRNGKey(0), jcfg)
    jsvc = jstartup(params, jcfg, jload_tokenizer(vocab_size=4096),
                    jdatasets.SyntheticStore(n_proteins=N, embed_dim=32),
                    list(range(N)))
    tsvc = tstartup(bridge.to_torch(params), tcfg,
                    tload_tokenizer(vocab_size=4096),
                    tdatasets.SyntheticStore(n_proteins=N, embed_dim=32),
                    list(range(N)), device="cpu")
    return jsvc, tsvc


@pytest.fixture(scope="module")
def services():
    return _services()


@pytest.mark.parametrize("task_id", ["disgenet_all_retrieval",
                                     "omim_all_retrieval"])
def test_collator_batches_are_the_references(task_id):
    store_j = jdatasets.SyntheticStore(n_proteins=N, embed_dim=32)
    store_t = tdatasets.SyntheticStore(n_proteins=N, embed_dim=32)
    want = jprompts.create_input_retrieval(
        task_id, tokenizer=jload_tokenizer(vocab_size=4096), store=store_j,
        input_description=DESC,
        collator_cfg=jC.CollatorConfig(protein_embed_dim=32))
    got = tprompts.create_input_retrieval(
        task_id, tokenizer=tload_tokenizer(vocab_size=4096), store=store_t,
        input_description=DESC,
        collator_cfg=tC.CollatorConfig(protein_embed_dim=32))
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "reference_indices":
            assert got[key] == val
        else:
            assert got[key].dtype == val.dtype, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert got["input_ids"].shape == (1, 512)


def test_qa_and_merged_batches_are_the_references():
    store_j = jdatasets.SyntheticStore(n_proteins=N, embed_dim=32)
    store_t = tdatasets.SyntheticStore(n_proteins=N, embed_dim=32)
    jtok, ttok = jload_tokenizer(vocab_size=4096), \
        tload_tokenizer(vocab_size=4096)
    jcc = jC.CollatorConfig(protein_embed_dim=32)
    tcc = tC.CollatorConfig(protein_embed_dim=32)
    want = [jprompts.create_qa_input_simple(
        "disgenet_all_qa", i, tokenizer=jtok, store=store_j,
        collator_cfg=jcc, input_description=DESC) for i in (3, 5)]
    got = [tprompts.create_qa_input_simple(
        "disgenet_all_qa", i, tokenizer=ttok, store=store_t,
        collator_cfg=tcc, input_description=DESC) for i in (3, 5)]
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key, val in w.items():
            np.testing.assert_array_equal(g[key], val, err_msg=key)
    # the reference's merge stops at a QA batch's 0-d yes_token / no_token
    # (np.concatenate refuses them); the port's copy keeps the one value
    with pytest.raises(ValueError, match="zero-dimensional"):
        jprompts.merge_model_input_dicts(want)
    merged = tprompts.merge_model_input_dicts(got)
    assert merged["input_ids"].shape == (2, 512)
    assert merged["protein_embeds"].shape[0] == sum(
        g["protein_embeds"].shape[0] for g in got)
    assert int(merged["yes_token"]) == int(got[0]["yes_token"])
    # retrieval batches merge alike on both sides
    jr = [jprompts.create_input_retrieval(
        "omim_all_retrieval", tokenizer=jtok, store=store_j,
        input_description=d, collator_cfg=jcc) for d in (DESC, "ataxia")]
    tr = [tprompts.create_input_retrieval(
        "omim_all_retrieval", tokenizer=ttok, store=store_t,
        input_description=d, collator_cfg=tcc) for d in (DESC, "ataxia")]
    jm = jprompts.merge_model_input_dicts(jr)
    tm = tprompts.merge_model_input_dicts(tr)
    assert set(jm) == set(tm)
    for key, val in jm.items():
        np.testing.assert_array_equal(tm[key], val, err_msg=key)
    assert tinstruct.TaskLibrary().available() == \
        jinstruct.TaskLibrary().available()
    rng_j, rng_t = (np.random.default_rng(0) for _ in range(2))
    assert tprompts.perturb_description(DESC, rng_t) == \
        jprompts.perturb_description(DESC, rng_j)


def test_retrieve_matches_reference(services):
    jsvc, tsvc = services
    np.testing.assert_allclose(tsvc.all_protein_embeddings,
                               jsvc.all_protein_embeddings, atol=1e-5)
    for task_id in ("disgenet_all_retrieval", "omim_all_retrieval"):
        want = jsvc.retrieve(task_id=task_id, disease_desc=DESC, k=5)
        got = tsvc.retrieve(task_id=task_id, disease_desc=DESC, k=5)
        assert [r["protein_id"] for r in got] == \
            [r["protein_id"] for r in want]
        assert [r["rank"] for r in got] == [1, 2, 3, 4, 5]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=1e-5)
    stab = tprompts.retrieval_rank_stability(
        tsvc, task_id="disgenet_all_retrieval", description=DESC, k=5,
        n_variants=2)
    assert 0.0 <= stab["mean_jaccard"] <= 1.0
    batched = tprompts.get_proteins_from_batched_embeddings(
        tsvc.all_protein_embeddings, tsvc.all_protein_embeddings[:2],
        top_k=1)
    assert [b[0]["protein_id"] for b in batched] == [0, 1]


def test_embedding_cache_round_trip(services, tmp_path):
    from procyon_tpu_torch.inference.retrieval_service import \
        build_all_protein_embeddings
    _, tsvc = services
    path = str(tmp_path / "cache" / "protein_target_embeddings.pkl")
    first = build_all_protein_embeddings(
        tsvc.params, tsvc.cfg, tsvc.store, tsvc.protein_ids, device="cpu",
        cache_path=path, batch_size=7)
    np.testing.assert_allclose(first, tsvc.all_protein_embeddings, atol=1e-6)
    again = build_all_protein_embeddings(
        tsvc.params, tsvc.cfg, None, tsvc.protein_ids, device="cpu",
        cache_path=path)
    np.testing.assert_array_equal(first, again)


def _request(port, path, payload=None, raw=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_on_cpu(services):
    _, tsvc = services
    httpd = tserver.serve(tsvc, 0, host="127.0.0.1", background=True)
    try:
        port = httpd.server_address[1]
        assert _request(port, "/healthz") == (200, {"ok": True})
        code, body = _request(port, "/retrieve", {
            "disease_desc": DESC, "instruction_source_dataset": "omim",
            "k": 3})
        assert code == 200
        direct = tsvc.retrieve(task_id="omim_all_retrieval",
                               disease_desc=DESC, k=3)
        assert body["results"] == direct
        assert _request(port, "/retrieve", {"k": 3})[0] == 422
        assert _request(port, "/retrieve", {
            "disease_desc": DESC,
            "instruction_source_dataset": "uniprot"})[0] == 422
        assert _request(port, "/retrieve", raw=b"{not json")[0] == 400
        assert _request(port, "/nowhere")[0] == 404
        assert _request(port, "/nowhere", {})[0] == 404
        assert _request(port, "/generate", {"tokens": [1, 2]})[0] == 503
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_entry_points_do_not_fall_to_the_cpu(services, monkeypatch):
    _, tsvc = services
    with pytest.raises(ValueError, match="device"):
        tstartup(tsvc.params, tsvc.cfg, tsvc.tokenizer, tsvc.store,
                 tsvc.protein_ids)               # device defaults to cuda
    monkeypatch.delenv("PROCYON_SYNTHETIC", raising=False)
    with pytest.raises(RuntimeError, match="PROCYON_SYNTHETIC"):
        tmain._build_service(device="cpu")
    cfg = tmain.procyon_full_config()
    assert (cfg.llama.dim, cfg.llama.n_layers, cfg.llama.n_kv_heads,
            cfg.llama.vocab_size) == (4096, 32, 8, 128256)
    pc = tuni.projector_configs(cfg)
    assert (pc["token_projector"].n_layers,
            pc["token_projector"].hidden_dim,
            pc["lm_projector"].out_dim) == (3, 2560, 1024)
    if not torch.cuda.is_available():
        monkeypatch.setenv("PROCYON_SYNTHETIC", "1")
        with pytest.raises((RuntimeError, AssertionError)):
            tmain._build_service()               # no card: raises
