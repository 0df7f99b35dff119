"""The port's caption entry points on the CPU: the CLI
(`python -m procyon_tpu_torch.scripts.caption_bulk --device cpu
--synthetic`) writes the same CSV on its dense, paged and shared-prefix
backends, and ProcyonCaptionEval gives the JAX wrapper's captions on the
same (bridged) weights, store, tokenizer and task."""

import csv
import dataclasses

import pytest
import torch

from procyon_tpu.data import collators as jC
from procyon_tpu.data.datasets import SyntheticStore as JStore
from procyon_tpu.data.instruct import TaskLibrary as JTaskLibrary
from procyon_tpu.data.text_tokenizer import WordTokenizer as JWordTokenizer
from procyon_tpu.evaluate.procyon_models import \
    ProcyonCaptionEval as JCaptionEval
from procyon_tpu_torch.data import collators as tC
from procyon_tpu_torch.data.datasets import SyntheticStore
from procyon_tpu_torch.data.instruct import TaskLibrary
from procyon_tpu_torch.data.text_tokenizer import WordTokenizer
from procyon_tpu_torch.evaluate.caption import AbstractCaptionModel
from procyon_tpu_torch.evaluate.procyon_models import ProcyonCaptionEval
from procyon_tpu_torch.scripts import caption_bulk
from torch_beam_common import gen_configs, setup_model


def _run_cli(tmp_path, name, *flags):
    out = tmp_path / f"{name}.csv"
    caption_bulk.main(["--synthetic", "--device", "cpu", "--n_proteins", "5",
                       "--batch_size", "2", "--beam_size", "4",
                       "--max_new_tokens", "6", "--out", str(out), *flags])
    with open(out, newline="") as f:
        return list(csv.reader(f))


def test_cli_writes_identical_csvs_on_its_three_backends(tmp_path, capsys):
    dense = _run_cli(tmp_path, "dense")
    paged = _run_cli(tmp_path, "paged", "--paged")
    shared = _run_cli(tmp_path, "shared", "--paged", "--shared_prefix")
    assert dense[0] == ["protein_id", "caption"]
    assert [r[0] for r in dense[1:]] == ["0", "1", "2", "3", "4"]
    assert all(r[1] for r in dense[1:])            # no empty caption
    assert len({r[1] for r in dense[1:]}) > 1      # they differ by protein
    assert paged == dense and shared == dense
    assert "wrote 5 captions" in capsys.readouterr().out
    # sharding: chunk 1 of 2 takes every second protein
    part = _run_cli(tmp_path, "part", "--paged", "--num_chunks", "2",
                    "--chunk_idx", "1")
    assert part[1:] == [dense[2], dense[4]]


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="checkpoint_io"):
        caption_bulk.main(["--checkpoint", "x", "--device", "cpu"])
    with pytest.raises(SystemExit):
        caption_bulk.main(["--synthetic", "--shared_prefix", "--device",
                           "cpu"])
    with pytest.raises(SystemExit):                # the reference's trips
        caption_bulk.main(["--synthetic", "--step_trip", "4"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            caption_bulk.main(["--synthetic", "--n_proteins", "1",
                               "--out", str(tmp_path / "x.csv")])


@pytest.mark.parametrize("mode", ["dense", "paged", "session"])
def test_caption_eval_matches_the_reference_wrapper(mode):
    jcfg, jparams, tcfg, tparams = setup_model(protein_embed_dim=32)
    jtok = JWordTokenizer(jcfg.llama.vocab_size)
    ttok = WordTokenizer(tcfg.llama.vocab_size)
    jg, tg = gen_configs(max_new_tokens=6, method="beam", beam_size=2,
                         beam_group_size=1, diversity_penalty=0.5,
                         eos_token_id=jtok.spec.eos_id,
                         pad_token_id=jtok.spec.pad_id)
    kw = dict(use_paged=mode != "dense", shared_prefix=mode == "session",
              page_size=8, batch_size=2)
    ckw = dict(max_text_len=96, protein_embed_dim=32)
    jmodel = JCaptionEval(
        jparams, jcfg, jtok, JStore(n_proteins=8, n_texts=8, embed_dim=32),
        JTaskLibrary().get("uniprot_all_caption"), gen=jg,
        collator_cfg=jC.CollatorConfig(**ckw), **kw)
    tmodel = ProcyonCaptionEval(
        tparams, tcfg, ttok,
        SyntheticStore(n_proteins=8, n_texts=8, embed_dim=32),
        TaskLibrary().get("uniprot_all_caption"), gen=tg,
        collator_cfg=tC.CollatorConfig(**ckw), device="cpu", **kw)
    assert isinstance(tmodel, AbstractCaptionModel)
    ids = [0, 1, 2]          # a ragged last chunk: the session pads it
    want = jmodel.get_predictions(ids)
    got = tmodel.get_predictions(ids)
    assert got == want and sorted(got) == ids
    if mode == "session":
        assert tmodel._session is not None
        assert tmodel._session.cache.chain         # the template is cached


def test_caption_eval_defaults_and_device_check():
    _, _, tcfg, tparams = setup_model(protein_embed_dim=32)
    tok = WordTokenizer(tcfg.llama.vocab_size)
    store = SyntheticStore(n_proteins=4, n_texts=4, embed_dim=32)
    task = TaskLibrary().get("uniprot_all_caption")
    with pytest.raises(ValueError, match="device"):
        ProcyonCaptionEval(tparams, tcfg, tok, store, task)   # cuda default
    model = ProcyonCaptionEval(tparams, tcfg, tok, store, task, device="cpu")
    g = model.gen                                  # the reference's recipe
    assert (g.method, g.beam_size, g.beam_group_size, g.diversity_penalty,
            g.max_new_tokens) == ("beam", 10, 2, 0.8, 200)
    assert g.eos_token_id == tok.spec.eos_id
    greedy = ProcyonCaptionEval(
        tparams, tcfg, tok, store, task, device="cpu",
        gen=dataclasses.replace(g, method="greedy", max_new_tokens=4),
        collator_cfg=tC.CollatorConfig(max_text_len=96,
                                       protein_embed_dim=32))
    out = greedy.get_predictions([1, 3])
    assert sorted(out) == [1, 3] and all(isinstance(v, str)
                                         for v in out.values())
    with pytest.raises(NotImplementedError):
        AbstractCaptionModel().get_predictions([0])
