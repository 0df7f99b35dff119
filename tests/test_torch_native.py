"""procyon_tpu_torch.native (its own copy of the C++ data-path library, built
with g++ into build/procyon_tpu_torch/) against procyon_tpu.native, bit for
bit: batch tokenization with chunk splitting or truncation, MLM masking,
the FASTA offset index and the records read through it; the pure-python
fallbacks against the native route; ProCyonDataStore's sequences and the
live-encoder collator branch through the index and the native encoder; and
the JAX package's tracked native/ left as it was when the port builds.
"""

import os

import numpy as np
import pytest

from procyon_tpu import native as jnative
from procyon_tpu.data import collators as jC
from procyon_tpu.data import datasets as jD
from procyon_tpu.data import instruct as jinstruct
from procyon_tpu.data.text_tokenizer import load_tokenizer as jload_tokenizer
from procyon_tpu_torch import native as tnative
from procyon_tpu_torch.data import collators as tC
from procyon_tpu_torch.data import datasets as tD
from procyon_tpu_torch.data import instruct as tinstruct
from procyon_tpu_torch.data import protein_tokenizer as tpt
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")

SEQS = ["MKVLA", "GG", "A" * 25, "mkvlaXBZ*J", "", "LAGVSERTIDPKQNFYMHWC" * 3]
# the python tokenizer gives an empty sequence a [cls, eos] row and the
# native one no row (both packages alike): the fallback is compared on the
# rest
NONEMPTY = [s for s in SEQS if s]


@pytest.fixture(scope="module", autouse=True)
def libs():
    assert tnative.available(), "g++ is present here: the port must build"
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")


def _fasta(path, rng, n=40, width=60, crlf=False):
    """n records of 1-300 residues, wrapped at `width`, with headers of
    several words; returns the sequences."""
    nl = "\r\n" if crlf else "\n"
    seqs = []
    with open(path, "w", newline="") as f:
        for i in range(n):
            s = "".join(rng.choice(list("LAGVSERTIDPKQNFYMHWC"),
                                   int(rng.integers(1, 300))))
            seqs.append(s)
            f.write(f">sp|P{i:05d}|PROT_{i} protein {i} OS=synthetic{nl}")
            for j in range(0, len(s), width):
                f.write(s[j:j + width] + nl)
    return seqs


@pytest.mark.parametrize("max_len,strategy,pad_rows", [
    (10, "split", 0), (10, "truncate", 0), (1024, "split", 0),
    (7, "split", 12)])
def test_batch_encode_matches_reference(max_len, strategy, pad_rows):
    want = jnative.batch_encode(SEQS, max_len=max_len, long_strategy=strategy,
                                pad_rows_to=pad_rows)
    got = tnative.batch_encode(SEQS, max_len=max_len, long_strategy=strategy,
                               pad_rows_to=pad_rows)
    for f in ("tokens", "group_ids", "row_valid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.num_groups == want.num_groups


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_mask_for_mlm_matches_reference(seed):
    toks = tnative.batch_encode(SEQS * 4, max_len=20).tokens
    for prob in (0.15, 0.5):
        got = tnative.mask_for_mlm(toks, seed, mask_prob=prob)
        want = jnative.mask_for_mlm(toks, seed, mask_prob=prob)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("crlf", [False, True])
def test_fasta_index_matches_reference(tmp_path, crlf):
    path = str(tmp_path / "x.fa")
    seqs = _fasta(path, np.random.default_rng(1), crlf=crlf)
    got, want = tnative.FastaIndex(path), jnative.FastaIndex(path)
    assert len(got) == len(want) == len(seqs)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    for i in range(len(seqs)):
        assert got.get(i) == want.get(i) == seqs[i]
    assert got.get(3, max_len=11) == want.get(3, max_len=11)
    with pytest.raises(FileNotFoundError):
        tnative.FastaIndex(str(tmp_path / "missing.fa"))


def test_fallbacks_match_the_native_route(tmp_path, monkeypatch):
    """Without the library (no g++): batch_encode and the FASTA index give
    the native route's arrays and records; the masking draws another
    stream with the same rules."""
    path = str(tmp_path / "x.fa")
    _fasta(path, np.random.default_rng(2), n=15)
    nat_b = tnative.batch_encode(NONEMPTY, max_len=10)
    nat_idx = tnative.FastaIndex(path)
    toks = tnative.batch_encode(SEQS * 8, max_len=20).tokens
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert not tnative.available()
    py_b = tnative.batch_encode(NONEMPTY, max_len=10)
    for f in ("tokens", "group_ids", "row_valid"):
        np.testing.assert_array_equal(getattr(py_b, f), getattr(nat_b, f))
    py_idx = tnative.FastaIndex(path)
    np.testing.assert_array_equal(py_idx.offsets, nat_idx.offsets)
    assert [py_idx.get(i) for i in range(15)] \
        == [nat_idx.get(i) for i in range(15)]
    masked, labels = tnative.mask_for_mlm(toks, 5)
    sel = labels != -100
    special = np.isin(toks, [tpt.PAD_IDX, tpt.CLS_IDX, tpt.EOS_IDX])
    assert sel.any() and not (sel & special).any()
    assert (masked[~sel] == toks[~sel]).all()
    assert (labels[sel] == toks[sel]).all()


def test_datastore_reads_sequences_through_the_index(tmp_path):
    """ProCyonDataStore.protein_sequence over a DATA_DIR layout: the
    reference store's records."""
    d = tmp_path / "integrated_data" / "v1" / "protein"
    d.mkdir(parents=True)
    seqs = _fasta(str(d / "protein_sequences.fa"), np.random.default_rng(3))
    got = tD.ProCyonDataStore(str(tmp_path))
    want = jD.ProCyonDataStore(str(tmp_path))
    for i in (0, 5, 39):
        assert got.protein_sequence(i) == want.protein_sequence(i) == seqs[i]
    assert isinstance(got._seqs, tnative.FastaIndex)


def test_live_encoder_collator_matches_reference():
    """A QA batch with use_protein_tokens: protein token rows (long
    proteins split into chunk rows, padded to max_protein_rows) from
    native.batch_encode, the reference collator's arrays."""
    store = jD.SyntheticStore(n_proteins=16, embed_dim=8, min_len=20,
                              max_len=60)
    tstore = tD.SyntheticStore(n_proteins=16, embed_dim=8, min_len=20,
                               max_len=60)
    kw = dict(max_text_len=96, protein_embed_dim=8, use_protein_tokens=True,
              max_protein_len=24, max_protein_rows=16)
    samples = [(1, 2, True), (3, 4, False), (5, 2, True)]
    jtask = jinstruct.TaskLibrary().get("disgenet_all_qa")
    ttask = tinstruct.TaskLibrary().get("disgenet_all_qa")
    want = jC.QACollator(jC.CollatorConfig(**kw), jload_tokenizer(
        vocab_size=512), store, jtask)(
        samples, jinstruct.get_prompt(jtask, num_examples=1))
    got = tC.QACollator(tC.CollatorConfig(**kw), load_tokenizer(
        vocab_size=512), tstore, ttask)(
        samples, tinstruct.get_prompt(ttask, num_examples=1))
    for k in ("protein_tokens", "protein_group_ids", "protein_row_valid",
              "input_ids", "soft_map"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert got["protein_tokens"].shape[0] == 16


def test_port_builds_its_own_library_and_leaves_native_alone(tmp_path,
                                                              monkeypatch):
    """A fresh build of the port's library (into a scratch build
    directory) reads and writes nothing under the JAX package's native/:
    every file there keeps its bytes and its mtime."""
    before = {n: (open(os.path.join(NATIVE_DIR, n), "rb").read(),
                  os.stat(os.path.join(NATIVE_DIR, n)).st_mtime_ns)
              for n in os.listdir(NATIVE_DIR)}
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.available()
    so = tnative.library_path()
    assert so.exists() and so.parent == tmp_path / "build"
    assert so.name.startswith("procyon_native-")
    got = tnative.batch_encode(SEQS, max_len=10)
    np.testing.assert_array_equal(
        got.tokens, jnative.batch_encode(SEQS, max_len=10).tokens)
    after = {n: (open(os.path.join(NATIVE_DIR, n), "rb").read(),
                 os.stat(os.path.join(NATIVE_DIR, n)).st_mtime_ns)
             for n in os.listdir(NATIVE_DIR)}
    assert after == before
