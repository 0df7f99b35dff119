"""The traffic generator: the same seed gives the same inputs, another seed
other residues and order but the same lengths (the same work)."""

import json

import numpy as np
import pytest

from benchmark.traffic import generator
from conftest import ROOT

MIXES = sorted((ROOT / "benchmark" / "traffic").glob("*.json"))
BIG = 2 ** 31 + 977


def load(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_traffic(path):
    mix = load(path)
    if mix["driver"] == "mlm_lora":
        a, b = generator.mlm_batch(mix, BIG, 4), generator.mlm_batch(
            mix, BIG, 4)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        assert generator.sequences(mix, BIG, 4) == \
            generator.sequences(mix, BIG, 4)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_other_seed_other_traffic_same_lengths(path):
    mix = load(path)
    a, b = generator.sequences(mix, BIG, 1), generator.sequences(
        mix, BIG + 1, 1)
    assert a != b
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert sorted(map(len, a)) == sorted(map(len, generator.sequences(
        mix, BIG, 2)))
    assert set("".join(a)) <= set(generator.ALPHABET)


def test_lengths_follow_the_distribution():
    spec = {"median": 415, "sigma": 0.7, "min": 30, "max": 3000}
    lengths = generator.quantile_lengths(spec, 256)
    assert lengths.min() >= 30 and lengths.max() == 3000
    assert abs(np.median(lengths) - 415) <= 3
    assert 500 < lengths.mean() < 560


def test_mlm_batch_follows_the_bert_rule():
    mix = load(ROOT / "benchmark" / "traffic" / "mlm-lora-l1024.json")
    picked = kept = masked = swapped = residues = 0
    for unit in range(20):
        b = generator.mlm_batch(mix, BIG, unit)
        toks, labels = b["protein_tokens"], b["mlm_labels"]
        assert toks.shape[0] == mix["proteins"]
        assert toks.shape[1] == mix["max_protein_len"] + 2
        sel = labels != -100
        residues += int(((toks >= 4) | (toks == generator.MASK)).sum())
        picked += int(sel.sum())
        masked += int((toks[sel] == generator.MASK).sum())
        kept += int((toks[sel] == labels[sel]).sum())
        swapped += int(((toks[sel] != labels[sel])
                        & (toks[sel] != generator.MASK)).sum())
        assert (labels[~sel] == -100).all()
        assert ((toks[~sel] == generator.MASK).sum()) == 0
    assert abs(picked / residues - 0.15) < 0.01
    assert abs(masked / picked - 0.8) < 0.02
    # a random residue equals the original one time in 20
    assert abs(swapped / picked - 0.1 * 19 / 20) < 0.02
    assert abs(kept / picked - (0.1 + 0.1 / 20)) < 0.02
