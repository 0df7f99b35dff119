"""procyon_tpu_torch's evaluation metrics (numpy only) against
scikit-learn's and procyon_tpu's on the same seeded inputs.

The port computes AUROC and average precision itself (the card's machine
has no scikit-learn): `roc_auc` by the trapezoid over distinct thresholds
(Mann-Whitney with ties counted one half), `average_precision` as the step
sum over distinct thresholds, each held here to scikit-learn within 1e-12
on random scores, scores rounded to 3 distinct values, all-tied scores and
one positive. Every other metric is a copy of the JAX package's and must
give its values, NaN leak masks included, within 1e-12.
"""

import numpy as np
import pytest
from sklearn import metrics as skm

from procyon_tpu.evaluate import metrics as jm
from procyon_tpu_torch.evaluate import metrics as tm

TOL = 1e-12


def _binary_case(kind, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 120))
    y = (rng.random(n) < 0.3).astype(float)
    y[0], y[1] = 1.0, 0.0
    s = rng.standard_normal(n)
    if kind == "ties":
        s = np.round(rng.random(n) * 2) / 2          # 3 distinct values
    elif kind == "all_tied":
        s = np.full(n, 0.25)
    elif kind == "one_positive":
        y[:] = 0.0
        y[int(rng.integers(0, n))] = 1.0
    return y, s


CASES = [(kind, seed) for kind in ("random", "ties", "all_tied",
                                    "one_positive") for seed in range(3)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_roc_auc_matches_sklearn(kind, seed):
    y, s = _binary_case(kind, seed)
    assert tm.roc_auc(y, s) == pytest.approx(skm.roc_auc_score(y, s),
                                             abs=TOL)


@pytest.mark.parametrize("kind,seed", CASES)
def test_average_precision_matches_sklearn(kind, seed):
    y, s = _binary_case(kind, seed)
    assert tm.average_precision(y, s) == pytest.approx(
        skm.average_precision_score(y, s), abs=TOL)


def test_tie_rules_by_hand():
    """AUROC counts a tied (positive, negative) pair one half; AP takes a
    tied block's precision once, at its end (no interpolation)."""
    y = np.array([1, 0, 1, 0])
    s = np.array([0.9, 0.5, 0.5, 0.1])
    # pairs: (0.9 > 0.5), (0.9 > 0.1), (0.5 = 0.5) -> 1/2, (0.5 > 0.1)
    assert tm.roc_auc(y, s) == pytest.approx(3.5 / 4, abs=TOL)
    # thresholds 0.9 (R 1/2, P 1), 0.5 (R 1, P 2/3)
    assert tm.average_precision(y, s) == pytest.approx(
        0.5 * 1 + 0.5 * 2 / 3, abs=TOL)
    with pytest.raises(ValueError):
        tm.roc_auc(np.ones(3), np.arange(3.0))
    with pytest.raises(ValueError):
        tm.average_precision(np.zeros(3), np.arange(3.0))


def _label_matrix(seed, Q=7, T=40, ties=False):
    """[Q, T] labels with NaN leak masks (a whole row masked, a row with
    no positive, a row with only positives left) and scores."""
    rng = np.random.default_rng(seed)
    labels = (rng.random((Q, T)) < 0.15).astype(np.float32)
    labels[:, 0] = 1.0
    labels[rng.random((Q, T)) < 0.1] = np.nan
    labels[1] = np.nan                      # every pair leaked
    labels[2] = np.where(np.isnan(labels[2]), np.nan, 0.0)  # no positive
    labels[3, 1:] = np.nan                  # one valid pair, a positive
    scores = rng.standard_normal((Q, T)).astype(np.float32)
    if ties:
        scores = np.round(scores).astype(np.float32)
    return labels, scores


MATRICES = [(seed, ties) for seed in range(3) for ties in (False, True)]


@pytest.mark.parametrize("seed,ties", MATRICES)
def test_fmax_matches_reference(seed, ties):
    labels, scores = _label_matrix(seed, ties=ties)
    got = tm.fmax_score(labels, scores)
    want = jm.fmax_score(labels, scores)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_fmax_of_nothing_valid():
    labels = np.full((2, 3), np.nan, np.float32)
    assert tm.fmax_score(labels, np.zeros((2, 3))) \
        == jm.fmax_score(labels, np.zeros((2, 3))) == (0.0, 0.0)


@pytest.mark.parametrize("k", [1, 5, 20, 100])
@pytest.mark.parametrize("seed,ties", MATRICES)
def test_precision_recall_topk_matches_reference(seed, ties, k):
    labels, scores = _label_matrix(seed, ties=ties)
    assert tm.precision_recall_topk(labels, scores, k) == pytest.approx(
        jm.precision_recall_topk(labels, scores, k), abs=TOL)
    got = tm.precision_recall_topk(labels, scores, k, per_query=True)
    want = jm.precision_recall_topk(labels, scores, k, per_query=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed,ties", MATRICES)
def test_per_query_auroc_auprc_matches_reference(seed, ties):
    labels, scores = _label_matrix(seed, ties=ties)
    np.testing.assert_allclose(tm.per_query_auroc_auprc(labels, scores),
                               jm.per_query_auroc_auprc(labels, scores),
                               atol=TOL, rtol=0)


def test_per_query_auroc_auprc_without_a_scorable_query():
    labels = np.zeros((2, 4), np.float32)
    assert all(np.isnan(tm.per_query_auroc_auprc(labels, np.ones((2, 4)))))


@pytest.mark.parametrize("seed,ties", MATRICES)
def test_class_balanced_resample_matches_reference(seed, ties):
    labels, scores = _label_matrix(seed, ties=ties)
    kw = dict(n_samples=4, neg_per_pos=3, seed=seed)
    np.testing.assert_allclose(
        tm.class_balanced_resample_metrics(labels, scores, **kw),
        jm.class_balanced_resample_metrics(labels, scores, **kw),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("n_pos,n_neg,ties", [(5, 30, False), (5, 30, True),
                                              (1, 9, False), (4, 0, False)])
def test_auroc_auprc_from_scores_matches_reference(n_pos, n_neg, ties):
    rng = np.random.default_rng(n_pos + n_neg)
    pos, neg = rng.standard_normal(n_pos) + 0.5, rng.standard_normal(n_neg)
    if ties:
        pos, neg = np.round(pos), np.round(neg)
    got = tm.auroc_auprc_from_scores(pos, neg)
    want = jm.auroc_auprc_from_scores(pos, neg)
    if n_neg == 0:
        assert all(np.isnan(got)) and all(np.isnan(want))
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_boot,alpha", [(50, 0.05), (200, 0.1)])
def test_bootstrap_ci_matches_reference(n_boot, alpha):
    v = np.random.default_rng(n_boot).random(25)
    v[3] = np.nan
    assert tm.bootstrap_ci(v, n_boot=n_boot, alpha=alpha) \
        == jm.bootstrap_ci(v, n_boot=n_boot, alpha=alpha)


CAPTIONS = [
    ("the protein binds atp", ["the protein binds atp"]),
    ("the protein binds atp", ["a kinase that binds atp in the cytosol",
                               "binds atp"]),
    ("kinase kinase kinase", ["a kinase", "kinase activity of the kinase"]),
    ("unrelated words here", ["the protein binds atp"]),
    ("", ["the protein binds atp"]),
    ("short", "a single reference string, not a list"),
    ("membrane transport of ions across the membrane",
     ["transport of ions", "ion channel in the membrane, transport"]),
]


@pytest.mark.parametrize("cand,refs", CAPTIONS)
def test_rouge_l_and_bleu_match_reference(cand, refs):
    assert tm.rouge_l(cand, refs) == jm.rouge_l(cand, refs)
    assert tm.bleu(cand, refs) == jm.bleu(cand, refs)
    assert tm._lcs_len(cand.split(), refs[0].split()) \
        == jm._lcs_len(cand.split(), refs[0].split())
