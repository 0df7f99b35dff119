"""inference/speculative.py of the port against procyon_tpu's: the host
proposer and the accept rule are numpy on both sides (equal on random
histories), the device drafter is tensor code held to the reference's jnp
function on random [B, H] histories."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import speculative as jspec
from procyon_tpu_torch.inference import speculative as tspec


@pytest.mark.parametrize("history,k,want", [
    ([9, 5, 6, 7, 8, 5, 6, 7], 3, [8, 5, 6]),   # suffix (6, 7) matched at 2
    ([5, 6, 1, 5, 6, 2, 5, 6], 1, [2]),         # the most recent match wins
    ([1, 2, 3, 1, 2], 4, [3, 1, 2, 2]),         # padded with its last
    ([4, 8, 15], 3, [15, 15, 15]),              # no match: the last token
    ([7], 2, [7, 7]),
    ([], 2, [0, 0]),
])
def test_ngram_propose_cases(history, k, want):
    assert tspec.ngram_propose(history, k) == want
    assert jspec.ngram_propose(history, k) == want


@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_equals_reference_on_random_histories(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        hist = list(map(int, rng.integers(0, 4, int(rng.integers(0, 24)))))
        k = int(rng.integers(1, 7))
        kw = dict(n_max=int(rng.integers(1, 5)), n_min=1)
        assert tspec.ngram_propose(hist, k, **kw) \
            == jspec.ngram_propose(hist, k, **kw)


def test_accept_counts_equal_reference():
    draft = np.array([[5, 6, 7], [5, 9, 7], [9, 6, 7]])
    greedy = np.array([[5, 6, 7, 8]] * 3)
    assert list(tspec.accept_counts(draft, greedy)) == [4, 2, 1]
    rng = np.random.default_rng(0)
    draft = rng.integers(0, 4, (64, 5))
    greedy = rng.integers(0, 4, (64, 6))
    np.testing.assert_array_equal(tspec.accept_counts(draft, greedy),
                                  jspec.accept_counts(draft, greedy))


def test_device_ngram_draft_cases():
    hist = np.zeros((4, 12), np.int32)
    hist[0, :8] = [9, 5, 6, 7, 8, 5, 6, 7]   # 2-gram (6, 7) at 2 -> 8, 5, 6
    hist[1, :5] = [5, 6, 1, 5, 6]            # 2-gram (5, 6) at 0 -> 1, 5
    hist[2, :4] = [3, 9, 4, 9]               # 1-gram fallback: 9 -> 4, 9
    hist[3, :2] = [4, 8]                     # no match -> repeat the last
    lens = np.asarray([8, 5, 4, 2], np.int32)
    draft = tspec.device_ngram_draft(torch.from_numpy(hist),
                                     torch.from_numpy(lens), 3)
    assert draft.dtype == torch.int32
    assert draft.tolist() == [[8, 5, 6], [1, 5, 6], [4, 9, 9], [8, 8, 8]]


@pytest.mark.parametrize("seed", range(4))
def test_device_ngram_draft_equals_reference(seed):
    """Random histories over a small alphabet (so that n-grams do repeat),
    with lens 0, 1, 2 and full rows among them. Rows of length 0 return
    garbage by contract and are left out."""
    rng = np.random.default_rng(100 + seed)
    for H, k in ((3, 1), (5, 7), (12, 3), (40, 4)):   # a jit per shape
        B = 64
        hist = rng.integers(0, int(rng.integers(2, 6)), (B, H)).astype(
            np.int32)
        lens = rng.integers(0, H + 1, B).astype(np.int32)
        lens[:5] = (0, 1, 2, H, H - 1)
        want = np.asarray(jspec.device_ngram_draft(
            jnp.asarray(hist), jnp.asarray(lens), k))
        got = tspec.device_ngram_draft(torch.from_numpy(hist),
                                       torch.from_numpy(lens), k).numpy()
        live = lens > 0
        np.testing.assert_array_equal(got[live], want[live])


def test_device_ngram_draft_on_a_column_view():
    """The batcher hands over its history buffer without the spare column:
    a view whose rows are not contiguous."""
    rng = np.random.default_rng(7)
    buf = torch.from_numpy(rng.integers(0, 3, (5, 17)).astype(np.int32))
    lens = torch.tensor([16, 9, 3, 1, 12], dtype=torch.int32)
    view = buf[:, :16]
    assert not view.is_contiguous()
    assert tspec.device_ngram_draft(view, lens, 4).equal(
        tspec.device_ngram_draft(view.contiguous(), lens, 4))
