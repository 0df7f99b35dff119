"""The port's speculative serving against procyon_tpu's on the same bridged
weights (f32 on the CPU, greedy): tokens equal request by request, with
equal `spec_stats`, in every mode with `spec_k`; EOS inside an accepted
draft, drafts that are always right or always wrong, and sampled
acceptance against the drafted token's probability. Builders:
tests/torch_serving_common.py."""

import pytest

from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_serving_common import (
    make_model, make_small_vocab, run_both, SPEC_MODES,
    check_tokens_equal_reference, TEMP)


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def small_vocab():
    return make_small_vocab()


@pytest.mark.parametrize("mode", SPEC_MODES)
def test_tokens_equal_reference(model, mode):
    check_tokens_equal_reference(model, mode)


@pytest.mark.parametrize("kw", [dict(spec_k=4),
                                dict(spec_k=2, spec_quantum=3)],
                         ids=["round", "trip"])
def test_spec_eos_mid_accept(model, kw):
    plain, _, _ = run_both(model, [([5, 6, 7], 10, {})])
    eos = plain[0][3]
    want = plain[0][:plain[0].index(eos) + 1]
    out, _, _ = run_both(model, [([5, 6, 7], 10, dict(eos_id=eos))], **kw)
    assert out[0] == want


def test_oracle_drafts_accept_in_full(model):
    """A per-request draft_fn that proposes the true continuation: every
    verify round accepts all K+1 tokens; an always-wrong one emits exactly
    one a round. Both equal plain greedy."""
    prompt = [5, 9, 13, 21]
    plain, _, _ = run_both(model, [(prompt, 13, {})])
    G = plain[0]

    def true_oracle(history, k, **kw):
        e = len(history) - len(prompt)
        return (G[e:e + k] + [0] * k)[:k]

    def wrong_oracle(history, k, **kw):
        return [(t + 1) % 256 for t in true_oracle(history, k)]

    out, _, tb = run_both(model, [(prompt, 13, dict(draft_fn=true_oracle))],
                           spec_k=3)
    assert out[0] == G and tb.spec_stats == {"rounds": 3, "emitted": 12}
    out, _, tb = run_both(model,
                           [(prompt, 13, dict(draft_fn=wrong_oracle))],
                           spec_k=3)
    assert out[0] == G and tb.spec_stats == {"rounds": 12, "emitted": 12}


def test_sampled_acceptance_tracks_draft_probability(small_vocab):
    """Acceptance equals the model's probability of the drafted token (not
    0, not 1): constant drafts over the 8 tokens average to about 1/8."""
    pair = small_vocab
    _, tb = pair.batchers(pool=dict(slots=1), spec_k=4, temperature=TEMP)
    rounds = emitted = 0
    for i in range(300):
        tb.reset(seed=60_000 + i)
        d = i % pair.tcfg.vocab_size
        tb.submit([5, 1, 6, 2, 7], max_new=12,
                  draft_fn=lambda h, k, d=d, **_: [d] * k)
        tb.run()
        rounds += tb.spec_stats["rounds"]
        emitted += tb.spec_stats["emitted"]
    acc = emitted / rounds
    assert 1.02 < acc < 2.5, acc
