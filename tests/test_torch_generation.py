"""inference/generation of the port against procyon_tpu's on the same
parameters (bridged) and the same numpy prompts, f32 on the CPU: greedy
decoding with left-padded prompts and the EOS stop, diverse beam search
(tokens equal, scores within 1e-4), and the selection and nucleus helpers
on seeded arrays. Sampling draws other numbers than jax.random, so it is
held to itself: the same generator state gives the same tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import generation as jgen
from procyon_tpu_torch.inference import generation as tgen
from torch_beam_common import (both, gen_configs, make_soft_batch,
                               setup_model)


@pytest.fixture(scope="module")
def model():
    return setup_model()


def test_greedy_left_padded_prompts_and_eos_stop(model):
    jcfg, jparams, tcfg, tparams = model
    jb, tb = both(make_soft_batch(jcfg, np.random.default_rng(0), B=3, L=12))
    jg, tg = gen_configs(max_new_tokens=11, method="greedy", eos_token_id=2,
                         pad_token_id=0)
    want = np.asarray(jgen.generate(jparams, jcfg, jb, jg))
    got = tgen.generate(tparams, tcfg, tb, tg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # make EOS a token the model emits: rows stop there and pad after it
    eos = int(want[0, 2])
    jg, tg = gen_configs(max_new_tokens=11, method="greedy",
                         eos_token_id=eos, pad_token_id=0)
    want = np.asarray(jgen.generate(jparams, jcfg, jb, jg))
    got = tgen.generate(tparams, tcfg, tb, tg).numpy()
    np.testing.assert_array_equal(got, want)
    stop = int(np.argmax(got[0] == eos))
    assert got[0, stop] == eos and not got[0, stop + 1:].any()


def test_eos_early_stop_leaves_the_loop(model, monkeypatch):
    """Every row done: the loop stops at its next look (every
    EOS_CHECK_EVERY steps) and the tokens are what the full loop gives."""
    jcfg, jparams, tcfg, tparams = model
    _, tb = both(make_soft_batch(jcfg, np.random.default_rng(1), B=2, L=10))
    first = tgen.generate(tparams, tcfg, tb, tgen.GenerationConfig(
        max_new_tokens=1, eos_token_id=2, pad_token_id=0))
    calls = []
    real = tgen._decode_fn
    monkeypatch.setattr(tgen, "_decode_fn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tgen, "EOS_CHECK_EVERY", 4)
    gen = tgen.GenerationConfig(max_new_tokens=20, method="greedy",
                                eos_token_id=int(first[0, 0]),
                                pad_token_id=0)
    tb["input_ids"][1] = tb["input_ids"][0]        # both rows emit it first
    tb["seg_ids"][1] = tb["seg_ids"][0]
    tb["positions"][1] = tb["positions"][0]
    tb["soft_map"][1] = tb["soft_map"][0]
    out = tgen.generate(tparams, tcfg, tb, gen)
    assert len(calls) == 4                         # not 20
    assert (out[:, 0] == gen.eos_token_id).all() and not out[:, 1:].any()


@pytest.mark.parametrize("beam,group,L,ragged", [(4, 2, 12, True),
                                                 (2, 1, 8, False),
                                                 (6, 3, 10, True)])
def test_diverse_beam_matches(model, beam, group, L, ragged):
    jcfg, jparams, tcfg, tparams = model
    jb, tb = both(make_soft_batch(jcfg, np.random.default_rng(beam), B=2,
                                  L=L, ragged=ragged))
    jg, tg = gen_configs(max_new_tokens=8, method="beam", beam_size=beam,
                         beam_group_size=group, diversity_penalty=0.8,
                         eos_token_id=2, pad_token_id=0)
    want_t, want_s = jgen.generate_beam(jparams, jcfg, jb, jg)
    got_t, got_s = tgen.generate_beam(tparams, tcfg, tb, tg)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    assert (np.diff(got_s.numpy(), axis=1) <= 0).all()   # ranked


def test_diverse_beam_select_matches_with_ties_and_finished_beams():
    rng = np.random.default_rng(7)
    B, beam, V = 3, 4, 11
    jg, tg = gen_configs(method="beam", beam_size=beam, beam_group_size=2,
                         diversity_penalty=0.8, eos_token_id=2,
                         pad_token_id=0)
    logits = rng.standard_normal((B, beam, V)).astype(np.float32)
    # exact ties: quantized log-probabilities, equal rows, a flat row
    logits = np.round(logits * 2) / 2
    logits[1, 1] = logits[1, 0]
    logits[2, :2] = 0.0
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    cases = {
        # step 0: the second beam of each group is dead (-1e30), and
        # -1e30 + logp ties at -1e30 for every one of its tokens
        "step0": (np.tile(np.where(np.arange(beam) % 2 == 0, 0.0, -1e30
                                   ).astype(np.float32), (B, 1)),
                  np.zeros((B, beam), bool)),
        "later": (rng.standard_normal((B, beam)).astype(np.float32),
                  rng.random((B, beam)) < 0.4),
        "all done": (np.zeros((B, beam), np.float32),
                     np.ones((B, beam), bool)),
    }
    for name, (scores, done) in cases.items():
        want = jgen.diverse_beam_select(jnp.asarray(logp),
                                        jnp.asarray(scores),
                                        jnp.asarray(done), jg)
        got = tgen.diverse_beam_select(torch.from_numpy(logp),
                                       torch.from_numpy(scores),
                                       torch.from_numpy(done), tg)
        for g, w, what in zip(got, want, ("token", "parent", "score")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       err_msg=f"{name}: {what}")
    # a vocabulary smaller than the group: step 0 must reach into the dead
    # beam's tied candidates, lowest flat index first
    jg1, tg1 = gen_configs(method="beam", beam_size=4, beam_group_size=4,
                           diversity_penalty=0.5, eos_token_id=1,
                           pad_token_id=0)
    logp3 = logp[:, :, :3] - 1.0
    scores0 = np.tile(np.array([0, -1e30, -1e30, -1e30], np.float32), (B, 1))
    done0 = np.zeros((B, beam), bool)
    want = jgen.diverse_beam_select(jnp.asarray(logp3), jnp.asarray(scores0),
                                    jnp.asarray(done0), jg1)
    got = tgen.diverse_beam_select(torch.from_numpy(logp3),
                                   torch.from_numpy(scores0),
                                   torch.from_numpy(done0), tg1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert got[1][0, 3].item() == 1 and got[0][0, 3].item() == 0


def test_nucleus_filter_matches():
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    logits[1, :10] = logits[1, 0]                  # ties at the cutoff
    for top_p in (0.1, 0.5, 0.9, 1.0):
        want = np.asarray(jgen._nucleus_filter(jnp.asarray(logits), top_p))
        got = tgen._nucleus_filter(torch.from_numpy(logits), top_p).numpy()
        if top_p < 1.0:
            np.testing.assert_array_equal(got, want)
        # top_p 1.0 may never be reached in f32: everything is kept
        assert (got > -1e29).sum(-1).min() >= 1
    kept = tgen._nucleus_filter(torch.from_numpy(logits), 1.0)
    assert (kept > -1e29).all()


@pytest.mark.parametrize("method", ["sample", "nucleus"])
def test_sampling_is_deterministic_under_a_generator(model, method):
    jcfg, _, tcfg, tparams = model
    _, tb = both(make_soft_batch(jcfg, np.random.default_rng(2), B=2, L=10))
    gen = tgen.GenerationConfig(max_new_tokens=6, method=method,
                                temperature=0.8, top_p=0.7, eos_token_id=2,
                                pad_token_id=0)

    def run(seed):
        rng = torch.Generator()
        rng.manual_seed(seed)
        return tgen.generate(tparams, tcfg, tb, gen, rng=rng)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(tgen.generate(tparams, tcfg, tb, gen),
                       tgen.generate(tparams, tcfg, tb, gen))   # seed 0
    assert a.min() >= 0 and a.max() < tcfg.llama.vocab_size
