"""The port's ContinuousBatcher against procyon_tpu's on the same bridged
weights (f32 on the CPU, greedy): tokens equal request by request, with
equal `waste` and page accounting, in every serving mode without
speculative rounds; the prefill modes against each other, EOS, requests
joining mid-flight and int4 weights. Builders: tests/torch_serving_common.py.
"""

import numpy as np
import pytest

from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_serving_common import (
    make_model, make_int4_model, make_prompts, submit_all, run_both,
    mixed_reqs, PLAIN_MODES, check_tokens_equal_reference)


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture(scope="module")
def int4_model():
    return make_int4_model()


@pytest.mark.parametrize("mode", PLAIN_MODES)
def test_tokens_equal_reference(model, mode):
    check_tokens_equal_reference(model, mode)


def test_chunked_equals_bucketed_and_wave(model):
    """The port's three prefill modes against each other (the chunk
    boundaries and the wave grouping are the reference's)."""
    outs = []
    for kw in ({}, dict(prefill_chunk=4),
               dict(prefill_chunk=4, prefill_batch=3)):
        _, tb = model.batchers(pool=dict(slots=4), **kw)
        rids = submit_all(tb, mixed_reqs(23))
        out = tb.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1] == outs[2]


def test_int4_weights_tokens_equal_reference(int4_model):
    """Every matmul of the decoder on packed int4 leaves (the plain version
    of the kernel on the port's side, the dequantize route on the
    reference's), through plain rounds and speculative rounds."""
    rng = np.random.default_rng(19)
    reqs = [(p, m, {}) for p, m in zip(make_prompts(rng, (6, 19, 4),
                                                    vocab=384),
                                       (7, 5, 9))]
    plain, _, _ = run_both(int4_model, reqs, step_quantum=2)
    spec, _, _ = run_both(int4_model, reqs, spec_k=3)
    assert spec == plain


def test_eos_stops_early(model):
    probe, _, _ = run_both(model, [([5, 6, 7], 1, {})])
    eos = probe[0][0]
    for kw in ({}, dict(step_quantum=2, async_rounds=True)):
        out, _, _ = run_both(model, [([5, 6, 7], 16, dict(eos_id=eos))],
                              **kw)
        assert out[0] == [eos]


def test_churn_mid_flight(model):
    """Requests joining and leaving mid-flight, driven tick by tick on both
    sides with the same arrival schedule."""
    rng = np.random.default_rng(7)
    prompts = make_prompts(rng, (6, 4, 9, 5, 7))
    lens = [4, 9, 3, 6, 5]
    arrive = [0, 0, 2, 3, 6]
    for kw in ({}, dict(step_quantum=2, async_rounds=True)):
        jb, tb = model.batchers(pool=dict(slots=2, n_pages=32), **kw)
        rids = {}
        for tick in range(200):
            for i, at in enumerate(arrive):
                if at == tick:
                    rids[i] = (jb.submit(prompts[i], max_new=lens[i]),
                               tb.submit(prompts[i], max_new=lens[i]))
            jb.tick()
            tb.tick()
            assert sorted(tb.live) == sorted(jb.live)
            assert sorted(tb.done) == sorted(jb.done)
            if len(tb.done) == len(prompts) and not tb._inflight:
                break
        else:
            pytest.fail("the serving loop did not converge")
        for i in range(len(prompts)):
            assert tb.done[rids[i][1]] == jb.done[rids[i][0]]
        assert tb.waste == jb.waste
