"""inference/paged_beam of the port against procyon_tpu's paged path, the
port's own dense path and the reference's dense path, on the same
parameters (bridged) and the same numpy prompts, f32 on the CPU (mirrors
tests/test_paged_beam.py: TestPagedBeamParity, TestSharedPrefix,
TestBeamSession, TestCascadeDecode).

Tokens are equal and scores agree to 1e-4. The port's default backend
moves pages through ops/page_move, whose plain version refuses a source
that is also a destination: every run here is a test of the ping-pong page
plan as well."""

import dataclasses

import numpy as np
import pytest
import torch

from procyon_tpu.inference import generation as jgen
from procyon_tpu.inference import paged_beam as jpb
from procyon_tpu_torch.inference import generation as tgen
from procyon_tpu_torch.inference import paged_beam as tpb
from procyon_tpu_torch.ops import page_move
from torch_beam_common import (both, gen_configs, make_shared_batch,
                               make_soft_batch, setup_model)


@pytest.fixture(scope="module")
def model():
    return setup_model()


def _gens(max_new=7, beam=4, group=2, penalty=0.8):
    return gen_configs(max_new_tokens=max_new, method="beam", beam_size=beam,
                       beam_group_size=group, diversity_penalty=penalty,
                       eos_token_id=2, pad_token_id=0)


def _kernel_backend(tcfg):
    """The port's default backend: wrappers (their plain versions on CPU
    tensors) instead of the CPU reference forms."""
    return dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, attn_backend=None))


def _assert_same(got, want, score_tol=1e-4):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=score_tol)


@pytest.mark.parametrize("page_size,L,ragged", [
    (4, 12, True), (8, 12, True), (16, 12, True),
    (8, 8, False),      # prompt exactly page-aligned: no partial page copy
])
def test_tokens_match_reference_paged_and_dense(model, page_size, L, ragged):
    jcfg, jparams, tcfg, tparams = model
    batch = make_soft_batch(jcfg, np.random.default_rng(page_size + L),
                            B=2, L=L, ragged=ragged)
    jb, tb = both(batch)
    jg, tg = _gens(max_new=9)
    dense = tgen.generate_beam(tparams, tcfg, tb, tg)
    _assert_same(dense, jgen.generate_beam(jparams, jcfg, jb, jg))
    want = jpb.paged_beam_generate(jparams, jcfg, jb, jg,
                                   page_size=page_size)
    _assert_same(tpb.paged_beam_generate(tparams, tcfg, batch, tg,
                                         page_size=page_size), want)
    _assert_same(dense, want)
    # the default backend: page moves through ops/page_move, the cascade on
    n0 = page_move.launches
    _assert_same(tpb.paged_beam_generate(tparams, _kernel_backend(tcfg), tb,
                                         tg, page_size=page_size), want)
    assert page_move.launches == n0               # CPU tensors: no kernel


def test_shared_prefix_matches(model):
    jcfg, jparams, tcfg, tparams = model
    batch = make_shared_batch(jcfg, np.random.default_rng(1),
                              tails=[3, 6, 2], S=9)
    jb, tb = both(batch)
    jg, tg = _gens()
    want = jpb.paged_beam_generate(jparams, jcfg, jb, jg, page_size=4,
                                   shared_prefix=True)
    _assert_same(tgen.generate_beam(tparams, tcfg, tb, tg), want)
    for cfg in (tcfg, _kernel_backend(tcfg)):
        _assert_same(tpb.paged_beam_generate(tparams, cfg, batch, tg,
                                             page_size=4,
                                             shared_prefix=True), want)
    # the dedup saved the aliased pages and made dependent rows wait
    _, ctx_p = tpb.paged_beam_init(tparams, tcfg, batch, tg, page_size=4)
    _, ctx_s = tpb.paged_beam_init(tparams, tcfg, batch, tg, page_size=4,
                                   shared_prefix=True)
    _, jctx_s = jpb.paged_beam_init(jparams, jcfg, jb, jg, page_size=4,
                                    shared_prefix=True)
    assert ctx_s["pcfg"].n_pages == jctx_s["pcfg"].n_pages
    assert ctx_p["pcfg"].n_pages - ctx_s["pcfg"].n_pages == 4
    np.testing.assert_array_equal(ctx_s["start"], jctx_s["start"])
    np.testing.assert_array_equal(ctx_s["wave"], [0, 1, 1])


def test_shared_plan_dedups_and_waves():
    """Unit (after the reference's test_plan_dedups_and_waves): the same
    plan from the same digests in both packages."""
    P = 4
    d = [bytes([i]) * 16 for i in range(6)]
    digests = [[d[0], d[1], d[2]], [d[0], d[1], d[2]], [d[0], d[1], d[5]],
               [d[3]]]
    lens = [16, 16, 16, 8]
    got = tpb._shared_prompt_plan(lens, P, digests)
    want = jpb._shared_prompt_plan(lens, P, digests)
    for name in ("pages", "start", "wave"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert (got.n_prompt, got.novel, got.hit_pages) \
        == (want.n_prompt, want.novel, want.hit_pages)
    np.testing.assert_array_equal(got.start, [0, 12, 8, 0])
    np.testing.assert_array_equal(got.wave, [0, 1, 1, 0])
    jcfg, _, tcfg, _ = setup_model()
    for kw in (dict(), dict(quantize_kv=True, n_prompt_pages=3)):
        a = tpb.plan_pool_config(tcfg.llama, [13, 7], 4, 9, page_size=4,
                                 **kw)
        b = jpb.plan_pool_config(jcfg.llama, [13, 7], 4, 9, page_size=4,
                                 **kw)
        assert dataclasses.astuple(a)[:7] == dataclasses.astuple(b)[:7]
        assert a.quantize_kv == b.quantize_kv


def test_session_over_two_batches(model):
    """A BeamPoolSession: batch 2 over the same template resumes past the
    cached full blocks in wave 0, its tokens are the dense path's, and the
    page accounting comes out even."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    shared = np.asarray(rng.integers(4, jcfg.llama.vocab_size, 9), np.int32)
    b1 = make_shared_batch(jcfg, rng, tails=[3, 6], S=9, shared=shared,
                           L_pad=16)
    b2 = make_shared_batch(jcfg, rng, tails=[5, 2], S=9, shared=shared,
                           L_pad=16)
    jg, tg = _gens(max_new=6, beam=2, group=1, penalty=0.5)
    jsess = jpb.BeamPoolSession(page_size=4)
    want1 = jpb.paged_beam_generate(jparams, jcfg, both(b1)[0], jg,
                                    session=jsess)
    want2 = jpb.paged_beam_generate(jparams, jcfg, both(b2)[0], jg,
                                    session=jsess)
    for cfg in (tcfg, _kernel_backend(tcfg)):
        sess = tpb.BeamPoolSession(page_size=4)
        got1 = tpb.paged_beam_generate(tparams, cfg, b1, tg, session=sess)
        pool_k = sess.pool["k"]
        got2 = tpb.paged_beam_generate(tparams, cfg, b2, tg, session=sess)
        _assert_same(got1, want1)
        _assert_same(got2, want2)
        _assert_same(got2, tgen.generate_beam(tparams, tcfg, both(b2)[1],
                                              tg))
        assert sess.pool["k"] is pool_k            # one pool, in place
        assert dataclasses.astuple(sess.pcfg)[:7] \
            == dataclasses.astuple(jsess.pcfg)[:7]
        cached = len(sess.cache.meta)
        assert cached == len(jsess.cache.meta)
        assert len(sess.free) == sess.pcfg.n_pages - 1 - cached
        assert all(m["ref"] == 0 for m in sess.cache.meta.values())
    # the second batch skips the cached prefill
    sess = tpb.BeamPoolSession(page_size=4)
    st1, ctx1 = tpb.paged_beam_init(tparams, tcfg, b1, tg, session=sess)
    np.testing.assert_array_equal(ctx1["start"], [0, 8])
    np.testing.assert_array_equal(ctx1["wave"], [0, 1])
    sess.end_batch(ctx1["session_rec"], st1[1])
    st2, ctx2 = tpb.paged_beam_init(tparams, tcfg, b2, tg, session=sess)
    np.testing.assert_array_equal(ctx2["start"], [8, 8])
    np.testing.assert_array_equal(ctx2["wave"], [0, 0])
    sess.end_batch(ctx2["session_rec"], st2[1])
    with pytest.raises(ValueError, match="shaped for"):
        tpb.paged_beam_init(tparams, tcfg, make_shared_batch(
            jcfg, rng, tails=[1], S=9, shared=shared, L_pad=16), tg,
            session=sess)


def test_int8_pool_matches(model):
    """quantize_kv pools: tokens equal to the reference's int8 paged path,
    flat and with the cascade; the page moves carry the int8 codes and the
    f32 scale slabs alike."""
    jcfg, jparams, tcfg, tparams = model
    batch = make_shared_batch(jcfg, np.random.default_rng(3),
                              tails=[3, 6, 2], S=9)
    jb, _ = both(batch)
    jg, tg = _gens()
    want = jpb.paged_beam_generate(jparams, jcfg, jb, jg, page_size=4,
                                   quantize_kv=True, shared_prefix=True)
    for cfg, kw in ((tcfg, {}), (_kernel_backend(tcfg), {}),
                    (tcfg, dict(cascade=True))):
        got = tpb.paged_beam_generate(tparams, cfg, batch, tg, page_size=4,
                                      quantize_kv=True, shared_prefix=True,
                                      **kw)
        _assert_same(got, want, score_tol=2e-3)


def test_cascade_on_and_off(model):
    """Grouped-prefix cascade decode against the flat gather, against the
    reference's cascade, and with a prompt shorter than a page (a fully
    masked prefix row)."""
    jcfg, jparams, tcfg, tparams = model
    jg, tg = _gens(max_new=6, beam=4, group=2)
    rng = np.random.default_rng(4)
    batch = make_shared_batch(jcfg, rng, tails=[6, 1, 4], S=9)
    jb, tb = both(batch)
    want = jpb.paged_beam_generate(jparams, jcfg, jb, jg, page_size=4,
                                   cascade=True)
    dense = tgen.generate_beam(tparams, tcfg, tb, tg)
    _assert_same(dense, want)
    for cascade in (True, False):
        _assert_same(tpb.paged_beam_generate(tparams, tcfg, batch, tg,
                                             page_size=4, cascade=cascade),
                     want)
    _, ctx = tpb.paged_beam_init(tparams, _kernel_backend(tcfg), batch, tg,
                                 page_size=4)
    _, jctx = jpb.paged_beam_init(jparams, jcfg, jb, jg, page_size=4,
                                  cascade=True)
    assert ctx["cascade_pages"] == jctx["cascade_pages"]
    _, ctx_ref = tpb.paged_beam_init(tparams, tcfg, batch, tg, page_size=4)
    assert ctx_ref["cascade_pages"] is None        # "ref": off by default
    # one row's prompt fits inside its first page: g0 == 0 for that row
    short = make_soft_batch(jcfg, rng, B=2, L=12)
    short["seg_ids"][0, :9] = 0
    short["input_ids"][0, :9] = 0
    short["positions"][0] = np.maximum(np.arange(12) - 9, 0)
    short["soft_map"][0] = -1
    short["soft_map"][0, 10] = 0
    got = tpb.paged_beam_generate(tparams, tcfg, short, tg, page_size=4,
                                  cascade=True)
    assert torch.isfinite(got[1]).all()
    _assert_same(got, tgen.generate_beam(tparams, tcfg, both(short)[1], tg))


def test_pingpong_plan_keeps_sources_and_destinations_apart(model):
    """Every step's copy-on-write goes through the plain page move, which
    raises on overlapping sets; a plan without the phase flip does."""
    jcfg, _, tcfg, tparams = model
    cfg = _kernel_backend(tcfg)
    batch = make_soft_batch(jcfg, np.random.default_rng(5), B=2, L=12)
    _, tg = _gens(max_new=6)
    state, ctx = tpb.paged_beam_init(tparams, cfg, batch, tg, page_size=4)
    args = (tparams, cfg, tg, ctx["pcfg"], ctx["beam"], ctx["private"],
            ctx["g0"])
    state = tpb.paged_beam_step(*args, state, 0, max_position=12)
    with pytest.raises(ValueError, match="also a destination"):
        # step 1 at step 0's phase: children would write their parents'
        # pages
        tpb.paged_beam_step(*args, state, 0, max_position=13)


def test_ref_backend_refuses_to_copy_pages_off_the_cpu(model):
    """The beam's page copy on the "ref" backend is the indexed CPU form; a
    pool on another device (the meta device stands in for the card) is
    refused, and any other backend gets the page-move kernel's wrapper."""
    _, _, tcfg, _ = model
    pool = {"k": torch.zeros((4, 2, 8), device="meta")}
    with pytest.raises(ValueError, match="CPU reference"):
        tpb._page_copy(tcfg.llama, pool)
    assert tpb._page_copy(tcfg.llama, {"k": torch.zeros((4, 2, 8))}) \
        is tpb._copy_pages
    assert tpb._page_copy(_kernel_backend(tcfg).llama, pool) \
        is tpb._copy_pages_kernel
