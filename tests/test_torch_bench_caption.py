"""scripts/bench_caption.py of the port against the JAX package on the
CPU: the diverse-beam captions of the timed decode (beam 4, groups of 2,
diversity 0.8) on the reference's parameters, bridged, dense and paged
(with and without a shared prefix), f32 on the reference attention: the
same tokens and scores within 1e-4 after the same steps. The JAX side is
the reference script's init and steps (scripts/bench_caption.py:219-269),
jitted. Then the CLI's untimed run and the refused --step_trip."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.inference import generation as jgen
from procyon_tpu.inference import paged_beam as jpb
from procyon_tpu.models import unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.scripts import bench_caption
from torch_bench_common import jax_decoder_config, last_json
from torch_cpu_common import one_torch_thread  # noqa: F401

B, L, STEPS, BEAM = 2, 12, 4, 4


def _args(**kw):
    base = dict(dim=128, layers=2, llama3=False, prompt_len=L, gen_big=STEPS,
                beam_size=BEAM, beam_group_size=2, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def model():
    tcfg = bench_caption.bench_config(_args())
    jcfg = jax_decoder_config(tcfg)
    jparams = juni.init_params(jax.random.PRNGKey(4), jcfg)
    return jcfg, jparams, tcfg, bridge.to_torch(jparams)


def _jax_gen():
    a = _args()
    return jgen.GenerationConfig(
        max_new_tokens=a.gen_big + 8, method="beam", beam_size=a.beam_size,
        beam_group_size=a.beam_group_size, diversity_penalty=0.8,
        eos_token_id=2, pad_token_id=0)


def _ranked(tokens, scores):
    order = np.argsort(-np.asarray(scores), axis=1, kind="stable")
    return (np.take_along_axis(np.asarray(tokens), order[..., None], 1),
            np.take_along_axis(np.asarray(scores), order, 1))


def _jax_dense(jparams, jcfg, batch, gen, n):
    init = jax.jit(lambda p, b: jgen.beam_init(p, jcfg, b, gen))
    step = jax.jit(lambda p, s, t: jgen.beam_step(p, jcfg, gen, s, t))
    state = init(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    for t in range(n):
        state = step(jparams, state, jnp.int32(t))
    return _ranked(state[0], state[4])


def _jax_paged(jparams, jcfg, batch, gen, n, page_size):
    state, ctx = jpb.paged_beam_init(jparams, jcfg, batch, gen,
                                     page_size=page_size)
    step = jax.jit(lambda p, s, t: jpb.paged_beam_step(
        p, jcfg, gen, ctx["pcfg"], ctx["beam"], ctx["private"], ctx["g0"],
        s, t))
    for t in range(n + 1):          # the burn-in step 0, then 1..n
        state = step(jparams, state, jnp.int32(t))
    return _ranked(state[0], state[3])


@pytest.mark.parametrize("paged,page_size,shared", [
    (False, 0, 0), (True, 4, 0), (True, 8, 0), (True, 4, 8)])
def test_captions_match_reference(model, paged, page_size, shared):
    jcfg, jparams, tcfg, tparams = model
    batch = bench_caption.prompt_batch(tcfg, B, L, shared, seed=7)
    gen = bench_caption.gen_config(_args())
    go = bench_caption.captioner(tparams, tcfg, batch, gen, paged=paged,
                                 page_size=page_size or 64)
    (tokens, scores), _ = go(STEPS)
    jg = _jax_gen()
    want = (_jax_paged(jparams, jcfg, batch, jg, STEPS, page_size) if paged
            else _jax_dense(jparams, jcfg, batch, jg, STEPS))
    np.testing.assert_array_equal(tokens.numpy(), want[0])
    np.testing.assert_allclose(scores.numpy(), want[1], atol=1e-4)


def test_prompt_batch_is_the_reference_draws():
    tcfg = bench_caption.bench_config(_args())
    batch = bench_caption.prompt_batch(tcfg, 3, 10, shared_prefix=4)
    ids = np.random.default_rng(0).integers(4, 32000, (3, 10))
    ids[:, :4] = ids[0, :4]
    np.testing.assert_array_equal(batch["input_ids"], ids)


@pytest.mark.parametrize("extra", [[], ["--paged", "--shared_prefix", "4"],
                                   ["--paged", "--bits", "4", "--kv8"]])
def test_cli_runs_untimed_on_the_cpu(capsys, extra):
    res = bench_caption.main(["--device", "cpu", "--dim", "256", "--layers",
                              "1", "--batch", "2", "--prompt_len", "8",
                              "--beam_size", "4", "--gen_small", "2",
                              "--gen_big", "3", "--no-quality", *extra])
    line = last_json(capsys)
    assert line == res["line"] and line["timed"] is False
    assert line["metric"] == "caption_decode_tokens_per_sec_chip"
    assert line["value"] is None and not res["gate_failed"]
    tokens, scores = res["captions"]
    assert tuple(tokens.shape[:2]) == (2, 4) and np.isfinite(
        scores.numpy()).all()


def test_step_trip_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 6"):
        bench_caption.parse_args(["--paged", "--step_trip", "4",
                                  "--device", "cpu"])
