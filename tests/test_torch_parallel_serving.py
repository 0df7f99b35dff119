"""Tensor-parallel serving on gloo over 2 and 4 spawned CPU processes
(f32): KV-cache decode and paged decode against the JAX package's
single-device decode (test_multichip.py's model and bound, 2e-4), and the
ContinuousBatcher on a mesh against the one-process batcher in the JAX
dry run's four modes (plain, int8 KV, spec_k 2, prefix cache with chunked
wave prefill), greedy and sampled: the same tokens, on every rank. At
model 4 over 2 kv heads the attention stays whole on every rank (the
whole-kv-head departure) and the MLP is split; quantized weights stay
whole on every rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.models import llama as jllama
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama as tllama
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_dist_common import (SERVING_MODES, run_ranks, serving_worker)

ATOL = 2e-4
B, T = 4, 6


def _cfgs():
    kw = dict(attn_backend="ref", remat=False, dim=256, n_heads=4,
              n_kv_heads=2, intermediate=512, vocab_size=512)
    return jllama.tiny_config(**kw), tllama.tiny_config(**kw)


@pytest.fixture(scope="module")
def decode_ref():
    """test_multichip.py's two decodes on one device: prefill, then 3
    greedy steps, through the dense cache and through the paged pool."""
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, jcfg.vocab_size, (B, T)).astype(np.int32)

    @jax.jit
    def prefill(params, toks):
        cache = jllama.init_kv_cache(jcfg, B, max_len=T + 8)
        out = jllama.forward(params, jcfg, tokens=toks, kv_cache=cache)
        return out["logits"][:, -1], out["kv_cache"]

    @jax.jit
    def decode(params, tok, cache):
        out = jllama.forward(params, jcfg, tokens=tok, positions=jnp.full(
            (B, 1), cache["length"], jnp.int32), kv_cache=cache)
        return out["logits"][:, -1], out["kv_cache"]

    logits, cache = prefill(params, jnp.asarray(tokens))
    dense = [np.asarray(logits)]
    for _ in range(3):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = decode(params, tok, cache)
        dense.append(np.asarray(logits))

    pcfg = jkv.PagedConfig(n_layers=jcfg.n_layers,
                           n_kv_heads=jcfg.n_kv_heads,
                           head_dim=jcfg.head_dim, page_size=4, n_pages=16,
                           max_pages_per_seq=4, slots=B, dtype=jcfg.dtype)
    alloc = jkv.PageAllocator(pcfg)
    pt = np.zeros((B, pcfg.max_pages_per_seq), np.int32)
    for b in range(B):
        pages = alloc.allocate(b, T + 4)
        pt[b, :len(pages)] = pages
    slots = jnp.arange(B, dtype=jnp.int32)
    step = jax.jit(lambda p, pool, toks: jllama.paged_forward(
        p, jcfg, pool, pcfg, slots, tokens=toks))
    pool = {**jkv.init_pool(pcfg), "page_table": jnp.asarray(pt)}
    logits, pool = step(params, pool, jnp.asarray(tokens))
    paged = [np.asarray(logits[:, -1])]
    for _ in range(3):
        tok = jnp.argmax(paged[-1], -1)[:, None].astype(jnp.int32)
        logits, pool = step(params, pool, tok)
        paged.append(np.asarray(logits[:, -1]))
    return dict(cfg=tcfg, params=bridge.to_torch(bridge.to_numpy(params)),
                tokens=tokens, page_table=pt,
                want={False: np.stack(dense), True: np.stack(paged)})


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mesh", [(1, 1, 2), (2, 1, 2), (1, 1, 4)])
def test_tp_decode_matches_jax(decode_ref, tmp_path, paged, mesh):
    """Each rank holds its kv heads in its cache or pool (all of them at
    model 4 over 2 kv heads); the logits come back whole and equal on
    every rank."""
    res = run_ranks("decode", int(np.prod(mesh)), tmp_path, dict(
        cfg=decode_ref["cfg"], params=decode_ref["params"],
        tokens=decode_ref["tokens"], page_table=decode_ref["page_table"],
        paged=paged, mesh=mesh))
    want = decode_ref["want"][paged]
    hd = decode_ref["cfg"].head_dim
    kv_local = 1 if mesh[2] == 2 else 2
    for r in res:
        np.testing.assert_allclose(r["logits"], want, atol=ATOL, rtol=ATOL)
        assert r["pool_kv"] == (kv_local * hd if paged else kv_local)
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])


def _workload():
    _, cfg = _cfgs()
    params = tllama.init_params(7, cfg, device="cpu")
    rng = np.random.default_rng(7)
    shared = list(rng.integers(4, cfg.vocab_size, 9))
    prompts = [shared + list(rng.integers(4, cfg.vocab_size, n))
               for n in (3, 5, 4)]
    fused = rng.standard_normal((7, cfg.dim)).astype(np.float32) * 0.1
    return dict(cfg=cfg, params=params, prompts=prompts, fused=fused,
                max_new=4, modes=list(SERVING_MODES))


@pytest.fixture(scope="module")
def serving_runs(tmp_path_factory):
    """The workload in every mode in one process and on the meshes
    (model 2: whole kv heads a rank; model 4: attention whole), greedy and
    sampled."""
    out = {}
    for temp in (0.0, 0.8):
        p = dict(_workload(), temp=temp)
        out[temp, "single"] = serving_worker(0, 1, dict(p, mesh=(1, 1, 1)))
        for mesh in ((1, 1, 2), (1, 1, 4)):
            out[temp, mesh] = run_ranks(
                "serving", int(np.prod(mesh)),
                tmp_path_factory.mktemp("serving"), dict(p, mesh=mesh))
    return out


@pytest.mark.parametrize("mode", list(SERVING_MODES))
@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 1, 4)])
def test_tp_serving_tokens_equal_one_process(serving_runs, mesh, mode):
    want = serving_runs[0.0, "single"][mode]
    for r in serving_runs[0.0, mesh]:
        assert r[mode]["tokens"] == want["tokens"], (mode, mesh)
        assert r[mode]["hits"] == want["hits"]
        assert r[mode]["lanes"] == (64 if mesh[2] == 2 else 128)
    if mode == "prefix+wave":
        assert want["hits"] > 0


@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 1, 4)])
def test_tp_sampled_serving_same_tokens_every_rank(serving_runs, mesh):
    """temperature 0.8: every rank samples the gathered logits with a
    generator seeded alike, so the ranks agree with no broadcast, and
    with the one-process batcher."""
    want = serving_runs[0.8, "single"]
    for r in serving_runs[0.8, mesh]:
        for mode in SERVING_MODES:
            assert r[mode]["tokens"] == want[mode]["tokens"], (mode, mesh)


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_serving_quantized_weights(tmp_path, bits):
    """Quantized leaves stay whole on every rank, so the attention runs
    on all kv heads: the pool is sized from the same leaves as the
    forward (every kv head's lanes), and the tokens are the one-process
    batcher's on the same quantized weights."""
    p = dict(_workload(), temp=0.0, bits=bits, modes=["plain", "kv8"])
    want = serving_worker(0, 1, dict(p, mesh=(1, 1, 1)))
    for r in run_ranks("serving", 2, tmp_path, dict(p, mesh=(1, 1, 2))):
        for mode in p["modes"]:
            assert r[mode]["tokens"] == want[mode]["tokens"], mode
            assert r[mode]["lanes"] == 128
