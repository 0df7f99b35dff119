"""scripts/bench_serving.py of the port against the JAX package on the
CPU: the workload builder gives the reference script's requests, arrivals
and prefix for the same seed; the timed serving run on the reference's
tiny model (its parameters bridged) emits the reference batcher's tokens,
request for request, when both are driven by their script's loop over the
same workload, in the modes the script's flags select; the pool sizing;
the CLI's untimed run."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.inference import serving as jserving
from procyon_tpu.models import llama as jllama
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.scripts import bench_serving
from torch_bench_common import jax_script, last_json
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_serving_common import port_cfg

JAX_SCRIPT = jax_script("bench_serving")


def _args(*flags):
    return bench_serving.parse_args(["--synthetic", "--device", "cpu",
                                     *flags])


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, port_cfg(jcfg), bridge.to_torch(jparams)


@pytest.mark.parametrize("flags", [
    [], ["--shared_prefix", "8"], ["--short_gen", "3"],
    ["--shared_prefix", "5", "--short_gen", "2", "--seed", "4"]])
def test_workload_is_the_references(model, flags):
    jcfg, _, tcfg, _ = model
    args = _args(*flags)
    got = bench_serving.make_workload(args, tcfg,
                                      np.random.default_rng(args.seed))
    want = JAX_SCRIPT.make_workload(args, jcfg,
                                    np.random.default_rng(args.seed))
    assert len(got) == len(want) == args.requests
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[4] == w[4]
        if g[1] == "tok":
            assert g[3] == [int(t) for t in w[3]]
        else:
            np.testing.assert_array_equal(g[3], w[3])


MODES = {
    "plain": [],
    "prefix_cache": ["--prefix_cache", "--shared_prefix", "8"],
    "spec": ["--spec_k", "2"],
    "kv8_async": ["--kv8", "--async_rounds"],
    "chunked_waves": ["--prefill_chunk", "4", "--prefill_batch", "2",
                      "--short_gen", "3"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_served_tokens_match_reference(model, mode):
    """The same tokens for every request: f32 greedy on both sides, one
    batcher each, the reference's drive loop on the JAX side."""
    jcfg, jparams, tcfg, tparams = model
    args = _args(*MODES[mode])
    res = bench_serving.run(tparams, tcfg, args, warm=False)
    pcfg = res["batcher"].pcfg
    jpcfg = jkv.PagedConfig(
        n_layers=pcfg.n_layers, n_kv_heads=pcfg.n_kv_heads,
        head_dim=pcfg.head_dim, page_size=pcfg.page_size,
        n_pages=pcfg.n_pages, max_pages_per_seq=pcfg.max_pages_per_seq,
        slots=pcfg.slots, dtype=jnp.float32, quantize_kv=pcfg.quantize_kv)
    jb = jserving.ContinuousBatcher(
        jparams, jcfg, jpcfg, temperature=args.temperature,
        step_quantum=args.step_quantum, seed=args.seed, spec_k=args.spec_k,
        spec_quantum=args.spec_quantum,
        prefill_chunk=args.prefill_chunk or None,
        prefix_cache=args.prefix_cache, prefill_batch=args.prefill_batch,
        async_rounds=args.async_rounds)
    workload = JAX_SCRIPT.make_workload(args, jcfg,
                                        np.random.default_rng(args.seed))
    JAX_SCRIPT.drive(jb, workload, args.max_new)
    assert res["tokens"] == {r: list(map(int, t))
                             for r, t in jb.done.items()}
    line = res["line"]
    assert line["n_tokens"] == sum(len(t) for t in jb.done.values())
    assert line["waste_dropped_tokens"] == jb.waste["dropped"]
    if args.prefix_cache:
        assert line["prefix_hit_tokens"] == jb.pcache.stats["hit_tokens"] \
            > 0


def test_pool_sizing_at_llama3_8b():
    """The reference's pool rule at Llama-3-8B (32 layers, 8 KV heads of
    128) with its serving traffic: 1 GiB of bf16 64-token pages is 128
    pages, 640 tokens a slot; under --kv8 the int8 codes and their f32
    scales fit 248."""
    cfg = tllama.llama3_8b()
    a = argparse.Namespace(page_size=64, pool_mb=1024, kv8=False,
                           max_prompt=256, shared_prefix=256, max_new=64,
                           step_quantum=8, slots=16)
    p = bench_serving.pool_config(a, cfg)
    assert (p.n_pages, p.max_ctx, p.quantize_kv) == (128, 640, False)
    a.kv8 = True
    assert bench_serving.pool_config(a, cfg).n_pages == 248


def test_varied_weights_are_not_constant():
    """The timed tree's int8 codes vary (a constant tree would fake the
    speculative acceptance rate) and its shapes are quantize_params'."""
    cfg = tllama.tiny_config(dim=128, n_heads=2, n_kv_heads=1,
                             intermediate=256)
    p = bench_serving.varied_int8_params(cfg, device="cpu")
    want = tllama.quantize_params(tllama.init_params(0, cfg, device="cpu"),
                                  cfg)
    assert bridge.tree_leaves(p) and all(
        a.shape == b.shape and a.dtype == b.dtype
        for a, b in zip(bridge.tree_leaves(p), bridge.tree_leaves(want)))
    q = p["layers"]["mlp"]["w_up"]["q"]
    assert q.min() == -8 and q.max() == 8 and q.float().std() > 4
    assert (p["layers"]["attn_norm"] == 1).all()


def test_cli_runs_untimed_on_the_cpu(capsys):
    res = bench_serving.main(["--synthetic", "--device", "cpu",
                              "--prefix_cache", "--shared_prefix", "8",
                              "--spec_k", "2", "--spec_oracle"])
    line = last_json(capsys)
    assert line == res["line"] and line["timed"] is False
    assert line["metric"] == "serving_requests_per_sec"
    assert line["value"] is None and line["n_tokens"] > 0
    assert line["spec_oracle"] and line["prefix_hit_tokens"] > 0
    assert len(res["tokens"]) == 8
