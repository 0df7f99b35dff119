"""scripts/bench_decode.py of the port against the JAX package on the CPU:
the greedy tokens of the timed decode (prefill, then one-token steps) on
the reference's parameters, bridged, dense and paged, f32 on the reference
attention; and the CLI's untimed run. The JAX side is the reference
script's prefill and step (scripts/bench_decode.py:165-224), jitted."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import unified as juni
from procyon_tpu_torch import bridge
from procyon_tpu_torch.scripts import bench_decode
from torch_bench_common import jax_decoder_config, last_json
from torch_cpu_common import one_torch_thread  # noqa: F401

B, L, STEPS, DIM, LAYERS = 2, 12, 5, 128, 2


@pytest.fixture(scope="module")
def model():
    tcfg = bench_decode.bench_config(DIM, LAYERS, L + STEPS + 32,
                                     device="cpu")
    jcfg = jax_decoder_config(tcfg)
    jparams = juni.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, tcfg, bridge.to_torch(jparams)


def _jax_batch(tb):
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def _jax_dense(jparams, jcfg, batch, max_len, n):
    @jax.jit
    def prefill(params, b):
        cache = jllama.init_kv_cache(jcfg.llama, B, max_len=max_len)
        out = juni.forward(params, jcfg, b, kv_cache=cache)
        return jnp.argmax(out["logits"][:, -1], -1), out["kv_cache"]

    seg_live = batch["seg_ids"][:, -1:]

    @jax.jit
    def step(params, tok, pos, cache):
        b = {"input_ids": tok[:, None], "seg_ids": seg_live,
             "positions": pos, "soft_map": jnp.full((B, 1), -1, jnp.int32),
             "protein_embeds": batch["protein_embeds"]}
        out = juni.forward(params, jcfg, b, kv_cache=cache)
        return jnp.argmax(out["logits"][:, -1], -1), out["kv_cache"]

    tok, cache = prefill(jparams, batch)
    pos = batch["positions"][:, -1:] + 1
    toks = [tok]
    for _ in range(n):
        tok, cache = step(jparams, tok, pos, cache)
        pos = pos + 1
        toks.append(tok)
    return np.stack([np.asarray(t) for t in toks], 1)


def _jax_paged(jparams, jcfg, batch, max_len, n, page_size, kv8):
    n_pages_seq = -(-max_len // page_size)
    pcfg = jkv.PagedConfig(
        n_layers=jcfg.llama.n_layers, n_kv_heads=jcfg.llama.n_kv_heads,
        head_dim=jcfg.llama.head_dim, page_size=page_size,
        n_pages=1 + B * n_pages_seq, max_pages_per_seq=n_pages_seq,
        slots=B, dtype=jnp.float32, quantize_kv=kv8)
    alloc = jkv.PageAllocator(pcfg)
    table = jnp.asarray(np.stack([alloc.allocate(s, max_len)
                                  for s in range(B)]), jnp.int32)
    slots = jnp.arange(B, dtype=jnp.int32)

    @jax.jit
    def pprefill(params, pool, b):
        emb = juni.assemble_input_embeds(params, jcfg, b)
        logits, pool = jllama.paged_forward(
            params["llama"], jcfg.llama, pool, pcfg, slots,
            input_embeds=emb, seg_ids=b["seg_ids"])
        return jnp.argmax(logits[:, -1], -1), pool

    @functools.partial(jax.jit, donate_argnums=(2,))
    def pstep(params, tok, pool):
        logits, pool = jllama.paged_forward(
            params["llama"], jcfg.llama, pool, pcfg, slots,
            tokens=tok[:, None])
        return jnp.argmax(logits[:, -1], -1), pool

    pool = {**jkv.init_pool(pcfg), "page_table": table}
    tok, pool = pprefill(jparams, pool, batch)
    toks = [tok]
    for _ in range(n):
        tok, pool = pstep(jparams, tok, pool)
        toks.append(tok)
    return np.stack([np.asarray(t) for t in toks], 1)


@pytest.mark.parametrize("paged,page_size,kv8", [
    (False, 0, False), (True, 4, False), (True, 8, False), (True, 4, True)])
def test_greedy_tokens_match_reference(model, paged, page_size, kv8):
    """The same greedy tokens, prefill's and every step's (exact: f32 on
    both sides; a flip would need two logits within f32 rounding)."""
    jcfg, jparams, tcfg, tparams = model
    tb = bench_decode.prompt_batch(tcfg, B, L, device="cpu", seed=5)
    max_len = L + STEPS + 8
    go = bench_decode.decoder(tparams, tcfg, tb, max_len, paged=paged,
                              page_size=page_size or 64, kv8=kv8)
    got, _ = go(STEPS)
    jb = _jax_batch(tb)
    want = (_jax_paged(jparams, jcfg, jb, max_len, STEPS, page_size, kv8)
            if paged else _jax_dense(jparams, jcfg, jb, max_len, STEPS))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prompt_batch_is_the_reference_draws():
    """The reference script's prompts: rng(0).integers(4, vocab, (B, L))."""
    tcfg = bench_decode.bench_config(128, 1, 64, device="cpu")
    tb = bench_decode.prompt_batch(tcfg, 3, 7, device="cpu")
    want = np.random.default_rng(0).integers(4, 32000, (3, 7))
    np.testing.assert_array_equal(tb["input_ids"].numpy(), want)
    assert (tb["soft_map"] == -1).all() and (tb["seg_ids"] == 1).all()


@pytest.mark.parametrize("extra", [[], ["--paged"],
                                   ["--paged", "--quant", "--bits", "4",
                                    "--no-quality"]])
def test_cli_runs_untimed_on_the_cpu(capsys, extra):
    res = bench_decode.main(["--device", "cpu", "--dim", "256", "--layers",
                             "1", "--batch", "2", "--prompt_len", "8",
                             "--gen_small", "2", "--gen_big", "4", *extra])
    line = last_json(capsys)
    assert line == res["line"] and line["timed"] is False
    assert line["metric"] == "decode_tokens_per_sec_chip"
    assert line["value"] is None and not res["gate_failed"]
    assert line["backend"] == ("paged" if extra else "dense")
    assert tuple(res["tokens"].shape) == (2, 3)


def test_cli_refuses_kv8_without_paged():
    with pytest.raises(SystemExit):
        bench_decode.parse_args(["--kv8", "--device", "cpu"])
