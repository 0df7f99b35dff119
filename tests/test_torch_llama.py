"""procyon_tpu_torch Llama decoder against procyon_tpu.models.llama on the
same parameters (bridged) and the same numpy inputs, f32 on the CPU.

The JAX side runs attn_backend="ref" (mha_reference); the port runs both
its "ref" route and its default route (the plain version of the flash
kernel). Logits agree to 1e-4 (abs and rel): the same f32 function, sums in
another order. The captured HF goldens use tests/test_goldens.py's 3e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.models import checkpoint_io
from procyon_tpu.models import llama as jllama
from procyon_tpu.models import lora as jlora
from procyon_tpu.ops import rotary as jrot
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.models import lora as tlora
from procyon_tpu_torch.ops import rotary as trot

TOL = dict(atol=1e-4, rtol=1e-4)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    if jcfg.lora is not None:
        fields["lora"] = tlora.LoRAConfig(
            rank=jcfg.lora.rank, alpha=jcfg.lora.alpha,
            num_experts=jcfg.lora.num_experts, dtype=torch.float32)
    fields.update(kw)
    return tllama.LlamaConfig(**fields)


def _tokens(rng, B, S, vocab):
    return rng.integers(3, vocab, (B, S)).astype(np.int32)


def _padded(B, S):
    seg = np.ones((B, S), np.int32)
    seg[1, S - 5:] = 0
    return seg


@pytest.mark.parametrize("n_kv_heads", [4, 2])
@pytest.mark.parametrize("backend", [None, "ref"])
def test_forward_from_tokens_and_embeds(n_kv_heads, backend):
    jcfg = jllama.tiny_config(n_kv_heads=n_kv_heads, attn_backend="ref",
                              remat=False)
    tcfg = _port_cfg(jcfg, attn_backend=backend)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.to_torch(params)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    tokens, seg = _tokens(rng, B, S, jcfg.vocab_size), _padded(B, S)
    want = jllama.forward(params, jcfg, tokens=jnp.asarray(tokens),
                          seg_ids=jnp.asarray(seg))
    got = tllama.forward(tparams, tcfg, tokens=torch.from_numpy(tokens),
                         seg_ids=torch.from_numpy(seg))
    valid = seg > 0
    np.testing.assert_allclose(got["logits"].numpy()[valid],
                               np.asarray(want["logits"])[valid], **TOL)
    np.testing.assert_allclose(got["hidden"].numpy()[valid],
                               np.asarray(want["hidden"])[valid], **TOL)

    embeds = rng.standard_normal((B, S, jcfg.dim)).astype(np.float32)
    pos = np.tile(np.arange(3, 3 + S, dtype=np.int32), (B, 1))
    want = jllama.forward(params, jcfg, input_embeds=jnp.asarray(embeds),
                          seg_ids=jnp.asarray(seg),
                          positions=jnp.asarray(pos))
    got = tllama.forward(tparams, tcfg,
                         input_embeds=torch.from_numpy(embeds),
                         seg_ids=torch.from_numpy(seg),
                         positions=torch.from_numpy(pos),
                         want_logits=False)
    assert "logits" not in got
    np.testing.assert_allclose(got["hidden"].numpy()[valid],
                               np.asarray(want["hidden"])[valid], **TOL)


@pytest.mark.parametrize("backend", [None, "ref"])
def test_prefill_and_decode_through_dense_cache(backend):
    """Prefill 10 tokens, then three greedy decode steps (S == 1, the plain
    decode attention), then a 4-token block over the cache (S > 1 with a
    cache: flash attention at Sq != Skv with cache positions)."""
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False)
    tcfg = _port_cfg(jcfg, attn_backend=backend)
    params = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = bridge.to_torch(params)
    rng = np.random.default_rng(1)
    B, S0, Smax = 2, 10, 32
    tokens = _tokens(rng, B, S0, jcfg.vocab_size)
    jcache = jllama.init_kv_cache(jcfg, B, Smax)
    tcache = tllama.init_kv_cache(tcfg, B, Smax, device="cpu")

    def step(toks, start):
        nonlocal jcache, tcache
        n = toks.shape[1]
        pos = np.tile(np.arange(start, start + n, dtype=np.int32), (B, 1))
        want = jllama.forward(params, jcfg, tokens=jnp.asarray(toks),
                              positions=jnp.asarray(pos), kv_cache=jcache)
        got = tllama.forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                             positions=torch.from_numpy(pos),
                             kv_cache=tcache)
        jcache, tcache = want["kv_cache"], got["kv_cache"]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), **TOL)
        nxt_j = np.asarray(want["logits"])[:, -1].argmax(-1)
        nxt_t = got["logits"][:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(nxt_t, nxt_j)
        return nxt_j.astype(np.int32)[:, None]

    nxt = step(tokens, 0)
    for i in range(3):
        nxt = step(nxt, S0 + i)
    step(_tokens(rng, B, 4, jcfg.vocab_size), S0 + 3)
    assert tcache["length"] == int(jcache["length"]) == S0 + 3 + 4
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    np.testing.assert_array_equal(tcache["seg"].numpy(),
                                  np.asarray(jcache["seg"]))


@pytest.mark.parametrize("mode", ["dequant", "w8a8"])
def test_int8_weights(mode):
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False,
                              quant_mode=mode)
    tcfg = _port_cfg(jcfg)
    params = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    jq = jllama.quantize_params(params, jcfg)
    tq = tllama.quantize_params(bridge.to_torch(params), tcfg)
    np.testing.assert_array_equal(
        tq["layers"]["mlp"]["w_up"]["q"].numpy(),
        np.asarray(jq["layers"]["mlp"]["w_up"]["q"]))
    np.testing.assert_array_equal(tq["lm_head"]["q"].numpy(),
                                  np.asarray(jq["lm_head"]["q"]))
    tokens = _tokens(np.random.default_rng(2), 2, 16, jcfg.vocab_size)
    want = jllama.forward(jq, jcfg, tokens=jnp.asarray(tokens))
    # the bridged int8 tree and the port's own quantization both run
    for tree in (bridge.to_torch(jq), tq):
        got = tllama.forward(tree, tcfg, tokens=torch.from_numpy(tokens))
        # an activation that sits on an int8 rounding boundary may take
        # the neighbouring code under w8a8: one step of 1/127 of a row's
        # range moves a logit by a few 1e-3
        tol = TOL if mode == "dequant" else dict(atol=5e-3, rtol=5e-3)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), **tol)
    # bits is 8 or 4 (tests/test_torch_int4.py holds the int4 tree to JAX's)
    with pytest.raises(ValueError, match="bits"):
        tllama.quantize_params(bridge.to_torch(params), tcfg, bits=3)


def test_lora_expert_and_lora_helpers():
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, num_experts=3,
                            dtype=jnp.float32)
    jcfg = jllama.tiny_config(attn_backend="ref", remat=False, lora=lcfg)
    tcfg = _port_cfg(jcfg)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    layers = dict(params["layers"])
    for name in ("lora_wq", "lora_wv"):        # B starts at 0: make it count
        bank = dict(layers[name])
        bank["B"] = jnp.asarray(rng.standard_normal(bank["B"].shape) * 0.1,
                                jnp.float32)
        layers[name] = bank
    params = {**params, "layers": layers}
    tparams = bridge.to_torch(params)
    tokens = _tokens(rng, 2, 12, jcfg.vocab_size)
    outs = []
    for expert in (0, 2):
        want = jllama.forward(params, jcfg, tokens=jnp.asarray(tokens),
                              lora_expert=expert)
        got = tllama.forward(tparams, tcfg, tokens=torch.from_numpy(tokens),
                             lora_expert=expert)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), **TOL)
        outs.append(got["logits"])
    assert (outs[0] - outs[1]).abs().max() > 1e-3

    bank = {k: v[0] for k, v in layers["lora_wq"].items()}
    tbank = bridge.to_torch(bank)
    x = rng.standard_normal((3, 5, jcfg.dim)).astype(np.float32)
    base = rng.standard_normal((3, 5, bank["B"].shape[-1])).astype(
        np.float32)
    onehot = np.eye(3, dtype=np.float32)[[2, 0, 1]]
    want = jlora.apply_routed(bank, lcfg, jnp.asarray(x), jnp.asarray(base),
                              jnp.asarray(onehot))
    got = tlora.apply_routed(tbank, tcfg.lora, torch.from_numpy(x),
                             torch.from_numpy(base),
                             torch.from_numpy(onehot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tlora.merged_delta(tbank, tcfg.lora).numpy(),
        np.asarray(jlora.merged_delta(bank, lcfg)), **TOL)
    fresh = tlora.init_params(0, tcfg.lora, 16, 8, device="cpu")
    assert fresh["A"].shape == (3, 16, 4) and not fresh["B"].any()


@pytest.mark.parametrize("name,kv", [("llama_mha.npz", 4),
                                     ("llama_gqa.npz", 2)])
@pytest.mark.parametrize("backend", [None, "ref"])
def test_hf_goldens(name, kv, backend):
    blob = np.load(os.path.join(GOLDEN_DIR, name))
    sd = {k[3:]: blob[k] for k in blob.files if k.startswith("sd/")}
    jcfg = jllama.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                              n_kv_heads=kv, intermediate=128,
                              max_seq_len=64, dtype=jnp.float32,
                              attn_backend="ref", remat=False)
    params = bridge.to_torch(checkpoint_io.convert_hf_llama(sd, jcfg))
    out = tllama.forward(params, _port_cfg(jcfg, attn_backend=backend),
                         tokens=torch.from_numpy(np.array(blob["tokens"])))
    np.testing.assert_allclose(out["logits"].numpy(), blob["logits"],
                               atol=3e-4, rtol=3e-4)


def test_port_init_params_and_entry_points():
    """The port's own init gives the reference's tree (shapes, scales) on
    the device it is told, and does not fall to the CPU unasked."""
    lcfg = tlora.LoRAConfig(rank=2, num_experts=2, dtype=torch.float32)
    tcfg = tllama.tiny_config(dim=128, n_heads=4, lora=lcfg)
    p = tllama.init_params(0, tcfg, device="cpu")
    jcfg = jllama.tiny_config(dim=128, n_heads=4, lora=jlora.LoRAConfig(
        rank=2, num_experts=2, dtype=jnp.float32))
    ref = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    flat_t = jax.tree_util.tree_leaves_with_path(bridge.to_numpy(p))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        assert leaf.shape == flat_j[path].shape, path
        # the reference scales a stacked [L, in, out] weight by
        # 1/sqrt(shape[0]) = 1/sqrt(L); the port by 1/sqrt(fan_in), as the
        # reference does for unstacked weights
        want = float(np.std(flat_j[path])) if leaf.ndim < 3 \
            or "lora" in str(path) else leaf.shape[-2] ** -0.5
        assert abs(float(np.std(leaf)) - want) <= 0.2 * want + 1e-6, path
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tllama.init_params(0, tcfg)           # device defaults to cuda
    with pytest.raises(ValueError, match="generator"):
        tllama.init_params(torch.Generator(), tcfg, device="meta")
    assert tllama.llama3_8b().n_kv_heads == 8
    assert tllama.llama2_7b().intermediate == 11008
    with pytest.raises(ValueError, match="max_seq_len"):
        tllama.forward(p, tcfg, tokens=torch.zeros((1, 4), dtype=torch.long),
                       positions=torch.full((1, 4), 500))


@pytest.mark.parametrize("n_heads", [4, 2])
def test_rotary_at_positions_matches_gathered_tables(n_heads):
    """flat_rotary_at computes the rows the reference gathers from its
    [max_len, H*D] tables (1e-6: the same angles, cos / sin from another
    library), and both application forms agree with the reference's."""
    D, theta = 16, 5e5
    rng = np.random.default_rng(n_heads)
    pos = rng.integers(0, 128, (2, 9)).astype(np.int32)
    cos, sin, perm = jrot.flat_rotary_tables(D, n_heads, 128, theta)
    cos_g, sin_g, tperm = trot.flat_rotary_at(torch.from_numpy(pos), D,
                                              n_heads, theta)
    np.testing.assert_allclose(cos_g.numpy(), np.asarray(cos)[pos],
                               atol=1e-6)
    np.testing.assert_allclose(sin_g.numpy(), np.asarray(sin)[pos],
                               atol=1e-6)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    x = rng.standard_normal((2, 9, n_heads * D)).astype(np.float32)
    want = jrot.apply_rotary_flat(jnp.asarray(x), cos[pos], sin[pos], perm)
    got = trot.apply_rotary_flat(torch.from_numpy(x), cos_g, sin_g, tperm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    x1, c1, s1 = x[:, :1], cos_g[:, :1], sin_g[:, :1]
    want1 = jrot.apply_rotary_flat_decode(
        jnp.asarray(x1), jnp.asarray(c1.numpy()), jnp.asarray(s1.numpy()), D)
    got1 = trot.apply_rotary_flat_decode(torch.from_numpy(x1), c1, s1, D)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-6)
    np.testing.assert_allclose(got1.numpy(), got.numpy()[:, :1], atol=1e-6)


@pytest.mark.parametrize("n_heads", [4, 2])
def test_rotary_gradient_matches_jax(n_heads):
    """apply_rotary_flat's backward (a gather with the self-inverse lane
    permutation) gives jax.grad's input gradient of the reference's rotary,
    to 1e-6."""
    D, theta = 16, 5e5
    rng = np.random.default_rng(10 + n_heads)
    pos = rng.integers(0, 128, (2, 9)).astype(np.int32)
    x = rng.standard_normal((2, 9, n_heads * D)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    cos, sin, perm = jrot.flat_rotary_tables(D, n_heads, 128, theta)
    want = jax.grad(lambda a: jnp.sum(jrot.apply_rotary_flat(
        a, cos[pos], sin[pos], perm) * w))(jnp.asarray(x))
    cos_g, sin_g, tperm = trot.flat_rotary_at(torch.from_numpy(pos), D,
                                              n_heads, theta)
    np.testing.assert_array_equal(tperm[tperm].numpy(),
                                  np.arange(n_heads * D))
    xt = torch.from_numpy(x).requires_grad_(True)
    (trot.apply_rotary_flat(xt, cos_g, sin_g, tperm)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-6)
