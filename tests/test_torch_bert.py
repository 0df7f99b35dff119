"""procyon_tpu_torch's BERT encoder (models/bert.py) and WordPiece tokenizer
(data/wordpiece.py) against procyon_tpu's on the CPU, and against
transformers' BertModel.

- `forward` on the JAX init_params carried across by the bridge (f32):
  hidden, pooled and every layer of all_hidden within 1e-4 of the JAX
  forward's (jitted), pad rows included (both give a query that sees no key
  zero attention), on right-padded rows, a dead row, two token types;
  stopped after n layers, the same tensor as all_hidden[n];
- the flash route: causal False, backend None by default (the rowblock
  packed route only on cfg.attn_backend == "rowblock"), and in the plain
  version a dead query row exactly 0 whatever NaN / inf the padded keys
  hold, and padded keys' values that change no live row;
- every `pool` mode equal to the JAX package's within 1e-6;
- the tokenizer equal to the JAX one on a seeded corpus (tokens, ids,
  padded batches, decode), and from a vocab file;
- `convert_hf_state` on local state dicts (the `bert.` prefix, gamma /
  beta, no pooler) equal to JAX's, `load_hf_checkpoint` from a
  model.safetensors and a pytorch_model.bin written here;
- the port against transformers.BertModel on a random config, on the
  valid rows within 2e-4 (as the JAX package's own test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.data.wordpiece import WordPieceTokenizer as JTok
from procyon_tpu.models import bert as jbert
from procyon_tpu_torch import bridge
from procyon_tpu_torch.data.wordpiece import WordPieceTokenizer as TTok
from procyon_tpu_torch.models import bert as tbert
from procyon_tpu_torch.ops import flash_attention as fa
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_text_common import (hf_bert_state, jforward, port_bert_config)

ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = jbert.tiny_config(n_layers=3)
    jparams = jbert.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, port_bert_config(jcfg), bridge.to_torch(jparams)


def _tokens(case, cfg):
    rng = np.random.default_rng(7)
    ids = rng.integers(5, cfg.vocab_size, (4, 24)).astype(np.int32)
    ids[:, 0] = 2
    types = np.zeros_like(ids)
    if case == "right_padded":
        for r, n in enumerate((24, 17, 9, 3)):
            ids[r, n:] = cfg.pad_id
    elif case == "dead_row":
        ids[1, 12:] = cfg.pad_id
        ids[2] = cfg.pad_id                 # a row of padding alone
    elif case == "token_types":
        types[:, 12:] = 1
        ids[3, 20:] = cfg.pad_id
    return ids, types


@pytest.mark.parametrize("case", ["unpadded", "right_padded", "dead_row",
                                  "token_types"])
def test_forward_matches_reference(tiny, case):
    jcfg, jparams, tcfg, tparams = tiny
    ids, types = _tokens(case, jcfg)
    want = jforward(jparams, jcfg, jnp.asarray(ids),
                    token_type_ids=jnp.asarray(types),
                    return_all_hidden=True)
    got = tbert.forward(tparams, tcfg, torch.from_numpy(ids),
                        token_type_ids=torch.from_numpy(types),
                        return_all_hidden=True)
    assert got["all_hidden"].shape == (jcfg.n_layers + 1, 4, 24, jcfg.dim)
    for key in ("hidden", "pooled", "all_hidden"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_forward_stops_after_n_layers(tiny, n):
    """n_layers=n gives all_hidden[n] itself (the same ops on the same
    inputs: bit for bit), and no pooled output."""
    _, _, tcfg, tparams = tiny
    ids = torch.from_numpy(_tokens("right_padded", tcfg)[0])
    full = tbert.forward(tparams, tcfg, ids, return_all_hidden=True)
    cut = tbert.forward(tparams, tcfg, ids, n_layers=n)
    assert torch.equal(cut["hidden"], full["all_hidden"][n])
    assert "pooled" not in cut
    with pytest.raises(ValueError, match="out of range"):
        tbert.forward(tparams, tcfg, ids, n_layers=tcfg.n_layers + 1)


def test_attention_takes_the_flash_route_bidirectionally(tiny, monkeypatch):
    """Every block calls flash_attention(q, k, v, seg, seg, causal=False,
    backend=cfg.attn_backend), default None: on a CUDA tensor the flash
    forward kernel; the rowblock packed route needs attn_backend
    "rowblock"."""
    _, _, tcfg, tparams = tiny
    assert tbert.BertConfig().attn_backend is None
    calls = []
    real = tbert.flash_attention

    def spy(q, k, v, seg_q, seg_kv, **kw):
        calls.append((seg_q is seg_kv, kw))
        return real(q, k, v, seg_q, seg_kv, **kw)

    monkeypatch.setattr(tbert, "flash_attention", spy)
    ids = torch.from_numpy(_tokens("dead_row", tcfg)[0])
    tbert.forward(tparams, tcfg, ids)
    assert calls == [(True, {"causal": False, "backend": None})] \
        * tcfg.n_layers


def _padded_attention(seed, fill):
    """q, k, v [2, 40, 3, 16] with row 0 right-padded after 25 keys, row 1
    all padding; `fill` written into the padded K / V rows."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((2, 40, 3, 16), generator=g) for _ in range(3))
    seg = torch.ones((2, 40), dtype=torch.int32)
    seg[0, 25:] = 0
    seg[1] = 0
    pad = seg == 0
    k, v = k.clone(), v.clone()
    k[pad], v[pad] = fill, fill
    return q, k, v, seg


@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -3e4])
def test_a_dead_query_row_is_exactly_zero(fill):
    """The plain version of the flash forward (the kernel's contract, held
    on the card by test_torch_cuda_kernels.py): a query row that sees no
    key comes out 0, bit for bit, and its lse -1e30, whatever NaN or inf
    the padded K / V rows hold."""
    q, k, v, seg = _padded_attention(0, fill)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    out, lse = fa.flash_fwd(q, k, v, *ints, causal=False, sm_scale=0.25,
                            want_lse=True)
    dead = seg == 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))
    assert torch.equal(lse.permute(0, 2, 1)[dead],
                       torch.full_like(lse.permute(0, 2, 1)[dead], -1e30))


def test_padded_keys_change_no_live_row():
    """Live rows' outputs are the same bits whatever finite values the
    padded K / V rows hold (their scores are masked before the max, their
    probabilities exactly 0), and a fully padded key tile adds nothing."""
    q, k, v, seg = _padded_attention(1, 0.0)
    _, k2, v2, _ = _padded_attention(1, -3e4)
    ints = fa.mask_inputs(q, k, seg, seg, None, None)
    a, _ = fa.flash_fwd(q, k, v, *ints, causal=False, sm_scale=0.25)
    b, _ = fa.flash_fwd(q, k2, v2, *ints, causal=False, sm_scale=0.25)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    want = fa.mha_reference(q, k, v, seg, seg, sm_scale=0.25)
    torch.testing.assert_close(a, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("how", ["cls", "cls_before_pooler", "mean", "avg",
                                 "max"])
@pytest.mark.parametrize("with_pooled", [False, True])
def test_pool_matches_reference(how, with_pooled):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 6, 5)).astype(np.float32)
    seg = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0],
                    [1, 0, 0, 0, 0, 0]], np.int32)
    pooled = rng.standard_normal((3, 5)).astype(np.float32) \
        if with_pooled else None
    want = jbert.pool(jnp.asarray(h), jnp.asarray(seg), how,
                      pooled=None if pooled is None else jnp.asarray(pooled))
    got = tbert.pool(torch.from_numpy(h), torch.from_numpy(seg), how,
                     pooled=None if pooled is None
                     else torch.from_numpy(pooled))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="pooler"):
        tbert.pool(torch.from_numpy(h), torch.from_numpy(seg), "median")


def _corpus(seed=4, n=40):
    rng = np.random.default_rng(seed)
    words = ["protein", "binding", "Kinase", "membrane", "ATP-binding",
             "transport", "Q9Y26", "signalling", "co-factor", "naïve",
             "résumé", "(DNA)", "repair,", "unknownword", "x" * 120]
    return [" ".join(rng.choice(words, rng.integers(1, 14)))
            for _ in range(n)], words


def test_wordpiece_matches_reference():
    texts, words = _corpus()
    jt = JTok.synthetic(words=words[:8], vocab_size=200)
    tt = TTok.synthetic(words=words[:8], vocab_size=200)
    assert tt.vocab == jt.vocab
    for t in texts:
        assert tt.tokenize(t) == jt.tokenize(t), t
        assert tt.encode(t) == jt.encode(t)
        assert tt.encode(t, max_len=9) == jt.encode(t, max_len=9)
        assert tt.encode(t, add_special_tokens=False) \
            == jt.encode(t, add_special_tokens=False)
        assert tt.decode(tt.encode(t)) == jt.decode(jt.encode(t))
        assert tt.decode(tt.encode(t), skip_special_tokens=False) \
            == jt.decode(jt.encode(t), skip_special_tokens=False)
    for pad_to in (None, 40):
        a = tt.batch_encode(texts, max_len=16, pad_to=pad_to)
        b = jt.batch_encode(texts, max_len=16, pad_to=pad_to)
        for field in ("ids", "attention_mask", "token_type_ids"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_wordpiece_from_vocab_file_matches_reference(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "protein",
             "bind", "##ing", "the", "q", "##9", "##y", "2", "##6", "膜",
             ",", "."]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    tt = TTok.from_vocab_file(str(path))
    jt = JTok.from_vocab_file(str(path))
    for text in ["The protein BINDING, binding.", "q9y26 protein",
                 "unknownword binding", "the the the", "膜 protein"]:
        assert tt.encode(text) == jt.encode(text), text
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    with pytest.raises(ValueError, match="special"):
        TTok({"[PAD]": 0})


def _compare_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _compare_trees(got[k], want[k])
    else:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("prefix,gamma_beta,pooler", [
    ("", False, True), ("bert.", True, True), ("bert.", False, False)])
def test_convert_hf_state_matches_reference(prefix, gamma_beta, pooler):
    state = hf_bert_state(dim=128, layers=2, prefix=prefix,
                          gamma_beta=gamma_beta, pooler=pooler)
    jparams, jcfg = jbert.convert_hf_state(state, dtype=jnp.float32)
    tparams, tcfg = tbert.convert_hf_state(state, dtype=torch.float32,
                                           device="cpu")
    assert tcfg == port_bert_config(jcfg)
    assert (tcfg.n_heads, tcfg.n_layers, tcfg.vocab_size) == (2, 2, 128)
    _compare_trees(tparams, jparams)
    if not pooler:
        assert torch.equal(tparams["pooler"]["w"], torch.eye(128))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_hf_checkpoint_from_a_local_file(tmp_path, fmt):
    """model.safetensors (written by the safetensors package, read by the
    port's own reader) or pytorch_model.bin, equal to converting the same
    state in memory; a directory with neither raises."""
    state = hf_bert_state(dim=128, layers=2, prefix="bert.", seed=1)
    if fmt == "safetensors":
        from safetensors.numpy import save_file
        save_file(state, str(tmp_path / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   str(tmp_path / "pytorch_model.bin"))
    got, cfg = tbert.load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                        device="cpu")
    want, wcfg = tbert.convert_hf_state(state, dtype=torch.float32,
                                        device="cpu")
    assert cfg == wcfg
    _compare_trees(got, bridge.to_numpy(want))
    with pytest.raises(FileNotFoundError):
        tbert.load_hf_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_matches_transformers_bert():
    """The port on the JAX tests' HF BertModel (4 heads of 16: the head count
    set by hand, the converter's head_dim-64 rule gives 1 at width 64)
    against the model itself: hidden states on the valid rows, every
    layer, and the pooler, within 2e-4."""
    from test_baseline_converters import _tiny_hf_bert

    model = _tiny_hf_bert()
    params, cfg = tbert.convert_hf_state(model.state_dict(),
                                         dtype=torch.float32, device="cpu")
    cfg = dataclasses.replace(cfg, n_heads=4)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, (3, 16))
    ids[1, 10:] = 0
    mask = (ids != 0).astype(np.int64)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask),
                    output_hidden_states=True)
    out = tbert.forward(params, cfg, torch.from_numpy(ids),
                        seg_ids=torch.from_numpy(mask),
                        return_all_hidden=True)
    valid = torch.from_numpy(mask).bool()
    for i, h in enumerate(ref.hidden_states):
        torch.testing.assert_close(out["all_hidden"][i][valid], h[valid],
                                   atol=2e-4, rtol=0)
    torch.testing.assert_close(out["pooled"], ref.pooler_output, atol=2e-4,
                               rtol=0)


def test_init_params_is_the_reference_tree():
    """The port's own init: the JAX tree's keys, shapes and dtype, seeded
    (the same seed the same numbers), N(0, 0.02) dense weights."""
    jcfg = jbert.tiny_config()
    cfg = port_bert_config(jcfg)
    a = tbert.init_params(5, cfg, device="cpu")
    b = tbert.init_params(5, cfg, device="cpu")
    want = jax.eval_shape(lambda: jbert.init_params(jax.random.PRNGKey(0),
                                                    jcfg))

    def check(x, y, w):
        if isinstance(w, dict):
            for k in w:
                check(x[k], y[k], w[k])
        else:
            assert tuple(x.shape) == w.shape and x.dtype == torch.float32
            assert torch.equal(x, y)

    check(a, b, want)
    assert abs(a["layers"]["attn"]["wq"].std().item() - 0.02) < 2e-3
