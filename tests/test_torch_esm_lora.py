"""procyon_tpu_torch's encoder tuning family against procyon_tpu's on the CPU
in f32 (a counterpart of each case in tests/test_esm_lora.py): (Mo)LoRA
banks on the three target sets, prefix tuning, the bottleneck adapter, the
merge for serving, QLoRA (int8 base, f32 banks), remat, the expert index
clamped to the bank, the config wiring (`lora_targets`, `remat`) and
`lora_expert` threaded through the fusion model's encoder.

The JAX package's parameters go through the bridge, with LoRA B, the
prefix rows and the adapter's up projection made nonzero
(tests/torch_esm_common.py). Tolerances: forward 1e-5 (abs and rel; the
same f32 function with sums in another order); gradients of the banks,
the prefix and the adapter against jax.grad within 1e-4 of the largest
element of each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.lora as jlora
import procyon_tpu.models.unified as juni
from procyon_tpu import config as jconfig
from procyon_tpu_torch import bridge
from procyon_tpu_torch import config as tconfig
from procyon_tpu_torch.models import esm2 as tesm
from procyon_tpu_torch.models import lora as tlora
from procyon_tpu_torch.models import unified as tuni
from procyon_tpu_torch.ops import quant as tquant
from torch_cpu_common import one_torch_thread  # noqa: F401
from torch_esm_common import (FWD_TOL, assert_grads_close, jax_cfg, jax_lora,
                              live_models, perturbed_params, port_cfg,
                              set_path, tokens, trained)

TARGETS = [("attn", ("wq", "wk", "wv")), ("mlp", ("wo", "w1", "w2")),
           ("default", ("wq", "wk", "wv", "wo", "w1", "w2"))]


def _both_forward(jcfg, params, toks, expert=0, tcfg=None, tparams=None):
    want = jesm.forward(params, jcfg, jnp.asarray(toks), return_logits=True,
                        lora_expert=expert)
    got = tesm.forward(bridge.to_torch(params) if tparams is None
                       else tparams, tcfg or port_cfg(jcfg),
                       torch.from_numpy(toks), return_logits=True,
                       lora_expert=expert)
    for key in ("hidden", "logits"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), **FWD_TOL,
                                   err_msg=key)
    return got, want


def _both_grads(jcfg, params, toks, pred, expert=0, tcfg=None,
                tparams=None):
    """Gradients of sum(hidden * w) + sum(logits * w2) with respect to the
    leaves `pred` picks, in both packages."""
    rng = np.random.default_rng(7)
    B, S = toks.shape
    w = rng.standard_normal((B, S, jcfg.dim)).astype(np.float32)
    w2 = rng.standard_normal((B, S, jcfg.vocab_size)).astype(np.float32)

    def jloss(tr):
        p = params
        for k, v in tr.items():
            p = set_path(p, k, v)
        out = jesm.forward(p, jcfg, jnp.asarray(toks), return_logits=True,
                           lora_expert=expert)
        return (out["hidden"] * w).sum() + (out["logits"] * w2).sum()

    want = jax.grad(jloss)(trained(params, pred))
    tp = bridge.to_torch(params) if tparams is None else tparams
    leaves = trained(tp, pred)
    for t in leaves.values():
        t.requires_grad_(True)
    out = tesm.forward(tp, tcfg or port_cfg(jcfg), torch.from_numpy(toks),
                       return_logits=True, lora_expert=expert)
    loss = (out["hidden"] * torch.from_numpy(w)).sum() \
        + (out["logits"] * torch.from_numpy(w2)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), want


# ---------------------------------------------------------------------------
# LoRA banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("targets,expected", TARGETS)
def test_target_sets_create_the_references_banks(targets, expected):
    jcfg = jax_cfg(lora=jax_lora(num_experts=2), lora_targets=targets)
    ref = jesm.init_params(jax.random.PRNGKey(0), jcfg)
    got = tesm.init_params(0, port_cfg(jcfg), device="cpu")
    assert tesm.lora_target_names(port_cfg(jcfg)) == expected \
        == jesm.lora_target_names(jcfg)
    banks = sorted(k for k in got["layers"] if k.startswith("lora_"))
    assert banks == sorted(k for k in ref["layers"] if k.startswith("lora_"))
    assert banks == sorted(f"lora_{n}" for n in expected)
    for n in banks:
        for ab in ("A", "B"):
            assert tuple(got["layers"][n][ab].shape) \
                == ref["layers"][n][ab].shape
        assert not got["layers"][n]["B"].any()     # the delta starts at 0


@pytest.mark.parametrize("targets,expert", [("attn", 0), ("mlp", 2),
                                            ("default", 1)])
def test_banked_forward_and_grads_match_reference(targets, expert):
    jcfg = jax_cfg(lora=jax_lora(num_experts=3), lora_targets=targets)
    params = perturbed_params(jcfg)
    toks = tokens(np.random.default_rng(1))
    _both_forward(jcfg, params, toks, expert)
    got, want = _both_grads(jcfg, params, toks,
                            lambda p: "/lora_" in p, expert)
    assert_grads_close(got, want)
    # only the chosen expert's slices get a gradient
    for k, g in got.items():
        others = [e for e in range(3) if e != expert]
        assert not g[:, others].any(), k
        assert g[:, expert].any(), k


def test_zero_init_is_identity():
    """B = 0 at init: the banked forward equals the base forward bitwise."""
    cfg = tesm.tiny_config(attn_backend="ref", remat=False,
                           lora=tlora.LoRAConfig(rank=4, num_experts=2,
                                                 dtype=torch.float32))
    params = tesm.init_params(0, cfg, device="cpu")
    base = {**params, "layers": {k: v for k, v in params["layers"].items()
                                 if not k.startswith("lora_")}}
    toks = torch.from_numpy(tokens(np.random.default_rng(2)))
    a = tesm.forward(params, cfg, toks)["hidden"]
    b = tesm.forward(base, dataclasses.replace(cfg, lora=None),
                     toks)["hidden"]
    assert torch.equal(a, b)


def test_experts_differ_and_an_index_past_the_bank_reads_the_last():
    """Expert 1's B perturbed: experts 0 and 2 agree, 1 differs; expert 5
    of a 3-expert bank reads expert 2 in both packages (JAX's gather clips
    the index; the port clamps it, lora.expert_slice)."""
    jcfg = jax_cfg(lora=jax_lora(num_experts=3))
    params = jesm.init_params(jax.random.PRNGKey(0), jcfg)
    b = params["layers"]["lora_wq"]["B"]
    params = set_path(params, "layers/lora_wq/B", b.at[:, 1].set(0.5))
    toks = tokens(np.random.default_rng(3))
    outs = {e: _both_forward(jcfg, params, toks, e)[0]["hidden"]
            for e in (0, 1, 2, 5)}
    assert not torch.allclose(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    assert torch.equal(outs[5], outs[2])


@pytest.mark.parametrize("index", [1, 3, 7, "tensor", "tensor_inside"])
def test_lora_apply_reads_an_index_past_the_bank_as_jax_gathers(index):
    """lora.apply on a 3-expert bank: an index past it reads the last
    expert and its gradient is dropped, as JAX's gather does (the clipped
    read's transpose drops the update); an index inside trains its
    expert. A decoder of 4 experts and an encoder of fewer share the
    phase index."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 6, 2)).astype(np.float32)
    b = rng.standard_normal((3, 2, 5)).astype(np.float32)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    base = rng.standard_normal((4, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    jc = jlora.LoRAConfig(rank=2, alpha=4.0, num_experts=3,
                          dtype=jnp.float32)
    tc = tlora.LoRAConfig(rank=2, alpha=4.0, num_experts=3,
                          dtype=torch.float32)
    e = {"tensor": 9, "tensor_inside": 1}.get(index, index)

    def jloss(p):
        return (jlora.apply(p, jc, jnp.asarray(x), jnp.asarray(base),
                            expert_idx=e) * w).sum()

    jp = {"A": jnp.asarray(a), "B": jnp.asarray(b)}
    want = jlora.apply(jp, jc, jnp.asarray(x), jnp.asarray(base),
                       expert_idx=e)
    jg = jax.grad(jloss)(jp)
    tp = {"A": torch.from_numpy(a).requires_grad_(),
          "B": torch.from_numpy(b).requires_grad_()}
    got = tlora.apply(tp, tc, torch.from_numpy(x), torch.from_numpy(base),
                      expert_idx=torch.tensor(e) if isinstance(index, str)
                      else e)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    if got.requires_grad:
        (got * torch.from_numpy(w)).sum().backward()
    for k in ("A", "B"):
        g = tp[k].grad if tp[k].grad is not None else torch.zeros(3)
        assert bool(g.any()) == (e < 3), k
        if e < 3:
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                       **FWD_TOL, err_msg=k)
        else:
            assert not np.asarray(jg[k]).any(), k
    last = tlora.apply({"A": torch.from_numpy(a), "B": torch.from_numpy(b)},
                       tc, torch.from_numpy(x), torch.from_numpy(base),
                       expert_idx=min(e, 2))
    assert torch.equal(got.detach(), last)


def test_merge_matches_reference_and_the_banked_forward():
    """merge_lora_params: the experts' mean delta in f32, folded into the
    base; the port's merged weights are the reference's, and with one
    expert the merged forward is the banked one."""
    jcfg = jax_cfg(lora=jax_lora(num_experts=3))
    params = perturbed_params(jcfg)
    want = jesm.merge_lora_params(params, jcfg)
    got = tesm.merge_lora_params(bridge.to_torch(params), port_cfg(jcfg))
    assert not any(k.startswith("lora_") for k in got["layers"])
    for grp, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w2")):
        np.testing.assert_allclose(got["layers"][grp][name].numpy(),
                                   np.asarray(want["layers"][grp][name]),
                                   atol=1e-6, rtol=1e-6)
    jcfg1 = jax_cfg(lora=jax_lora(num_experts=1))
    p1 = perturbed_params(jcfg1, seed=1)
    toks = torch.from_numpy(tokens(np.random.default_rng(5)))
    banked = tesm.forward(bridge.to_torch(p1), port_cfg(jcfg1),
                          toks)["hidden"]
    merged = tesm.forward(
        tesm.merge_lora_params(bridge.to_torch(p1), port_cfg(jcfg1)),
        port_cfg(jcfg1, lora=None), toks)["hidden"]
    np.testing.assert_allclose(merged.numpy(), banked.numpy(), atol=2e-5)


def test_fuse_and_merge_refuse_what_they_cannot_serve():
    cfg = port_cfg(jax_cfg(lora=jax_lora(num_experts=2)))
    params = tesm.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="merge_lora_params"):
        tesm.fuse_qkv_params(params)
    with pytest.raises(ValueError, match="before quantize_params"):
        tesm.merge_lora_params(tesm.quantize_params(params, cfg), cfg)


def test_qlora_forward_and_grads_match_reference():
    """quantize_params keeps the banks f32 over an int8 base (the QLoRA
    recipe); forward and the banks' gradients through quant.mm's
    dequantized route match the reference's on the same int8 codes."""
    jcfg = jax_cfg(lora=jax_lora(num_experts=2))
    params = jesm.quantize_params(perturbed_params(jcfg, seed=2), jcfg)
    tparams = tesm.quantize_params(
        bridge.to_torch(perturbed_params(jcfg, seed=2)), port_cfg(jcfg))
    assert tquant.is_quantized(tparams["layers"]["attn"]["wq"])
    assert tparams["layers"]["lora_wq"]["A"].dtype == torch.float32
    np.testing.assert_array_equal(
        tparams["layers"]["mlp"]["w1"]["q"].numpy(),
        np.asarray(params["layers"]["mlp"]["w1"]["q"]))
    toks = tokens(np.random.default_rng(6))
    _both_forward(jcfg, params, toks, 1, tparams=tparams)
    got, want = _both_grads(jcfg, params, toks, lambda p: "/lora_" in p, 1,
                            tparams=tparams)
    assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# Prefix tuning and the adapter
# ---------------------------------------------------------------------------


def test_adapter_zero_init_is_identity():
    cfg = tesm.tiny_config(attn_backend="ref", remat=False, adapter_rank=4)
    params = tesm.init_params(0, cfg, device="cpu")
    base = {**params, "layers": {k: v for k, v in params["layers"].items()
                                 if k != "adapter"}}
    toks = torch.from_numpy(tokens(np.random.default_rng(8)))
    a = tesm.forward(params, cfg, toks)["hidden"]
    b = tesm.forward(base, dataclasses.replace(cfg, adapter_rank=0),
                     toks)["hidden"]
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["prefix", "adapter"])
def test_forward_and_grads_match_reference(kind):
    jcfg = jax_cfg(**({"prefix_len": 3} if kind == "prefix"
                      else {"adapter_rank": 4}))
    params = perturbed_params(jcfg, seed=3)
    toks = tokens(np.random.default_rng(9))
    _both_forward(jcfg, params, toks)
    got, want = _both_grads(jcfg, params, toks,
                            lambda p: f"/{kind}/" in p)
    assert_grads_close(got, want)


def test_prefix_keys_take_the_identity_rotation():
    """The prefix K rows are post-rotary: given the positional rotation
    instead, the output moves (the card's planted fault, chip_smoke)."""
    jcfg = jax_cfg(prefix_len=3)
    params = bridge.to_torch(perturbed_params(jcfg, seed=3))
    cfg = port_cfg(jcfg)
    toks = torch.from_numpy(tokens(np.random.default_rng(9)))
    ident = tesm.prefix_key_rotation(
        (torch.ones(5, 8), torch.full((5, 8), 0.5)), 2)
    assert torch.equal(ident[0][:2], torch.ones(2, 8))
    assert not ident[1][:2].any()
    good = tesm.forward(params, cfg, toks)["hidden"]
    orig = tesm.prefix_key_rotation
    try:
        from procyon_tpu_torch.ops.rotary import flat_rotary_tables

        def positional(rot, P):
            # the prefix rows rotated as positions 0..P-1
            cos, sin, _ = flat_rotary_tables(cfg.head_dim, cfg.n_heads, P)
            return torch.cat([cos, rot[0]]), torch.cat([sin, rot[1]])
        tesm.prefix_key_rotation = positional
        bad = tesm.forward(params, cfg, toks)["hidden"]
    finally:
        tesm.prefix_key_rotation = orig
    assert (bad - good).abs().max() > 1e-3


def test_everything_at_once_with_remat_matches_reference():
    """Banks, prefix and adapter together; the port checkpoints each layer
    (remat) and still gives the reference's forward and gradients."""
    jcfg = jax_cfg(lora=jax_lora(num_experts=2), prefix_len=2,
                   adapter_rank=4)
    params = perturbed_params(jcfg, seed=4)
    toks = tokens(np.random.default_rng(10))
    tcfg = port_cfg(jcfg, remat=True)
    _both_forward(jcfg, params, toks, 1, tcfg=tcfg)
    got, want = _both_grads(
        jcfg, params, toks,
        lambda p: any(s in p for s in ("/lora_", "/prefix/", "/adapter/")),
        1, tcfg=tcfg)
    assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# Config wiring and the fusion model's encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("targets", ["attn", "mlp", "default"])
def test_build_model_config_wires_the_encoders_lora(targets):
    """prot_lora_parameters reaches ESM2Config.lora_targets, and the bank
    keys of an init are the reference's."""
    kw = dict(use_aaseq_embeddings=False, protein_encoder="esm2-8m",
              use_prot_lora=True, aaseq_lora_r=4, aaseq_lora_alpha=8.0,
              prot_lora_num_experts=3, prot_lora_parameters=targets,
              aaseq_adapter_rank=2, esm_prefix_len=2, dtype="float32")
    want = jconfig.build_model_config(jconfig.ModelArgs(**kw)).esm
    got = tconfig.build_model_config(tconfig.ModelArgs(**kw)).esm
    assert got.lora_targets == want.lora_targets == targets
    assert got.remat == want.remat
    assert (got.lora.rank, got.lora.alpha, got.lora.num_experts) \
        == (want.lora.rank, want.lora.alpha, want.lora.num_experts)
    assert (got.adapter_rank, got.prefix_len) == (2, 2)
    small = dict(dim=64, n_layers=1, n_heads=4, max_seq_len=32)
    jp = jesm.init_params(jax.random.PRNGKey(0),
                          dataclasses.replace(want, **small))
    tp = tesm.init_params(0, dataclasses.replace(got, **small),
                          device="cpu")
    assert sorted(tp["layers"]) == sorted(jp["layers"])


def test_freeze_fn_peft_modes_match_reference():
    """Every encoder and decoder path of a tree with banks, a prefix and an
    adapter, under each PEFT mode: frozen exactly where the reference
    freezes."""
    jcfg = jax_cfg(lora=jax_lora(num_experts=2), prefix_len=2,
                   adapter_rank=4)
    paths = []
    for k, v in jesm.init_params(jax.random.PRNGKey(0), jcfg)[
            "layers"].items():
        for n in v:
            paths.append(["esm", "layers", k, n])
    paths += [["esm", "embed"], ["llama", "layers", "lora_wq", "A"],
              ["llama", "layers", "attn", "wq"], ["projectors", "x"]]
    for kw in (dict(use_prot_lora=True), dict(aaseq_adapter_rank=4),
               dict(esm_prefix_len=2), dict(freeze_protein_encoder=False),
               dict(use_prot_lora=True, use_lora=True),
               dict(freeze_protein_encoder=True)):
        jf = jconfig.freeze_fn(jconfig.ModelArgs(use_aaseq_embeddings=False,
                                                 **kw))
        tf = tconfig.freeze_fn(tconfig.ModelArgs(use_aaseq_embeddings=False,
                                                 **kw))
        for p in paths:
            assert tf(p) == jf(p), (kw, p)


def _retrieval_batch(vocab, rng, B=4, L=12, R=4, Lp=16):
    toks = tokens(rng, R, Lp, masks=False)
    soft = np.full((B, L), -1, np.int32)
    soft[:, 1] = np.arange(B) % R
    return {"input_ids": rng.integers(4, vocab, (B, L)).astype(np.int32),
            "seg_ids": np.ones((B, L), np.int32),
            "positions": np.broadcast_to(np.arange(L, dtype=np.int32),
                                         (B, L)).copy(),
            "soft_map": soft, "protein_tokens": toks,
            "ret_pos": np.full((B,), L - 1, np.int32),
            "ret_target_pos": (np.arange(B) % R).astype(np.int32),
            "ret_valid": np.ones((B,), bool)}


@pytest.mark.parametrize("expert", [1, 2])
def test_fusion_model_passes_lora_expert_to_the_encoder(expert):
    """unified.encode_proteins and unified.forward (retrieval, the proteins
    encoded live) on the encoder's expert: the reference's embeddings and
    loss."""
    jcfg, tcfg, params = live_models(jax_lora(num_experts=3))
    batch = _retrieval_batch(jcfg.llama.vocab_size, np.random.default_rng(11))
    tp = bridge.to_torch(params)
    want = juni.encode_proteins(params, jcfg,
                                jnp.asarray(batch["protein_tokens"]),
                                lora_expert=expert)
    got = tuni.encode_proteins(tp, tcfg,
                               torch.from_numpy(batch["protein_tokens"]),
                               lora_expert=expert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    other = tuni.encode_proteins(tp, tcfg,
                                 torch.from_numpy(batch["protein_tokens"]))
    assert not torch.allclose(other, got)
    jout = juni.forward(params, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                        retrieval=True, lora_expert=expert)
    tout = tuni.forward(tp, tcfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                        retrieval=True, lora_expert=expert)
    np.testing.assert_allclose(float(tout["retrieval_loss"]),
                               float(jout["retrieval_loss"]), atol=1e-5,
                               rtol=1e-5)
