"""procyon_tpu_torch's quantization quality probe against procyon_tpu's on
the CPU in f32, on the reference's parameters carried across through the
bridge (the reference test's tiny decoder: dim 256, 2 layers, vocabulary
512): the per-layer weight errors (the port quantizes with its own
quant.quantize / quantize4, which give the reference's codes) within 1e-5
relative, the CE delta within 1e-4 nats, the logit cosines within 1e-5,
the top-10 overlap equal, and the gate decisions equal. Two of
tests/test_quant_quality.py's cases on the port: a corrupted tree trips the
weight gate, and one mis-scaled int4 layer fails the spread gate alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.evaluate import quant_quality as jqq
from procyon_tpu.models import llama as jllama
from procyon_tpu_torch import bridge
from procyon_tpu_torch.evaluate import quant_quality as tqq
from procyon_tpu_torch.models import llama as tllama
from torch_cpu_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        intermediate=512, max_seq_len=64, dtype=jnp.float32,
        attn_backend="ref", remat=False)
    tcfg = tllama.LlamaConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
        intermediate=512, max_seq_len=64, dtype=torch.float32,
        attn_backend="ref", remat=False)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, bridge.to_torch(jp)


@pytest.mark.parametrize("bits,mode", [(8, "dequant"), (8, "w8a8"),
                                       (4, "dequant")])
def test_probe_matches_reference(tiny, bits, mode):
    jcfg, jp, tcfg, tp = tiny
    want = jqq.probe(bits, mode, cfg=jcfg, params=jp, batch=2, seq=32)
    got = tqq.probe(bits, mode, cfg=tcfg, params=tp, batch=2, seq=32)
    jerr = jqq.weight_errors(jp, jllama.quantize_params(jp, jcfg, bits=bits))
    terr = tqq.weight_errors(tp, tllama.quantize_params(tp, tcfg, bits=bits))
    assert set(terr) == set(jerr) and len(terr) == 7 * 2 + 1
    for k in jerr:
        assert abs(terr[k] - jerr[k]) <= 1e-5 * jerr[k], k
    assert abs(got.weight_rel_err - want.weight_rel_err) \
        <= 1e-5 * want.weight_rel_err
    assert abs(got.weight_err_spread - want.weight_err_spread) <= 1e-4
    assert abs(got.ce_delta - want.ce_delta) <= 1e-4
    assert abs(got.logit_cos_min - want.logit_cos_min) <= 1e-5
    assert got.topk_overlap == want.topk_overlap
    assert (got.gate_weight, got.gate_ce, got.gate_spread, got.gate_topk) \
        == (want.gate_weight, want.gate_ce, want.gate_spread, want.gate_topk)
    assert got.passed and want.passed
    assert set(got.as_dict()) == set(want.as_dict())


def test_topk_overlap_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4, 50)).astype(np.float32)
    b = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
    assert tqq.topk_overlap(a, b, k=10) == jqq.topk_overlap(a, b, k=10)
    assert tqq.topk_overlap(a, a, k=5) == 1.0


def test_corrupted_quantization_trips_gate(tiny):
    """A packing / scale bug (every int8 scale x37) trips the weight gate
    (tests/test_quant_quality.py:45)."""
    _, _, tcfg, tp = tiny
    q = tllama.quantize_params(tp, tcfg, bits=8)

    def corrupt(node):
        if isinstance(node, dict) and set(node) == {"q", "s"}:
            return {"q": node["q"], "s": node["s"] * 37.0}
        if isinstance(node, dict):
            return {k: corrupt(v) for k, v in node.items()}
        return node

    assert tqq.weight_reconstruction_error(tp, corrupt(q)) \
        > tqq.WEIGHT_ERR_GATES[8]


def test_mis_scaled_int4_layer_fails_spread_gate(tiny):
    """One int4 layer's w_gate scales x1.10 stays under the weight and CE
    gates and trips the spread gate (tests/test_quant_quality.py:61)."""
    _, _, tcfg, tp = tiny
    q = tllama.quantize_params(tp, tcfg, bits=4)
    wg = dict(q["layers"]["mlp"]["w_gate"])
    s = wg["s"].clone()
    s[1] *= 1.10
    wg["s"] = s
    bad = {**q, "layers": {**q["layers"], "mlp": {**q["layers"]["mlp"],
                                                  "w_gate": wg}}}
    r = tqq.probe(4, "dequant", cfg=tcfg, params=tp, qparams=bad, batch=2,
                  seq=32)
    assert r.weight_rel_err <= r.gate_weight, r.as_dict()
    assert r.ce_delta <= r.gate_ce, r.as_dict()
    assert r.weight_err_spread > r.gate_spread, r.as_dict()
    assert not r.passed


def _kl_rows(ref, got):
    """The mean over rows of KL(softmax(ref) || softmax(got)), by scipy:
    the reference's ce_delta (cross-entropy minus entropy) in another
    form."""
    from scipy.special import log_softmax
    lr, lg = log_softmax(ref, axis=-1), log_softmax(got, axis=-1)
    return float((np.exp(lr) * (lr - lg)).sum(-1).mean())


@pytest.mark.parametrize("shape", [(16, 32000), (2, 5, 300)])
def test_ce_delta_matches_the_reference_definition(shape):
    """quant_quality.ce_delta (the lines probe and chip_smoke's
    bind_ce_delta share) against the KL form, on random logits: within
    1e-6 nats (f64 logits; the two forms round differently)."""
    rng = np.random.default_rng(3)
    ref = 2.0 * rng.standard_normal(shape)
    got = ref + 0.5 * rng.standard_normal(shape)
    want = _kl_rows(ref, got)
    assert want > 0.05
    assert abs(tqq.ce_delta(ref, got) - want) <= 1e-6


def test_ce_delta_is_zero_on_equal_logits():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((16, 32000)).astype(np.float32)
    assert abs(tqq.ce_delta(ref, ref)) <= 1e-6
    assert abs(tqq.ce_delta(ref, ref + 3.0)) <= 1e-5   # a shift is no change


def test_ce_delta_of_doubled_logits_exceeds_the_w8a8_bound():
    """A doubled activation scale in the last W8A8 product doubles a
    row's logits. On N(0, 1) logits over a 32000-word vocabulary that
    costs sigma^2 / 2 = 0.5 nats a row (the tilted Gaussian's KL), over
    the reference's W8A8 bound of 0.08; with one row of the 16 doubled the
    mean is 0.5 / 16, under it: the gate sees a fault that reaches most
    rows."""
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((16, 32000))
    gate = tqq.CE_DELTA_GATES[("int8", "w8a8")]
    full = tqq.ce_delta(ref, 2.0 * ref)
    assert abs(full - 0.5) <= 0.05 and full > gate
    one = ref.copy()
    one[3] *= 2.0
    assert abs(tqq.ce_delta(ref, one) - full / 16) <= 0.01
