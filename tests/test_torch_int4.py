"""The port's int4 weight path against procyon_tpu's on the same numpy
inputs, f32 on the CPU: ops/quant.py (quantize4, dequantize4, qmatmul4,
quantize_tree4), ops/int4_matmul.py (the kernel's plain version against the
reference's Pallas kernels in interpret mode), llama.quantize_params(bits=4)
and the decoder's logits with int4 weights.

Packed bytes and f32 scales are a data contract: equal bit for bit.
Tolerances of the products are stated where they are used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.inference import kv_pool as jkv
from procyon_tpu.models import llama as jllama
from procyon_tpu.ops import int4_matmul as jint4
from procyon_tpu.ops import quant as jquant
from procyon_tpu_torch import bridge
from procyon_tpu_torch.inference import kv_pool as tkv
from procyon_tpu_torch.models import llama as tllama
from procyon_tpu_torch.ops import int4_matmul as tint4
from procyon_tpu_torch.ops import quant as tquant

# x @ W at k <= 512 in f32, sums in another order
F32_TOL = dict(atol=2e-4, rtol=2e-4)


def _w(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,group", [
    ((256, 128), 64), ((256, 128), 128), ((512, 384), 128),
    ((3, 256, 128), 64), ((2, 512, 128), 128)])
def test_quantize4_bytes_and_scales_equal(shape, group):
    rng = np.random.default_rng(sum(shape) + group)
    w = _w(rng, *shape) * rng.uniform(0.01, 3.0, shape[-1]).astype(np.float32)
    w[..., 0, :] = 0.0
    w[..., :, 1] = 0.0                       # a zero group column: 1e-8 floor
    want = jquant.quantize4(jnp.asarray(w), group=group)
    got = tquant.quantize4(torch.from_numpy(w), group=group)
    assert got["p"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["p"].numpy(), np.asarray(want["p"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    # and back, exactly (f32: one product of an integer and the scale)
    np.testing.assert_array_equal(
        tquant.dequantize4(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize4(want, jnp.float32)))
    np.testing.assert_array_equal(
        tquant.dequantize4(got).float().numpy(),
        np.asarray(jquant.dequantize4(want).astype(jnp.float32)))


def test_pack_unpack_exact_for_representable_weights():
    """Weights that are integer multiples of their group scale come back
    exactly, negative high nibbles included."""
    rng = np.random.default_rng(1)
    k, n, group = 256, 16, 64
    q = rng.integers(-7, 8, (k, n)).astype(np.float32)
    q[::group] = 7.0                         # every group's amax is 7
    scale = rng.uniform(0.5, 2.0, (k // group, 1, n)).astype(np.float32)
    w = (q.reshape(k // group, group, n) * scale).reshape(k, n)
    qw = tquant.quantize4(torch.from_numpy(w), group=group)
    np.testing.assert_array_equal(tquant.unpack4(qw["p"]).numpy(), q)
    np.testing.assert_allclose(qw["s"].numpy(), scale, rtol=1e-6)
    np.testing.assert_allclose(
        tquant.dequantize4(qw, torch.float32).numpy(), w, rtol=1e-6)
    # the signed byte is q_hi * 16 + (q_lo + 8)
    want = (q[k // 2:] * 16 + q[:k // 2] + 8).astype(np.int8)
    np.testing.assert_array_equal(qw["p"].numpy(), want)


def test_quantize_tree4_falls_back_to_int8():
    rng = np.random.default_rng(2)
    tree = {"attn": {"wq": _w(rng, 2, 256, 64), "wo": _w(rng, 2, 192, 64)},
            "mlp": {"w_down": _w(rng, 2, 128, 64)},
            "attn_norm": np.ones((2, 64), np.float32)}
    want = jquant.quantize_tree4(jax.tree_util.tree_map(jnp.asarray, tree),
                                 group=64)
    got = tquant.quantize_tree4(bridge.to_torch(tree), group=64)
    assert tquant.is_quantized4(got["attn"]["wq"])          # 256 % 128 == 0
    assert tquant.is_quantized(got["attn"]["wo"])           # 192: int8
    assert tquant.is_quantized4(got["mlp"]["w_down"])
    assert isinstance(got["attn_norm"], torch.Tensor)
    for name, sub in (("attn", "wq"), ("mlp", "w_down")):
        for key in ("p", "s"):
            np.testing.assert_array_equal(
                got[name][sub][key].numpy(), np.asarray(want[name][sub][key]))
    np.testing.assert_array_equal(got["attn"]["wo"]["q"].numpy(),
                                  np.asarray(want["attn"]["wo"]["q"]))
    # the reference quantizes a stacked int8 leaf under lax.map, where XLA
    # turns `/ 127.0` into a product with the reciprocal: one f32 ulp
    np.testing.assert_allclose(got["attn"]["wo"]["s"].numpy(),
                               np.asarray(want["attn"]["wo"]["s"]),
                               rtol=2e-7, atol=0)


def _cfgs(**kw):
    base = dict(attn_backend="ref", remat=False, dim=256, n_heads=4,
                n_kv_heads=2, intermediate=512, vocab_size=384)
    base.update(kw)
    jcfg = jllama.tiny_config(**base)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.float32
    return jcfg, tllama.LlamaConfig(**fields)


@pytest.fixture(scope="module")
def int4_model():
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    jq = jllama.quantize_params(params, jcfg, bits=4, group=64)
    tq = tllama.quantize_params(bridge.to_torch(params), tcfg, bits=4,
                                group=64)
    return jcfg, tcfg, jq, tq


def test_quantize_params_bits4_leaf_for_leaf(int4_model):
    """The port's own int4 tree and the bridged JAX tree are the same
    bytes: the bridge takes {"p", "s"} leaves as they are."""
    jcfg, tcfg, jq, tq = int4_model
    bridged = bridge.to_torch(jq)
    flat_j = jax.tree_util.tree_leaves_with_path(jq)
    flat_t = jax.tree_util.tree_leaves_with_path(bridge.to_numpy(tq))
    flat_b = jax.tree_util.tree_leaves_with_path(bridge.to_numpy(bridged))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t] \
        == [p for p, _ in flat_b]
    for (path, a), (_, b), (_, c) in zip(flat_j, flat_t, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
        np.testing.assert_array_equal(np.asarray(a), c, err_msg=str(path))
    assert tquant.is_quantized4(tq["layers"]["mlp"]["w_down"])
    assert tq["layers"]["attn"]["wq"]["p"].shape == (2, 128, 256)
    assert tq["layers"]["attn"]["wq"]["s"].shape == (2, 4, 1, 256)
    assert tquant.is_quantized4(tq["lm_head"])
    assert tq["embed"].dtype == torch.float32


@pytest.mark.parametrize("rows", [(1,), (5,), (16,), (2, 3)])
@pytest.mark.parametrize("k,n,group", [(256, 128, 64), (512, 256, 128)])
def test_qmatvec4_ref_against_pallas_interpret(rows, k, n, group):
    rng = np.random.default_rng(k + n + len(rows))
    qw_j = jquant.quantize4(jnp.asarray(_w(rng, k, n)), group=group)
    qw_t = bridge.to_torch(qw_j)
    x = _w(rng, *rows, k)
    got = tint4.qmatvec4_ref(torch.from_numpy(x), qw_t)
    assert got.shape == (*rows, n) and got.dtype == torch.float32
    assert tint4.qmatvec4(torch.from_numpy(x), qw_t).equal(got)   # CPU route
    # the affine kernel: the same function (integer dots in f32, scale
    # after the dot), sums in another order
    affine = jint4.qmatvec4(jnp.asarray(x), qw_j, interpret=True,
                            impl="affine")
    np.testing.assert_allclose(got.numpy(), np.asarray(affine), **F32_TOL)
    # x @ dequantize4 rounds q * s to f32 before the product: f32 again
    deq = torch.from_numpy(x) @ tquant.dequantize4(qw_t, torch.float32)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), **F32_TOL)
    # the dq kernel rounds the group scale to bf16 and then q * s to bf16
    # before its dot: up to 2^-8 relative a weight, and the scale's part
    # of it is the same for a whole group, so it does not average out.
    # Held to 2^-6 of the largest output
    dq = jint4.qmatvec4(jnp.asarray(x), qw_j, interpret=True, impl="dq")
    np.testing.assert_allclose(got.numpy(), np.asarray(dq), rtol=0,
                               atol=2.0 ** -6 * float(got.abs().max()))


def test_qmatvec4_ref_bf16_close_to_dequant_route():
    """In bf16 the two routes are different functions: the plain version
    keeps the nibbles exact and applies the f32 scale to an f32 dot, the
    dequantize route rounds q * s to bf16 first (2^-9 relative a weight,
    sqrt(k) of them add up). Held to 3 bf16 ulps of the output's scale."""
    rng = np.random.default_rng(9)
    k, n = 512, 256
    qw = tquant.quantize4(torch.from_numpy(_w(rng, k, n)), group=128)
    x = torch.from_numpy(_w(rng, 16, k)).to(torch.bfloat16)
    got = tint4.qmatvec4_ref(x, qw)
    assert got.dtype == torch.bfloat16
    deq = x @ tquant.dequantize4(qw, torch.bfloat16)
    scale = deq.float().abs().max().item()
    err = (got.float() - deq.float()).abs().max().item()
    assert err <= 3 * 2 ** -8 * scale


def test_qmatvec4_refuses_bad_inputs():
    rng = np.random.default_rng(3)
    qw = tquant.quantize4(torch.from_numpy(_w(rng, 256, 128)), group=64)
    with pytest.raises(ValueError, match="against p"):
        tint4.qmatvec4(torch.zeros(2, 128), qw)
    with pytest.raises(ValueError, match=r"p \[k/2, n\]"):
        tint4.qmatvec4(torch.zeros(2, 256),
                       {"p": qw["p"][None], "s": qw["s"][None]})
    with pytest.raises(ValueError, match="no int4 matmul for device"):
        tint4.qmatvec4(torch.zeros(2, 256, device="meta"), qw)


# the Llama-3-8B weight shapes (k, n) a decode forward multiplies
LLAMA3_8B_SHAPES = dict(wq=(4096, 4096), wk=(4096, 1024),
                        w_gate=(4096, 14336), w_down=(14336, 4096),
                        lm_head=(4096, 128256))


def _blocks(rows, n, plan):
    row_tile, col_tile, slices = plan
    return -(-rows // row_tile) * (n // col_tile) * slices


def test_k_split_fills_the_card():
    """The wrapper's grid rule (`plan`) at the Llama-3-8B shapes, 16 rows:
    one row tile; narrow weights are split over k (in whole groups, each
    tile's slices one cluster of at most 16 blocks), the head is not, and
    every shape has a block for each of the H100's 132 SMs."""
    plans = {name: tint4.plan(16, n, (k // 2) // 128)
             for name, (k, n) in LLAMA3_8B_SHAPES.items()}
    assert plans == dict(wq=(16, 128, 8), wk=(16, 64, 16),
                         w_gate=(16, 128, 2), w_down=(16, 128, 8),
                         lm_head=(16, 128, 1))
    for name, (k, n) in LLAMA3_8B_SHAPES.items():
        assert _blocks(16, n, plans[name]) >= tint4.SMS, name


@pytest.mark.parametrize("rows", [1, 16, 256])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B_SHAPES))
def test_plan_fills_the_card_within_what_the_kernel_takes(name, rows):
    """At every shape and row count the kernel meets: at least one block an
    SM, a column tile that divides n, row tiles of 16 or 32, and at most
    16 slices (the largest cluster), each the same number of groups."""
    k, n = LLAMA3_8B_SHAPES[name]
    groups = (k // 2) // 128
    row_tile, col_tile, slices = tint4.plan(rows, n, groups)
    assert row_tile == (16 if rows <= 16 else 32)
    assert col_tile in tint4.COL_TILES and n % col_tile == 0
    assert 1 <= slices <= min(tint4.MAX_SLICES, groups)
    assert groups % slices == 0
    assert _blocks(rows, n, (row_tile, col_tile, slices)) >= tint4.SMS


@pytest.mark.parametrize("rows,n,groups", [
    (1, 128, 1), (4, 256, 2), (100, 1792, 16), (256, 2176, 16),
    (16, 512, 56), (33, 384, 3)])
def test_plan_stays_within_what_the_kernel_takes(rows, n, groups):
    """Small and odd shapes: slices never exceed the groups there are and
    divide them, and the column tile divides n (every n the wrapper takes
    is a multiple of 128)."""
    row_tile, col_tile, slices = tint4.plan(rows, n, groups)
    assert n % col_tile == 0 and col_tile in tint4.COL_TILES
    assert 1 <= slices <= min(tint4.MAX_SLICES, groups)
    assert groups % slices == 0
    assert row_tile * -(-rows // row_tile) >= rows


class _OnCard:
    """Stands in for a CUDA tensor in qmatmul4's dispatch: the route
    depends on the row count and the shapes alone."""


def test_qmatmul4_dispatch(monkeypatch):
    rng = np.random.default_rng(5)
    calls = []
    monkeypatch.setattr(tint4, "qmatvec4",
                        lambda x, qw: calls.append(tuple(x.shape))
                        or tint4.qmatvec4_ref(x, qw))
    qw = tquant.quantize4(torch.from_numpy(_w(rng, 256, 128)), group=64)
    x = torch.from_numpy(_w(rng, 4, 64, 256))
    out = tquant.qmatmul4(x, qw)                       # 256 rows: kernel
    assert calls == [(4, 64, 256)] and out.shape == (4, 64, 128)
    assert tquant.mm(x, qw).equal(out) and len(calls) == 2
    big = torch.from_numpy(_w(rng, 257, 256))
    deq = tquant.qmatmul4(big, qw)                     # 257 rows: dequantize
    assert len(calls) == 2
    assert deq.equal(big @ tquant.dequantize4(qw, torch.float32))
    # n not a multiple of 128, and a stacked leaf: dequantize
    qn = tquant.quantize4(torch.from_numpy(_w(rng, 256, 96)), group=64)
    tquant.qmatmul4(x[0], qn)
    stacked = tquant.quantize4(torch.from_numpy(_w(rng, 2, 256, 128)),
                               group=64)
    assert tquant.qmatmul4(x[0], stacked).shape == (2, 64, 128)
    assert len(calls) == 2
    assert tquant.takes_kernel4(256, qw) and not tquant.takes_kernel4(257, qw)
    assert not tquant.takes_kernel4(1, qn)
    assert not tquant.takes_kernel4(1, stacked)


def test_cuda_tensor_launches_or_raises(monkeypatch):
    """On a CUDA tensor the wrapper goes to `_launch` and nowhere else: a
    failure there is not caught and never gives way to the plain version or
    the dequantize route."""
    class Boom(RuntimeError):
        pass

    def launch(x, qw):
        raise Boom("nvcc failed")

    monkeypatch.setattr(tint4, "_launch", launch)
    monkeypatch.setattr(tint4, "qmatvec4_ref",
                        lambda x, qw: pytest.fail("fell back to plain"))
    qw = tquant.quantize4(torch.zeros(256, 128), group=64)

    class FakeCuda:
        is_cuda = True
        shape = (2, 256)

        def numel(self):
            return 512

    with pytest.raises(Boom):
        tquant.qmatmul4(FakeCuda(), qw)


def test_forward_logits_with_int4_weights(int4_model):
    """llama.forward on the int4 tree. The reference dequantizes on the
    CPU (its kernel is for the TPU), the port's CPU route is the kernel's
    plain version: the same f32 function up to the order of its sums.
    2e-4 on logits, the tolerance of the int8 tests."""
    jcfg, tcfg, jq, tq = int4_model
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = jllama.forward(jq, jcfg, tokens=jnp.asarray(tokens))["logits"]
    got = tllama.forward(tq, tcfg, tokens=torch.from_numpy(tokens))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_paged_forward_logits_with_int4_weights(int4_model):
    jcfg, tcfg, jq, tq = int4_model
    base = dict(n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads,
                head_dim=jcfg.head_dim, page_size=4, n_pages=24,
                max_pages_per_seq=6, slots=3)
    jp = jkv.PagedConfig(dtype=jnp.float32, **base)
    tp = tkv.PagedConfig(dtype=torch.float32, **base)
    alloc = jkv.PageAllocator(jp)
    table = np.zeros((3, 6), np.int32)
    for s in (0, 2):
        pages = alloc.allocate(s, 20)
        table[s, :len(pages)] = pages
    jpool = {**jkv.init_pool(jp), "page_table": jnp.asarray(table)}
    tpool = tkv.init_pool(tp, device="cpu")
    tpool["page_table"] = torch.from_numpy(table.copy())
    slots = np.asarray([0, 2], np.int32)
    rng = np.random.default_rng(7)
    for T in (7, 1, 1, 4):          # prefill, two decode steps, a verify
        tokens = rng.integers(3, jcfg.vocab_size, (2, T)).astype(np.int32)
        want, jpool = jllama.paged_forward(
            jq, jcfg, jpool, jp, jnp.asarray(slots),
            tokens=jnp.asarray(tokens))
        got, _ = tllama.paged_forward(
            tq, tcfg, tpool, tp, torch.from_numpy(slots),
            tokens=torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
