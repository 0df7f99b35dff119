"""The port's parallel/ package in one process: the rule table path for
path against the JAX package's spec_for, quantized leaves replicated, the
whole-kv-head departure, the rank grid and shard_batch, and the rule that
a run with no process group (or every axis at 1) takes the one-process
path bit for bit. Several ranks: tests/test_torch_parallel_{train,
serving,multihost}.py."""

import types

import jax
import numpy as np
import pytest
import torch

import procyon_tpu.models.esm2 as jesm
import procyon_tpu.models.lora as jlora
import procyon_tpu.models.unified as juni
from procyon_tpu.parallel import mesh as jmesh
from procyon_tpu.parallel import sharding as jshard
from procyon_tpu_torch import bridge, parallel
from procyon_tpu_torch.models import llama, unified
from procyon_tpu_torch.parallel import collectives, sharding
from procyon_tpu_torch.parallel.mesh import Mesh
from torch_cpu_common import one_torch_thread  # noqa: F401

MESHES = [(2, 2, 2), (1, 4, 2), (8, 1, 1), (1, 2, 4)]


def _shape(dims):
    return types.SimpleNamespace(shape=dict(zip(jmesh.AXES, dims)))


def _jax_tree():
    """A JAX unified tree with every rule's leaves: live ESM2 with LoRA
    banks, decoder LoRA banks, projectors, the lm head."""
    import jax.numpy as jnp
    cfg = juni.tiny_config()
    cfg = juni.UnifiedConfig(**{**{f: getattr(cfg, f) for f in
                                   cfg.__dataclass_fields__},
                                "llama": cfg.llama.__class__(
                                    **{**cfg.llama.__dict__,
                                       "lora": jlora.LoRAConfig(
                                           rank=4, num_experts=2,
                                           dtype=jnp.float32)}),
                                "esm": jesm.tiny_config(
                                    lora=jlora.LoRAConfig(
                                        rank=4, num_experts=2,
                                        dtype=jnp.float32))})
    return juni.init_params(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("dims", MESHES)
def test_rule_table_matches_jax_path_for_path(dims):
    """Every leaf of a full tree gets the JAX package's spec (the JAX
    rules read only the mesh's axis sizes)."""
    tree = _jax_tree()
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        p = jshard._path_str(path)
        want = tuple(jshard.spec_for(p, leaf.shape, _shape(dims)))
        got = sharding.spec_for(p, tuple(leaf.shape), _shape(dims))
        assert got == want, (p, got, want)
        n += 1
    assert n > 40
    # and the port's walk of the bridged tree visits the same paths
    ours = {p for p, _ in sharding.leaf_items(bridge.to_torch(
        bridge.to_numpy(tree)))}
    theirs = {jshard._path_str(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(tree)}
    assert ours == theirs


def test_specs_respect_divisibility():
    """test_multichip.py's case: a dim that does not divide its axis is
    replicated."""
    m = _shape((2, 2, 2))
    assert sharding.spec_for("llama/layers/attn/wq", (2, 63, 128), m)[1] \
        is None
    assert sharding.spec_for("llama/layers/attn/wq", (2, 64, 128), m) == \
        (None, "fsdp", "model")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_stay_replicated(bits):
    """int8 {"q", "s"} and int4 {"p", "s"} leaves match no rule (their
    paths end in /q, /s or /p), as in the JAX package."""
    cfg = llama.tiny_config(dim=128, n_heads=4, n_kv_heads=2,
                            intermediate=256, vocab_size=256)
    params = llama.quantize_params(llama.init_params(0, cfg, device="cpu"),
                                   cfg, bits=bits, group=32)
    specs = sharding.param_shardings(params, _shape((1, 2, 2)), cfg)
    quant = {p: s for p, s in specs.items()
             if p.rsplit("/", 1)[-1] in ("q", "s", "p")}
    assert len(quant) == 2 * 8 and all(s == () for s in quant.values())
    assert specs["embed"] == ("fsdp", None)
    for p, s in quant.items():
        assert tuple(jshard.spec_for(p, (4, 128, 128), _shape((1, 2, 2)))) \
            == ()


@pytest.mark.parametrize("model,split", [(2, True), (4, False)])
def test_whole_kv_heads_only(model, split):
    """The departure (ROADMAP.md, section 3): model 4 over 2 kv heads
    would split a head's lanes, which JAX's _fit_spec does; the port keeps
    the attention leaves whole on `model` there and still splits the
    MLP."""
    cfg = llama.tiny_config(dim=256, n_heads=4, n_kv_heads=2,
                            intermediate=512, vocab_size=512)
    params = llama.init_params(0, cfg, device="cpu")
    m = _shape((1, 1, model))
    specs = sharding.param_shardings(params, m, cfg)
    for name in ("wq", "wk", "wv", "wo"):
        p = f"layers/attn/{name}"
        jax_spec = tuple(jshard.spec_for(p, params["layers"]["attn"][name]
                                         .shape, m))
        assert "model" in jax_spec
        assert ("model" in specs[p]) == split, (p, specs[p])
    for name in ("w_gate", "w_up", "w_down"):
        assert "model" in specs[f"layers/mlp/{name}"]
    # the forward's kv heads a rank, read from the rank's leaves; quantized
    # leaves stay whole, so their attention runs on every kv head, and a
    # slice quantized afterwards is refused
    mesh = Mesh((1, 1, model), 0, {"model": "the model group"})
    local = sharding.shard_params(params, mesh, specs=specs, axes=("model",))
    assert llama.local_kv_heads(local, cfg, mesh) == (2 // model if split
                                                      else 2)
    whole_q = sharding.shard_params(llama.quantize_params(params, cfg), mesh,
                                    cfg, axes=("model",))
    assert llama.local_kv_heads(whole_q, cfg, mesh) == 2
    with pytest.raises(ValueError, match="quantize the whole tree"):
        llama.local_kv_heads(llama.quantize_params(local, cfg), cfg, mesh)
    with pytest.raises(ValueError, match="whole heads"):
        sharding.param_shardings(params, m)


@pytest.mark.parametrize("n,cfg", [
    (8, (1, -1, 1)), (8, (2, -1, 2)), (4, (-1, 1, 2)), (1, (1, -1, 1)),
    (6, (3, 2, 1))])
def test_mesh_resolve_and_coords_match_jax(n, cfg):
    got = parallel.MeshConfig(*cfg).resolve(n)
    assert got == jmesh.MeshConfig(*cfg).resolve(n)
    grid = np.arange(n).reshape(got)
    for r in range(n):
        m = Mesh(got, r, {})
        idx = tuple(m.coords[a] for a in parallel.AXES)
        assert grid[idx] == r
        assert m.index("batch") == idx[0] * got[1] + idx[1]


def test_mesh_without_a_group():
    """No process group: one rank, every axis 1, no groups; a layout of
    more ranks is refused, as JAX's resolve refuses more devices than it
    has."""
    m = parallel.create_mesh()
    assert m.trivial and m.group("model") is None and m.size("batch") == 1
    with pytest.raises(AssertionError, match="devices"):
        parallel.create_mesh(parallel.MeshConfig(1, 2, 1))


def test_shard_batch_rows_and_banks():
    """Per-example rows split over data x fsdp (data major), the banks
    and scalars whole, a batch the ranks do not divide refused."""
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 9, (8, 5)),
             "ret_valid": np.ones(8, bool),
             "protein_embeds": rng.standard_normal((3, 4)),
             "protein_tokens": rng.integers(0, 9, (6, 7)),
             "yes_token": np.int32(5), "max_position": 4}
    got = []
    for r in range(8):
        m = Mesh((2, 2, 2), r, {})
        local = parallel.shard_batch(batch, m)
        assert local["protein_embeds"] is batch["protein_embeds"]
        assert local["protein_tokens"] is batch["protein_tokens"]
        assert local["max_position"] == 4
        b = m.index("batch")
        np.testing.assert_array_equal(local["input_ids"],
                                      batch["input_ids"][2 * b:2 * b + 2])
        got.append(local["input_ids"])
    # the model ranks of one batch block hold the same rows
    np.testing.assert_array_equal(got[0], got[1])
    with pytest.raises(ValueError, match="do not divide"):
        parallel.shard_batch({"input_ids": np.zeros((6, 2))},
                             Mesh((4, 1, 1), 0, {}))


@pytest.mark.parametrize("dims", MESHES)
def test_batch_sharding_and_replicate_as_jax(dims):
    """The JAX package's surface: a per-example array's spec is JAX's
    batch_sharding spec; replicate moves nothing (every rank builds the
    same tree from the same seed)."""
    jm = jmesh.create_mesh(jmesh.MeshConfig(*dims))
    for ndim in (1, 2, 3):
        assert parallel.batch_sharding(None, ndim) == tuple(
            jshard.batch_sharding(jm, ndim).spec)
    tree = {"w": torch.ones(2), "layers": {"b": torch.zeros(3)}}
    assert parallel.replicate(tree) is tree


def test_no_group_takes_the_one_process_path():
    """mesh=None, a trivial mesh and the collectives on no group leave
    every number as it was: the same bits."""
    cfg = unified.tiny_config(esm=None, protein_embed_dim=16)
    params = unified.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    B, L = 2, 12
    batch = {"input_ids": torch.from_numpy(rng.integers(4, 200, (B, L))),
             "labels": torch.from_numpy(rng.integers(0, 200, (B, L))),
             "protein_embeds": torch.randn(2, 16),
             "ret_pos": torch.full((B,), L - 1),
             "ret_target_pos": torch.tensor([0, 1]),
             "ret_valid": torch.ones(B, dtype=torch.bool)}
    a = unified.forward(params, cfg, batch, retrieval=True)
    for mesh in (None, parallel.create_mesh()):
        b = unified.forward(params, cfg, batch, retrieval=True, mesh=mesh)
        for k in ("logits", "lm_loss", "retrieval_loss"):
            assert torch.equal(a[k], b[k]), k
    x = torch.randn(3, 4)
    for fn in (collectives.copy_to, collectives.reduce_from,
               collectives.split_to, collectives.gather_from,
               collectives.all_gather_batch):
        assert fn(x, None) is x
    t, c = torch.tensor(5.0), torch.tensor(0)
    assert torch.equal(collectives.global_mean(t, c, None),
                       t / c.clamp_min(1))
