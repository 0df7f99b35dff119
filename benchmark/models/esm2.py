"""ESM2 configurations: the sizes a configuration file states, the raw
weights the benchmark draws from the seed, and the program's model built on
them.

The raw weights are what the benchmark hands to both sides: bf16 tensors in
the port's stacked tree layout ({"embed", "layers": {...}, "final_norm",
"lm_head"}), drawn on the device by one generator in a fixed order, a few
large calls (one per stacked leaf). The same seed on the same device gives
the same tensors, so the reference draws them again instead of reading the
program's copy.
"""

import torch

# the stream of the weights' generator, apart from the traffic's
WEIGHT_STREAM = 0x5EED


def dims(cfg):
    """The sizes the reference and the metrics read, from a configuration
    file's published keys."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"dim": d, "layers": cfg["num_hidden_layers"], "heads": heads,
            "head_dim": d // heads, "ffn": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"], "eps": cfg["layer_norm_eps"],
            "max_positions": cfg["max_position_embeddings"]}


def generator(seed, device, stream=WEIGHT_STREAM):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % 2 ** 63)
    return g


def raw_weights(cfg, seed, device, *, lora=None):
    """The encoder's weights in bf16: dense weights N(0, 1/fan_in), the
    embedding N(0, 0.02^2), biases N(0, 0.02^2), norm scales 1 + N(0,
    0.02^2). lora: {"rank", "experts", "targets"} adds MoLoRA banks
    `lora_<name>` {A [L, E, in, r] ~ N(0, 1/in), B zeros}."""
    m = dims(cfg)
    g = generator(seed, device)
    L, d, F, V = m["layers"], m["dim"], m["ffn"], m["vocab"]
    bf = torch.bfloat16

    def normal(shape, std, mean=0.0):
        w = torch.randn(shape, generator=g, device=device, dtype=bf)
        w.mul_(std)
        return w.add_(mean) if mean else w

    layers = {
        "attn": {n: normal((L, d, d), d ** -0.5)
                 for n in ("wq", "wk", "wv", "wo")},
        "mlp": {"w1": normal((L, d, F), d ** -0.5),
                "w2": normal((L, F, d), F ** -0.5)},
    }
    for n in ("bq", "bk", "bv", "bo"):
        layers["attn"][n] = normal((L, d), 0.02)
    layers["mlp"]["b1"] = normal((L, F), 0.02)
    layers["mlp"]["b2"] = normal((L, d), 0.02)
    for n in ("attn_norm", "mlp_norm"):
        layers[n] = {"w": normal((L, d), 0.02, 1.0), "b": normal((L, d),
                                                                  0.02)}
    if lora is not None:
        for name in LORA_TARGETS[lora["targets"]]:
            fan_in, fan_out = lora_dims(m, name)
            a = normal((L, lora["experts"], fan_in, lora["rank"]),
                       fan_in ** -0.5)
            layers[f"lora_{name}"] = {"A": a, "B": torch.zeros(
                (L, lora["experts"], lora["rank"], fan_out), dtype=bf,
                device=device)}
    return {
        "embed": normal((V, d), 0.02),
        "layers": layers,
        "final_norm": {"w": normal((d,), 0.02, 1.0), "b": normal((d,), 0.02)},
        "lm_head": {"dense_w": normal((d, d), d ** -0.5),
                    "dense_b": normal((d,), 0.02),
                    "norm": {"w": normal((d,), 0.02, 1.0),
                             "b": normal((d,), 0.02)},
                    "bias": normal((V,), 0.02).float()},
    }


def cast_tree(tree, dtype):
    """The tree with its floating leaves in `dtype` (the CPU tests run the
    program in f32)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def raw_projector(cfg, seed, device):
    """The shared projector's bias-free weight [dim, retrieval_dim] in
    bf16, N(0, 1/dim)."""
    m = dims(cfg)
    g = generator(seed, device, stream=WEIGHT_STREAM + 1)
    w = torch.randn((m["dim"], cfg["projector"]["retrieval_dim"]),
                    generator=g, device=device, dtype=torch.bfloat16)
    return w.mul_(m["dim"] ** -0.5)


# the projections each LoRA target set covers (the port's lora_targets)
LORA_TARGETS = {"attn": ("wq", "wk", "wv"), "mlp": ("wo", "w1", "w2"),
                "default": ("wq", "wk", "wv", "wo", "w1", "w2")}


def lora_dims(m, name):
    d, F = m["dim"], m["ffn"]
    return {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
            "w1": (d, F), "w2": (F, d)}[name]


def port_esm_config(cfg, *, dtype=torch.bfloat16, lora=None, remat=False):
    """The program's ESM2Config for a configuration file: its published
    sizes, its layout's attention route and int8 mode."""
    from procyon_tpu_torch.models import esm2
    from procyon_tpu_torch.models import lora as lora_mod
    m = dims(cfg)
    layout = cfg["layout"]
    kw = {}
    if lora is not None:
        kw = dict(lora=lora_mod.LoRAConfig(
            rank=lora["rank"], alpha=lora["alpha"],
            num_experts=lora["experts"], dtype=dtype),
            lora_targets=lora["targets"])
    return esm2.ESM2Config(
        vocab_size=m["vocab"], dim=m["dim"], n_layers=m["layers"],
        n_heads=m["heads"], norm_eps=m["eps"],
        max_seq_len=m["max_positions"], token_dropout=cfg["token_dropout"],
        dtype=dtype, attn_backend=layout["attn_backend"], remat=remat,
        quant_mode="w8a8" if layout["weights"] == "w8a8" else "dequant",
        **kw)


def port_unified_config(cfg, esm_cfg, *, dtype=torch.bfloat16):
    """The encoder-only UnifiedConfig (no decoder): the encoder and the
    shared projector."""
    from procyon_tpu_torch.models import unified
    p = cfg["projector"]
    return unified.UnifiedConfig(
        llama=None, esm=esm_cfg, retrieval_dim=p["retrieval_dim"],
        retrieval_projector_layers=p["layers"], protein_pooling="mean",
        dtype=dtype)


def port_serving_params(raw, cfg, esm_cfg):
    """The encoder's tree in the configuration's layout: as drawn (bf16,
    q / k / v apart), or the serving layout (int8 weights, q / k / v
    fused)."""
    from procyon_tpu_torch.models import esm2
    layout = cfg["layout"]
    tree = raw
    if layout["weights"] == "w8a8":
        tree = esm2.quantize_params(tree, esm_cfg)
    if layout["fused_qkv"]:
        tree = esm2.fuse_qkv_params(tree)
    return tree
