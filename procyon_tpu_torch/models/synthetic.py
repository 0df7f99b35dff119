"""Structured synthetic checkpoints with stable greedy decode (counterpart
of procyon_tpu/models/synthetic.py).

Random-weight logits are chaotic: top-1 gaps among a vocabulary of many
thousands sit far below bf16 reduction noise, so two routes of different
shape (T=1 decode, T=K+1 verify, prefill) disagree in argmax almost
everywhere and speculative-decoding acceptance cannot be measured end to
end. This module constructs weights whose next-token distribution has a
large, designed top-1 margin, so greedy decode is stable across routes in
bf16 on the card, and the n-gram drafter's acceptance becomes a property of
the text structure we choose rather than of float noise.

Construction, an induced-bigram (Markov-chain) transformer:

  * the embedding table E is random (the standard init);
  * every transformer layer keeps random attention / MLP weights but its
    two residual-writing projections (attn.wo, mlp.w_down) are zero, so the
    residual stream after L layers is exactly the input embedding while the
    forward still reads and multiplies every weight (the decode cost is
    unchanged);
  * lm_head column j is margin * normalize(E[g(j)]) with g = f^-1 for a
    chosen permutation f, so after the final RMSNorm
        logit_j(token i) = margin * sqrt(D) * <e_i, e_g(j)>  (unit vectors)
    = margin * sqrt(D) at j = f(i) and about margin * N(0, 1) elsewhere: a
    sqrt(D)-sigma top-1 margin (64 sigma at dim 4096), out of reach of bf16
    noise or int8 weight quantization.

Greedy decode therefore walks the deterministic chain t -> f(t). With f a
permutation of cycles of length `period`, a generation revisits its own
trail after at most `period` tokens; from then on the slot-history n-gram
drafter (inference/speculative.py) predicts perfectly and speculative
acceptance ramps from 1 a round (cold) to K+1 a round (warm). `period` is
the dial of how repetitive the text is.

The numbers differ from the JAX package's (torch.Generator, not
jax.random); the structure and the returned permutation do not.
"""

import numpy as np
import torch

from procyon_tpu_torch.models import llama
from procyon_tpu_torch.models._init import make_generator


def cycle_permutation(vocab_size: int, period: int) -> np.ndarray:
    """f [V]: blocks of `period` consecutive ids form cycles
    (i -> i+1, block end wraps to block start); the final short block
    wraps within itself."""
    f = np.arange(vocab_size, dtype=np.int64) + 1
    for lo in range(0, vocab_size, period):
        hi = min(lo + period, vocab_size)
        f[hi - 1] = lo
    return f


def ngram_quantized_params(cfg: llama.LlamaConfig, *, period: int = 16,
                           margin: float = None, seed: int = 0,
                           device="cuda"):
    """Quantized (int8 weight-only) parameter tree matching
    llama.quantize_params(llama.init_params(...)) leaf for leaf, built
    directly in quantized form, one layer at a time, on `device`.

    margin defaults to 16 / sqrt(dim), giving a top-1 logit of about 16
    against about N(0, 0.25) off-chain logits at any dim. Returns
    (params, f) with f the induced next-token permutation [V] (numpy, for
    oracles and tests)."""
    if margin is None:
        margin = 16.0 / float(np.sqrt(cfg.dim))
    f = cycle_permutation(cfg.vocab_size, period)
    g = np.empty_like(f)
    g[f] = np.arange(cfg.vocab_size, dtype=np.int64)   # g = f^-1
    gen, device = make_generator(seed, device)
    L, hd = cfg.n_layers, cfg.head_dim

    emb = torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                      device=device, dtype=torch.float32) * 0.02
    # lm_head [D, V] column j = margin * normalize(emb[g(j)]): logits after
    # the RMSNorm land margin * sqrt(D) on the chain target
    w = emb[torch.from_numpy(g).to(device)]                        # [V, D]
    w = (w * (margin / w.norm(dim=1, keepdim=True))).t()           # [D, V]
    s = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-8) / 127.0
    lm_head = {"q": torch.round(w / s).clamp(-127, 127).to(torch.int8),
               "s": s}
    del w

    def qleaf(k, n, zero=False):
        """A stacked int8 leaf with random codes; the residual-writing
        projections get scale 0 (exact zeros that still stream)."""
        q = torch.empty((L, k, n), dtype=torch.int8, device=device)
        for i in range(L):
            q[i] = torch.randint(-8, 9, (k, n), generator=gen, device=device,
                                 dtype=torch.int8)
        scale = torch.full((L, 1, n), 0.0 if zero else 0.01,
                           dtype=torch.float32, device=device)
        return {"q": q, "s": scale}

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        "attn": {"wq": qleaf(cfg.dim, cfg.n_heads * hd),
                 "wk": qleaf(cfg.dim, cfg.n_kv_heads * hd),
                 "wv": qleaf(cfg.dim, cfg.n_kv_heads * hd),
                 "wo": qleaf(cfg.n_heads * hd, cfg.dim, zero=True)},
        "mlp": {"w_gate": qleaf(cfg.dim, cfg.intermediate),
                "w_up": qleaf(cfg.dim, cfg.intermediate),
                "w_down": qleaf(cfg.intermediate, cfg.dim, zero=True)},
        "attn_norm": ones(L, cfg.dim),
        "mlp_norm": ones(L, cfg.dim),
    }
    if cfg.lora is not None:
        r, e = cfg.lora.rank, cfg.lora.num_experts
        for name, out_dim in (("lora_wq", cfg.n_heads * hd),
                              ("lora_wv", cfg.n_kv_heads * hd)):
            layers[name] = {
                "A": torch.full((L, e, cfg.dim, r), 0.01,
                                dtype=cfg.lora.dtype, device=device),
                "B": torch.full((L, e, r, out_dim), 0.01,
                                dtype=cfg.lora.dtype, device=device)}
    params = {"embed": emb.to(cfg.dtype), "layers": layers,
              "final_norm": ones(cfg.dim), "lm_head": lm_head}
    return params, f
