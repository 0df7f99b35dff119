"""Attention reference (counterpart of procyon_tpu/ops/flash_attention.py's
`mha_reference`, bidirectional).

The Pallas flash kernels of that module (forward for Llama prefill,
backward for training) are later slices (ROADMAP.md, queue 2 rows 3, 8, 9).
ESM2 takes this path for attn_backend values other than "rowblock".
"""

import math

import torch


def mha_reference(q, k, v, seg, *, head_dim: int):
    """Plain bidirectional softmax attention with the reference's masking:
    natural exp, scores scaled by 1/sqrt(D), masked rows give 0.
    q/k/v [B, S, H*D] already rotated; seg [B, S]."""
    B, S, HD = q.shape
    H = HD // head_dim
    qh = q.reshape(B, S, H, head_dim).float()
    kh = k.reshape(B, S, H, head_dim).float()
    vh = v.reshape(B, S, H, head_dim).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(head_dim))
    allowed = ((seg[:, :, None] == seg[:, None, :])
               & (seg[:, :, None] > 0))[:, None]
    s = torch.where(allowed, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(allowed, p, 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    row_valid = allowed.any(-1).permute(0, 2, 1)[..., None]   # [B,S,1,1]
    out = torch.where(row_valid, out, 0.0)
    return out.reshape(B, S, HD).to(q.dtype)
