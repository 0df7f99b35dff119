"""Rotary position embeddings, rotate-half convention (counterpart of
procyon_tpu/ops/rotary.py: rope_frequencies and flat_rotary_tables).

The flat tables act on `[B, S, H*D]` projection outputs:
rotated = x * cos_flat + x[..., perm] * sin_signed_flat, with the rotate_half
sign folded into the sin table.
"""

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0):
    """Full-width cos/sin tables [max_len, head_dim], float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32)
                                / head_dim))
    t = torch.arange(max_len, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)                  # [max_len, D/2]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)


def rope_perm(n_heads: int, head_dim: int) -> torch.Tensor:
    """Flat lane permutation of rotate_half: per head j -> (j + D/2) % D."""
    j = torch.arange(n_heads * head_dim)
    return (j // head_dim) * head_dim + ((j % head_dim) + head_dim // 2) \
        % head_dim


def flat_rotary_tables(head_dim: int, n_heads: int, max_len: int,
                       theta: float = 10000.0):
    """(cos_flat [L, H*D], sin_signed_flat [L, H*D], perm [H*D])."""
    cos, sin = rope_frequencies(head_dim, max_len, theta)
    d2 = head_dim // 2
    sign = torch.cat([-torch.ones(d2), torch.ones(d2)])
    cos_flat = cos.repeat(1, n_heads)
    sin_flat = sin.repeat(1, n_heads) * sign.repeat(n_heads)[None, :]
    return cos_flat, sin_flat, rope_perm(n_heads, head_dim)


def apply_rope_flat(x: torch.Tensor, cos: torch.Tensor,
                    sin_signed: torch.Tensor, head_dim: int) -> torch.Tensor:
    """x [..., S, H*D] with [S, H*D] tables, in x's dtype (each product and
    the sum rounded to it, as the reference computes in the activation
    dtype)."""
    perm = rope_perm(x.shape[-1] // head_dim, head_dim).to(x.device)
    c = cos.to(x.dtype)
    s = sin_signed.to(x.dtype)
    return x * c + x[..., perm] * s
