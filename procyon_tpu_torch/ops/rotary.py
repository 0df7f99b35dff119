"""Rotary position embeddings, rotate-half convention (counterpart of
procyon_tpu/ops/rotary.py: rope_frequencies, flat_rotary_tables,
apply_rotary_flat and apply_rotary_flat_decode).

The flat tables act on `[B, S, H*D]` projection outputs:
rotated = x * cos_flat + x[..., perm] * sin_signed_flat, with the rotate_half
sign folded into the sin table. A model with fewer key/value heads than
query heads builds one set of tables per head count.
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


def flat_rotary_at(positions: torch.Tensor, head_dim: int, n_heads: int,
                   theta: float = 10000.0):
    """The rows of flat_rotary_tables at `positions` [B, S]: (cos_g
    [B, S, H*D], sin_signed_g [B, S, H*D], perm [H*D]) in f32 on the
    positions' device. The same numbers as gathering the [max_len, H*D]
    tables (angle = float(position) * inv_freq either way) without
    building them: at Llama-3 widths the two tables are 8192 x 4096."""
    dev = positions.device
    inv_freq = (1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                              dtype=torch.float32)
                                 / head_dim))).to(dev)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    cos_g = torch.cat([cos, cos], -1).repeat(1, 1, n_heads)
    sin_g = torch.cat([-sin, sin], -1).repeat(1, 1, n_heads)
    return cos_g, sin_g, rope_perm(n_heads, head_dim).to(dev)


def apply_rope_flat(x: torch.Tensor, cos: torch.Tensor,
                    sin_signed: torch.Tensor, head_dim: int) -> torch.Tensor:
    """x [..., S, H*D] with [S, H*D] tables, in x's dtype (each product and
    the sum rounded to it, as the reference computes in the activation
    dtype)."""
    perm = rope_perm(x.shape[-1] // head_dim, head_dim).to(x.device)
    c = cos.to(x.dtype)
    s = sin_signed.to(x.dtype)
    return x * c + _LanePermutation.apply(x, perm) * s


class _LanePermutation(torch.autograd.Function):
    """x[..., perm] for rope_perm's perm, differentiated by a gather with the
    same perm: rotating each head's lanes by D/2 twice is the identity, so
    perm is its own inverse. Indexing's own backward is an accumulating
    scatter: a sort and about 2 ms a call at the Llama-3-8B training shape
    on the H100, a fifth of a train step's device time; 4.2 ms a call on
    ESM2-3B's q and k at B8 x S1026 (306 of an MLM step's 1,666 ms)."""

    @staticmethod
    def forward(ctx, x, perm):
        ctx.save_for_backward(perm)
        return x[..., perm]

    @staticmethod
    def backward(ctx, grad):
        perm, = ctx.saved_tensors
        return grad[..., perm], None


def apply_rotary_flat(x_flat: torch.Tensor, cos_g: torch.Tensor,
                      sin_signed_g: torch.Tensor,
                      perm: torch.Tensor) -> torch.Tensor:
    """x_flat [B, S, H*D]; cos_g / sin_signed_g [B, S, H*D], the tables
    gathered at each token's position, in x's dtype; perm [H*D] the lane
    permutation of flat_rotary_tables."""
    rotated = _LanePermutation.apply(x_flat, perm.to(x_flat.device))
    return x_flat * cos_g + rotated * sin_signed_g


def apply_rotary_flat_decode(x_flat: torch.Tensor, cos_g: torch.Tensor,
                             sin_signed_g: torch.Tensor,
                             head_dim: int) -> torch.Tensor:
    """apply_rotary_flat for single-token decode shapes: per-head half
    slices and a concatenation instead of the permutation gather. The same
    function of its inputs."""
    *lead, HD = x_flat.shape
    x4 = x_flat.reshape(*lead, HD // head_dim, head_dim)
    d2 = head_dim // 2
    rot = torch.cat([x4[..., d2:], x4[..., :d2]], dim=-1)
    return x_flat * cos_g + rot.reshape(x_flat.shape) * sin_signed_g
