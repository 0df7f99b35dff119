"""Protein pooling with chunk regrouping (counterpart of
procyon_tpu/models/pooling.py).

Long proteins are split into several rows that share a group id; rows are
pooled, then merged back per protein as a one-hot segment sum.
"""

import torch


def pool_tokens(hidden: torch.Tensor, token_mask: torch.Tensor,
                method: str = "mean") -> torch.Tensor:
    """Pool [B, S, D] -> [B, D] over token_mask [B, S] (1 = count it), in
    hidden's dtype."""
    mask = token_mask.to(hidden.dtype)[..., None]
    if method == "mean":
        denom = mask.sum(1).clamp_min(1e-6)
        return (hidden * mask).sum(1) / denom
    if method == "max":
        masked = torch.where(mask > 0, hidden,
                             torch.tensor(-1e30, dtype=hidden.dtype,
                                          device=hidden.device))
        out = masked.amax(1)
        return torch.where(mask.sum(1) > 0, out, 0.0).to(hidden.dtype)
    if method == "cls":
        return hidden[:, 0]
    raise ValueError(f"unknown pooling method {method!r}")


def regroup_chunks(row_embeds: torch.Tensor, group_ids: torch.Tensor,
                   num_groups: int, *, row_valid=None,
                   method: str = "mean") -> torch.Tensor:
    """Merge chunk-row embeddings [R, D] into per-protein embeddings
    [num_groups, D]; row_valid [R] is 0 for padding rows."""
    if row_valid is None:
        row_valid = torch.ones(group_ids.shape, dtype=row_embeds.dtype,
                               device=row_embeds.device)
    row_valid = row_valid.to(row_embeds.dtype)
    one_hot = torch.nn.functional.one_hot(group_ids.long(), num_groups).to(
        row_embeds.dtype) * row_valid[:, None]             # [R, G]
    if method == "mean":
        sums = one_hot.t() @ row_embeds
        counts = one_hot.sum(0)[:, None].clamp_min(1e-6)
        return sums / counts
    if method == "max":
        mask = one_hot.t()[..., None] > 0
        expanded = torch.where(mask, row_embeds[None],
                               torch.tensor(-1e30, dtype=row_embeds.dtype,
                                            device=row_embeds.device))
        out = expanded.amax(1)
        return torch.where(one_hot.sum(0)[:, None] > 0, out, 0.0).to(
            row_embeds.dtype)
    raise ValueError(f"unknown regroup method {method!r}")
