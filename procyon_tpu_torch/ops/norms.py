"""Normalization ops (counterpart of procyon_tpu/ops/norms.py).

Statistics in float32 whatever the input dtype; the result is cast back.
"""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    """LlamaRMSNorm: x * rsqrt(mean(x^2) + eps) * weight, stats in f32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with affine params, stats in f32 (ESM2 / torch semantics)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    cx = xf - mean
    var = cx.square().mean(-1, keepdim=True)
    y = cx * torch.reciprocal(torch.sqrt(var + eps))
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)
