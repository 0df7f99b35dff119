"""Projector MLPs (counterpart of procyon_tpu/models/projectors.py).

A 1-layer projector is a single bias-free linear map; deeper ones are
[linear + bias -> exact GELU]* -> linear + bias. Inference only: dropout is
not applied.
"""

import dataclasses
from typing import List, Sequence

import torch

from procyon_tpu_torch.models._init import Seed, make_generator


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    in_dim: int
    out_dim: int
    n_layers: int = 1
    hidden_dim: int = 0  # 0 -> out_dim
    dtype: torch.dtype = torch.bfloat16


def _dims(cfg: ProjectorConfig) -> Sequence[int]:
    hidden = cfg.hidden_dim or cfg.out_dim
    if cfg.n_layers == 1:
        return [cfg.in_dim, cfg.out_dim]
    return [cfg.in_dim] + [hidden] * (cfg.n_layers - 1) + [cfg.out_dim]


def init_params(seed: Seed, cfg: ProjectorConfig, *,
                device="cuda") -> List[dict]:
    """N(0, 1/fan_in) weights `[in, out]`, zero biases (none for 1 layer).
    `seed` is an int or a generator on `device` (models/_init.py)."""
    generator, device = make_generator(seed, device)
    dims = _dims(cfg)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator, device=device,
                        dtype=torch.float32) / (d_in ** 0.5)
        layer = {"w": w.to(cfg.dtype)}
        if cfg.n_layers > 1:
            layer["b"] = torch.zeros((d_out,), dtype=cfg.dtype, device=device)
        params.append(layer)
    return params


def apply(params, cfg: ProjectorConfig, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i, layer in enumerate(params):
        x = x @ layer["w"]
        if "b" in layer:
            x = x + layer["b"]
        if i < n - 1:
            x = torch.nn.functional.gelu(x, approximate="none")
    return x
