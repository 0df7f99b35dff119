"""Task-banked LoRA (MoLoRA) as expert-indexed parameter banks (counterpart
of procyon_tpu/models/lora.py).

N parallel (A, B) low-rank pairs behind a leading [E, ...] axis; the active
expert is an index (`bank[idx]`), chosen per task phase, or per batch row
with a one-hot in `apply_routed`. The router's auxiliary losses belong to
training and are not ported yet (ROADMAP.md, queue 1, training slice).
"""

import dataclasses

import torch

from procyon_tpu_torch.models._init import Seed, make_generator


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    num_experts: int = 1  # 1 = plain LoRA; >1 = task-banked MoLoRA
    dtype: torch.dtype = torch.bfloat16

    @property
    def scaling(self):
        return self.alpha / self.rank


def init_params(seed: Seed, cfg: LoRAConfig, in_dim: int, out_dim: int, *,
                device="cuda"):
    """A ~ N(0, 1/in_dim), B = 0 (standard LoRA init: the delta starts at
    0)."""
    generator, device = make_generator(seed, device)
    a = torch.randn((cfg.num_experts, in_dim, cfg.rank), generator=generator,
                    device=device, dtype=torch.float32) / (in_dim ** 0.5)
    b = torch.zeros((cfg.num_experts, cfg.rank, out_dim), dtype=cfg.dtype,
                    device=device)
    return {"A": a.to(cfg.dtype), "B": b}


def apply(params, cfg: LoRAConfig, x, base_out, expert_idx=0):
    """base_out + scaling * (x @ A[e]) @ B[e]."""
    a = params["A"][expert_idx]
    b = params["B"][expert_idx]
    return base_out + cfg.scaling * ((x @ a) @ b)


def apply_routed(params, cfg: LoRAConfig, x, base_out, expert_onehot):
    """Per-row expert selection: base_out + s * (x @ A[e_b]) @ B[e_b] with
    a different expert per batch row. All E rank-r paths are computed and
    mixed with the one-hot [B, E]; one-hot mixing is exact in any dtype
    (multiply by 1, add 0), so each row matches `apply(expert_idx=e_b)`.
    x [B, T, in]."""
    oh = expert_onehot.to(x.dtype)
    xa = torch.einsum("btd,edr->betr", x, params["A"])
    xa = torch.einsum("betr,be->btr", xa, oh)
    db = torch.einsum("btr,ero->beto", xa, params["B"])
    delta = torch.einsum("beto,be->bto", db, oh)
    return base_out + cfg.scaling * delta


def merged_delta(params, cfg: LoRAConfig):
    """Average-of-experts merge: mean_e A_e @ B_e * scaling, f32."""
    deltas = torch.einsum("eir,ero->eio", params["A"].float(),
                          params["B"].float())
    return cfg.scaling * deltas.mean(0)
