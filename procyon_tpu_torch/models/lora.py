"""Task-banked LoRA (MoLoRA) as expert-indexed parameter banks (counterpart
of procyon_tpu/models/lora.py).

N parallel (A, B) low-rank pairs behind a leading [E, ...] axis; the active
expert is an index (`bank[idx]`), chosen per task phase, or per batch row
with a one-hot in `apply_routed`; `top1_router_losses` are the router's
auxiliary losses. With a host int `expert_idx`, `apply` reads one slice of
each bank, so a gradient reaches A[e] and B[e] and no other expert. An
index past the bank reads its last expert and trains nothing, as JAX's
clipping gather does.
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


def expert_slice(bank: torch.Tensor, expert_idx) -> torch.Tensor:
    """bank[expert_idx] with JAX's gather semantics for an index past the
    bank: the read is clamped to [0, E - 1], and the gradient of such a
    read is dropped (JAX's gather clips the index, and its transpose drops
    the out-of-bounds update). The two towers may hold banks of different
    sizes, and the trainer's phase index (up to 3) then reads a smaller
    tower's last expert without training it. A host int stays on the
    host; a tensor index is clamped on its device."""
    n = bank.shape[0]
    if isinstance(expert_idx, torch.Tensor):
        w = bank[expert_idx.clamp(0, n - 1)]
        inside = (expert_idx >= 0) & (expert_idx < n)
        return torch.where(inside, w, w.detach())
    e = int(expert_idx)
    if 0 <= e < n:
        return bank[e]
    return bank[min(max(e, 0), n - 1)].detach()


def apply(params, cfg: LoRAConfig, x, base_out, expert_idx=0):
    """base_out + scaling * (x @ A[e]) @ B[e] (expert_slice's reading of
    an index past the bank)."""
    a = expert_slice(params["A"], expert_idx)
    b = expert_slice(params["B"], expert_idx)
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


def top1_router_losses(router_logits, expert_assignment, num_experts):
    """Router auxiliary losses (mlora.py:50-75): z-loss and load-balance.
    router_logits [T, E]; expert_assignment [T] argmax assignments."""
    z = torch.logsumexp(router_logits, dim=-1)
    z_loss = (z * z).mean()
    probs = torch.softmax(router_logits, dim=-1)
    density = torch.nn.functional.one_hot(
        expert_assignment.long(), num_experts).to(probs.dtype).mean(0)
    density_proxy = probs.mean(0)
    balance_loss = num_experts * (density * density_proxy).sum()
    return {"z_loss": z_loss, "balance_loss": balance_loss}
