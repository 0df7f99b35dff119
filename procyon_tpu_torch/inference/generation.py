"""Autoregressive generation (counterpart of
procyon_tpu/inference/generation.py).

  * greedy / temperature / nucleus sampling
  * diverse (grouped) beam search with the Hamming diversity penalty
  * left-padded ragged prompts via segment ids + positions
  * EOS early stop

The decode loops are Python loops over one cache-aware forward per token;
every per-step quantity (tokens, scores, done flags, the cache) stays on
the parameters' device and the tokens are read back by the caller at the
end. The dense KV cache is updated in place (models/llama.py). Beam
reordering is a gather on the cache rows, as in the reference.

Batches are dicts of tensors on the parameters' device, prompts
left-padded by the collator so all rows decode in lockstep.
"""

import dataclasses
from typing import Optional

import torch

from procyon_tpu_torch.models import llama, unified
from procyon_tpu_torch.ops import quant

# `generate` reads `done.all()` back from the device once in this many
# steps; in between, finished rows go on emitting pad tokens, so the
# result does not depend on it
EOS_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 200
    eos_token_id: int = 2
    pad_token_id: int = 0
    method: str = "greedy"  # greedy | sample | nucleus | beam
    temperature: float = 1.0
    top_p: float = 0.9
    # diverse beam search (the caption CLI: beam 10, groups of 2,
    # diversity 0.8)
    beam_size: int = 10
    beam_group_size: int = 2
    diversity_penalty: float = 0.8


def _nucleus_filter(logits, top_p):
    """Keep the smallest prefix of sorted probs with cumsum >= top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp_max(
        logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits < cutoff, -1e30, logits)


def _last_logits(params, hidden):
    """LM-head logits of the last position only, f32 [B, V]. The prefill
    asks the model for hidden states alone: a [B, L, vocab] product of which
    one row is read would be gigabytes at Llama-3 widths."""
    return quant.mm(hidden[:, -1], params["llama"]["lm_head"]).float()


def _prefill(params, cfg, batch, cache):
    """Prompt forward into the cache. Returns (last-position logits, cache,
    the prompt's highest position). That one number is read from the device
    here, once per generation, so that every later step can hand the model
    its position bound from the host."""
    top = int(batch["positions"].max())
    out = unified.forward(params, cfg, batch, kv_cache=cache,
                          want_logits=False, max_position=top)
    return _last_logits(params, out["hidden"]), out["kv_cache"], top


def _decode_fn(params, cfg, token, position, seg, cache, max_position=None):
    """One-token forward through the cache. token [B, 1]. The token is an
    ordinary vocabulary token (no soft-token slot), so its embedding is the
    table's row and the decoder is called directly. max_position: the
    host-side bound of `position` (llama.forward)."""
    out = llama.forward(params["llama"], cfg.llama, tokens=token,
                        seg_ids=seg, positions=position, kv_cache=cache,
                        max_position=max_position)
    return out["logits"][:, -1], out["kv_cache"]


@torch.no_grad()
def generate(params, cfg: unified.UnifiedConfig, batch,
             gen: GenerationConfig,
             rng: Optional[torch.Generator] = None):
    """Generate continuations for a prompt batch (greedy / sample /
    nucleus).

    batch: the canonical model-input batch (left-padded prompts) as tensors
    on the parameters' device. rng: a generator on that device for the
    sampling methods (seed 0 when None). Returns tokens
    [B, max_new_tokens] (pad after EOS). The loop stops early once every
    row has emitted EOS; it looks every EOS_CHECK_EVERY steps.
    """
    B, L = batch["input_ids"].shape
    dev = batch["input_ids"].device
    cache = llama.init_kv_cache(cfg.llama, B, max_len=L + gen.max_new_tokens,
                                device=dev)
    logits, cache, top = _prefill(params, cfg, batch, cache)
    # left-padded prompts: the last valid position of every row is L-1
    pos = batch["positions"][:, -1:].to(torch.int32) + 1
    seg_live = batch["seg_ids"][:, -1:]  # continue the prompt's segment
    if rng is None and gen.method not in ("greedy", "beam"):
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)

    def sample_token(logits):
        if gen.method in ("greedy", "beam"):
            return logits.argmax(-1)
        logits = logits / max(gen.temperature, 1e-5)
        if gen.method == "nucleus":
            logits = _nucleus_filter(logits, gen.top_p)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=rng)[:, 0]

    tokens = torch.full((B, gen.max_new_tokens), gen.pad_token_id,
                        dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(gen.max_new_tokens):
        if t and t % EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
        nxt = torch.where(done, gen.pad_token_id, sample_token(logits))
        tokens[:, t] = nxt
        done = done | (nxt == gen.eos_token_id)
        logits, cache = _decode_fn(params, cfg, nxt[:, None], pos, seg_live,
                                   cache, max_position=top + 1 + t)
        pos = pos + 1
    return tokens


# ---------------------------------------------------------------------------
# Diverse beam search
# ---------------------------------------------------------------------------


def _group_size(gen: GenerationConfig) -> int:
    n_groups = max(gen.beam_size // gen.beam_group_size, 1)
    return gen.beam_size // n_groups


def beam_start(B: int, gen: GenerationConfig, device):
    """(tokens0 [B, beam, T], scores0 [B, beam], done0 [B, beam]): all beams
    are identical at the start, so only beam 0 of each group is live (score
    0, the others -1e30) to avoid duplicate hypotheses."""
    beam = gen.beam_size
    lead = torch.arange(beam, device=device) % _group_size(gen) == 0
    scores0 = torch.where(lead, 0.0, -1e30).to(torch.float32).expand(
        B, beam).contiguous()
    tokens0 = torch.full((B, beam, gen.max_new_tokens), gen.pad_token_id,
                         dtype=torch.int32, device=device)
    done0 = torch.zeros((B, beam), dtype=torch.bool, device=device)
    return tokens0, scores0, done0


@torch.no_grad()
def beam_init(params, cfg: unified.UnifiedConfig, batch,
              gen: GenerationConfig):
    """Prefill + beam-state init for diverse beam search. Returns the state
    tuple `beam_step` consumes; its last entry is the host-side bound of
    the next step's positions."""
    B, L = batch["input_ids"].shape
    dev = batch["input_ids"].device
    beam = gen.beam_size
    shared = ("protein_embeds", "drug_embeds", "struct_embeds")
    beam_batch = {
        k: v.repeat_interleave(beam, dim=0)
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == B
        and k not in shared else v
        for k, v in batch.items()}

    cache = llama.init_kv_cache(cfg.llama, B * beam,
                                max_len=L + gen.max_new_tokens, device=dev)
    logits, cache, top = _prefill(params, cfg, beam_batch, cache)
    logp0 = torch.log_softmax(logits, dim=-1)
    next_pos = beam_batch["positions"][:, -1:].to(torch.int32) + 1
    seg_live = beam_batch["seg_ids"][:, -1:]
    tokens0, scores0, done0 = beam_start(B, gen, dev)
    return (tokens0, cache, logp0, next_pos, scores0, done0, seg_live,
            top + 1)


def diverse_beam_select(logp, scores, done, gen: GenerationConfig):
    """Grouped diverse top-k selection: per group g, pick tokens maximizing
    score + logprob - penalty * count(token chosen by groups < g this
    step). Finished beams are forced to continue with EOS at zero added
    score.

    logp [B, beam, V] log-softmax; scores / done [B, beam].
    Returns (new_tokens, new_parent, new_scores), each [B, beam]. Shared by
    the dense-cache and paged-pool beam decoders so both produce identical
    hypotheses. Ties go to the lowest flat (beam, token) index, as
    jax.lax.top_k orders them: a stable descending sort, since torch.topk
    leaves the order of ties open."""
    B, beam, V = logp.shape
    gsz = _group_size(gen)
    n_groups = beam // gsz
    dev = logp.device
    new_tokens = torch.zeros((B, beam), dtype=torch.int32, device=dev)
    new_parent = torch.zeros((B, beam), dtype=torch.int32, device=dev)
    new_scores = torch.zeros((B, beam), dtype=torch.float32, device=dev)
    used = torch.zeros((B, V), dtype=torch.float32, device=dev)

    for g in range(n_groups):
        sl = slice(g * gsz, (g + 1) * gsz)
        g_done = done[:, sl]
        # finished beams: force an EOS continuation with zero added score
        cont = torch.where(g_done[..., None], -1e30, logp[:, sl])
        cont[:, :, gen.eos_token_id] = torch.where(
            g_done, 0.0, cont[:, :, gen.eos_token_id])
        total = scores[:, sl, None] \
            + (cont - gen.diversity_penalty * used[:, None, :])
        top_scores, top_idx = torch.sort(total.reshape(B, gsz * V), dim=-1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :gsz], top_idx[:, :gsz]
        token = top_idx % V
        new_tokens[:, sl] = token.to(torch.int32)
        new_parent[:, sl] = (top_idx // V + g * gsz).to(torch.int32)
        new_scores[:, sl] = top_scores
        used.scatter_add_(1, token, torch.ones_like(top_scores))
    return new_tokens, new_parent, new_scores


def reorder_beams(tokens, done, new_tokens, new_parent, t: int,
                  gen: GenerationConfig):
    """Token history and done flags gathered by parent, step t's tokens
    written (pad for beams already finished). Returns (tokens, done,
    flat_parent [B*beam] absolute parent rows)."""
    B, beam = new_parent.shape
    parent = new_parent.long()
    flat_parent = (parent + torch.arange(B, device=parent.device)[:, None]
                   * beam).reshape(-1)
    tokens = tokens.reshape(B * beam, -1)[flat_parent].reshape(B, beam, -1)
    done = torch.gather(done, 1, parent)
    tokens[:, :, t] = torch.where(done, gen.pad_token_id, new_tokens)
    done = done | (new_tokens == gen.eos_token_id)
    return tokens, done, flat_parent


@torch.no_grad()
def beam_step(params, cfg: unified.UnifiedConfig, gen: GenerationConfig,
              state, t: int):
    """One diverse-beam decode step: grouped top-k with the Hamming
    diversity penalty, parent-gather cache reorder, one 1-token forward.
    t is the step's index, a host int."""
    tokens, cache, logp, pos, scores, done, seg_live, pos_bound = state
    B, beam = scores.shape
    new_tokens, new_parent, new_scores = diverse_beam_select(
        logp.reshape(B, beam, -1), scores, done, gen)
    tokens, done, flat_parent = reorder_beams(tokens, done, new_tokens,
                                              new_parent, t, gen)
    # reorder the cache rows by parent
    cache = {
        "k": cache["k"][:, flat_parent],
        "v": cache["v"][:, flat_parent],
        "seg": cache["seg"][flat_parent],
        "pos": cache["pos"][flat_parent],
        "length": cache["length"],
    }
    step_tok = torch.where(done.reshape(-1), gen.pad_token_id,
                           new_tokens.reshape(-1))
    new_logits, cache = _decode_fn(params, cfg, step_tok[:, None], pos,
                                   seg_live, cache, max_position=pos_bound)
    logp_next = torch.log_softmax(new_logits, dim=-1)
    return (tokens, cache, logp_next, pos + 1, new_scores, done, seg_live,
            pos_bound + 1)


def rank_beams(tokens, scores):
    """(tokens [B, beam, T], scores [B, beam]) ordered by score, best
    first; equal scores keep their beam order."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return (torch.gather(tokens, 1,
                         order[..., None].expand(-1, -1, tokens.shape[-1])),
            torch.gather(scores, 1, order))


@torch.no_grad()
def generate_beam(params, cfg: unified.UnifiedConfig, batch,
                  gen: GenerationConfig):
    """Diverse (grouped) beam search.

    Beams live as an expanded batch dim [B*beam]; per decode step each
    group g picks tokens maximizing logprob - diversity_penalty *
    count(token in groups < g at this step). Cache rows are gathered on
    reorder. The loop always runs all max_new_tokens steps. Returns
    (tokens [B, beam, max_new_tokens], scores [B, beam]) ranked by final
    score.
    """
    state = beam_init(params, cfg, batch, gen)
    for t in range(gen.max_new_tokens):
        state = beam_step(params, cfg, gen, state, t)
    return rank_beams(state[0], state[4])
