"""Continuous-batching decode server loop over the paged KV pool
(counterpart of procyon_tpu/inference/serving.py).

A fixed number of decode slots share one page pool; requests are admitted
as slots and pages free up, every live slot advances together through
fixed-shape decode rounds, and finished sequences release their pages
immediately.

What crosses between host and device:
  * sampling happens on the device (greedy argmax or temperature
    multinomial): the host reads back int32 token ids, never the
    [slots, vocab] logit matrix;
  * prefill returns the first sampled token the same way, and the first
    tokens of a whole admission wave cross in one transfer;
  * `step_quantum` K > 1 runs K self-feeding decode steps a round with
    nothing read back inside the round: each step's sampled tokens stay a
    device tensor that feeds the next step, and one [K, slots] block
    crosses per round. EOS / finish handling is host-side at round
    granularity: a slot that finishes mid-round wastes at most K-1
    token-slots of compute (its extra writes land inside its own page
    allocation or on the null page, never on another slot's), and
    admission latency is bounded by one round.

Where the reference compiles its rounds with jax.jit / lax.scan and donates
the pool, the port steps `llama.paged_forward` eagerly from the host and
updates the pool, the slot tables and the history buffer in place. No
update reads the device: scalars travel as kernel arguments, rows through
pinned host memory with non-blocking copies (a copy from pageable memory
would wait for the stream first). Every forward gets the host's bound on
its positions (`max_position`), so `paged_forward` never reads one back.

The pool-write invariant: rows at positions >= seq_len are garbage by
contract; every real writer covers a position in the same dispatch that
advances seq_len past it. That is what makes chunk pad rows, speculative
rewinds and post-finish in-flight rounds safe. Dead slots stay in
every fixed-shape round (seg 0, the null page row, length 0).
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from procyon_tpu_torch.inference import kv_pool, speculative
from procyon_tpu_torch.models import llama


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 32
    eos_id: Optional[int] = None
    # fused (soft-token) prompt: pre-assembled input embeddings [T, dim]
    # override the token prompt at prefill (the caption / retrieval
    # workloads reach the paged pool through this)
    embeds: Optional[np.ndarray] = None
    # optional speculative draft proposer for this request,
    # (history, k) -> k draft tokens; None = the batcher's n-gram
    # proposer. The verify math is exact for any proposal.
    draft_fn: Optional[object] = None
    # task-LoRA expert bank index for this request: different task adapters
    # share one decode batch via lora.apply_routed's exact one-hot mixing.
    # Ignored when the model has no LoRA banks.
    lora_expert: int = 0


def _bucket(n: int) -> int:
    """The reference's power-of-two prompt bucket (it bounds the number of
    compiled prefill programs there). The port's prefill does not pad to
    it: eager PyTorch compiles nothing, and the padding would only add
    masked rows. A prompt of n tokens takes the short-block route when
    n <= 16 = _bucket(n) and the flash route otherwise, with or without the
    padding, so the routes and the greedy tokens are the reference's."""
    b = 16
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """The reference's constructor arguments and public surface. `device`
    is where the pool and the slot tables live; the parameters must lie
    there already. `mesh` (tensor-parallel serving) is not ported."""

    def __init__(self, params, cfg, pcfg: kv_pool.PagedConfig, *,
                 temperature: float = 0.0, seed: int = 0,
                 step_quantum: int = 1, spec_k: int = 0,
                 spec_quantum: int = 1, mesh=None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_batch: int = 1,
                 async_rounds: bool = False, device="cuda"):
        if spec_k and temperature > 0 and int(spec_quantum) > 1:
            raise ValueError(
                "sampled speculative decoding is spec_quantum=1 only "
                "(the device-drafted trip is greedy; host-drafted "
                "rounds carry the rejection-sampling correction)")
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatcher(mesh=...): tensor-parallel serving is "
                "not ported to procyon_tpu_torch yet (ROADMAP.md, queue 1, "
                "slice 4 remainder)")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters on {params['embed'].device} but "
                             f"device={self.device}")
        self.params = params
        self.cfg = cfg
        self.pcfg = pcfg
        # spec_k defaults off: speculative decoding pays only when the text
        # repeats itself (the n-gram drafter's acceptance is a property of
        # the text); exactness is draft-independent either way
        self.spec_k = int(spec_k)
        # spec_quantum R > 1: R verify rounds per host trip, drafting on
        # the device from a history buffer (speculative.device_ngram_draft),
        # one [R, slots, K+2] readback a trip. Per-request draft_fn only
        # applies at spec_quantum == 1 (host drafting).
        self.spec_quantum = max(int(spec_quantum), 1)
        self.mesh = None
        self.pool = self._init_pool()
        self.alloc = kv_pool.PageAllocator(pcfg)
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.step_quantum = max(int(step_quantum), 1)
        # chunked prefill: every prompt runs as ceil(T/C) [1, C]
        # continuation forwards, so per-round prefill work is bounded by C.
        # Short prompts pad to C with seg 0.
        self.prefill_chunk = prefill_chunk
        # batched wave prefill: chunks of up to W different admissions
        # share one [W, C] forward (per-row slot ids + seg masks).
        if prefill_batch > 1 and not prefill_chunk:
            raise ValueError("prefill_batch needs prefill_chunk")
        self.prefill_batch = min(max(int(prefill_batch), 1), pcfg.slots)
        # pipelined decode rounds: round k+1 is dispatched before round k's
        # token block is waited for, feeding from a device-resident
        # pending-token tensor. Round k's block goes to pinned host memory
        # with a non-blocking copy and an event; the host waits on that
        # event only (a plain .cpu() would wait for round k+1 too).
        # Finishes are discovered one round late: a finished slot wastes at
        # most one extra K-token round of garbage compute, whose writes
        # stay past seq_len or are overwritten, and its surplus tokens are
        # dropped host-side. Greedy-exact (tested == synchronous).
        if async_rounds and (temperature > 0 or spec_k):
            raise ValueError("async_rounds is greedy-plain-decode only")
        self.async_rounds = bool(async_rounds)
        self._inflight: List[tuple] = []
        self._pending_dev = self._zeros(pcfg.slots)
        # automatic prefix caching: full page-size blocks of every prompt
        # (token or fused) are content-addressed in a hash chain
        # (kv_pool.PrefixCache); admissions reuse the longest cached chain
        # as shared refcounted page-table entries.
        self.pcache = (kv_pool.PrefixCache(pcfg.page_size)
                       if prefix_cache else None)
        self._slot_shared: Dict[int, List[int]] = {}
        self.queue: List[Request] = []
        self.live: Dict[int, dict] = {}          # slot -> state
        self.done: Dict[int, List[int]] = {}     # rid -> generated tokens
        self._next_rid = 0
        self._slot_ids = torch.arange(pcfg.slots, device=self.device)
        self._use_lora = cfg.lora is not None
        # per-slot task-LoRA expert table (unused when cfg.lora is None)
        self.experts = self._zeros(pcfg.slots)
        # device history for device-side drafting (spec_quantum > 1): the
        # cap leaves room for one trip's appends past max_ctx; one spare
        # column past the cap swallows invalid appends
        self._hist_cap = pcfg.max_ctx + self.spec_quantum * (self.spec_k + 1)
        self.hist = None
        self.hist_len = None
        if self.spec_k and self.spec_quantum > 1:
            self.hist = self._zeros(pcfg.slots, self._hist_cap + 1)
            self.hist_len = self._zeros(pcfg.slots)
        # acceptance telemetry (emitted / rounds = mean tokens per verify)
        self.spec_stats = {"rounds": 0, "emitted": 0}
        # round-granularity waste telemetry: `dropped` counts decode
        # positions the device computed whose tokens were discarded
        # host-side because the slot's request had already finished
        self.waste = {"emitted": 0, "dropped": 0}

    # -- device helpers -------------------------------------------------------
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _to_dev(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the batcher's device without a wait for the
        stream: through pinned memory and a non-blocking copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t if dtype is None else t.to(dtype)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """The one blocking read of a round, a trip or an admission wave."""
        return t.cpu().numpy()

    def _init_pool(self):
        return kv_pool.init_pool(self.pcfg, device=self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [B, vocab] f32 -> [B] int32 on the device."""
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        return nxt.to(torch.int32)

    def _lora(self, experts):
        return experts if self._use_lora else 0

    def _set_slot(self, slot: int, row, n: int, expert: int) -> None:
        """Slot-table update in place: admission writes the allocated page
        row, the slot's starting seq_len (0, or the shared-prefix length on
        a prefix-cache hit) and its LoRA expert id; finish writes the null
        row and 0. `row` None is the null row."""
        if row is None:
            self.pool["page_table"][slot] = 0
        else:
            self.pool["page_table"][slot] = self._to_dev(row)
        self.pool["seq_len"][slot] = n
        self.experts[slot] = expert

    def _bound(self, ahead: int = 0) -> int:
        """The host's bound on the positions a forward will touch `ahead`
        tokens past the live slots' cached lengths. Dead slots sit at
        position 0; positions past a request's own budget (prompt +
        max_new) hold garbage by contract and do not count."""
        return max((min(st["len"] + ahead,
                        len(st["req"].prompt) + st["req"].max_new - 1)
                    for st in self.live.values()), default=0)

    # -- rounds ---------------------------------------------------------------
    def _decode_round(self, k: int, tokens, seg):
        """K self-feeding decode steps over every slot. tokens / seg [slots]
        on the device. Returns (the last step's tokens [slots], the
        [K, slots] block), both on the device."""
        seg2 = seg[:, None]
        ys = []
        for i in range(k):
            logits, _ = llama.paged_forward(
                self.params, self.cfg, self.pool, self.pcfg, self._slot_ids,
                tokens=tokens[:, None], seg_ids=seg2,
                lora_expert=self._lora(self.experts),
                max_position=self._bound(i))
            tokens = self._sample(logits[:, -1])
            ys.append(tokens)
        return tokens, torch.stack(ys)

    def _verify(self, tokens, live, ahead: int = 0):
        """One verify forward over [slots, K+1] token blocks, `ahead`
        tokens past the lengths the host has counted."""
        seg = live[:, None].expand(tokens.shape)
        logits, _ = llama.paged_forward(
            self.params, self.cfg, self.pool, self.pcfg, self._slot_ids,
            tokens=tokens, seg_ids=seg,
            lora_expert=self._lora(self.experts),
            max_position=self._bound(ahead + self.spec_k))
        return logits

    def _rewind(self, m, live) -> None:
        """paged_forward advanced live slots by K+1; pull back to +m so
        positions holding rejected drafts sit past seq_len (masked from
        attention, overwritten next round)."""
        self.pool["seq_len"].sub_((self.spec_k + 1 - m) * live)

    def _greedy_accept(self, tokens, logits):
        greedy = logits.argmax(dim=-1).to(torch.int32)
        match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
        m = 1 + torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        return greedy, m

    def _spec_verify_round(self, tokens, live):
        """Speculative verify round: one forward over [slots, K+1] blocks
        (pending + K drafts), the longest accepted prefix and the seq_len
        rewind on the device. Returns [slots, K+2]: K+1 tokens || accepted
        count m. Greedy: the emitted tokens are the verify forward's own
        argmax at every position, whatever the draft.

        temperature > 0 switches to the rejection-sampling verify
        (Leviathan et al. 2023, for a deterministic proposer, a point mass
        q = delta_d): draft d_{i+1} is accepted with probability
        p_i(d_{i+1}); at the first rejection the stop token is drawn from
        the residual max(0, p - q) / Z, which for a point mass is p_i
        renormalised over x != d_{i+1}; a fully accepted block draws a
        bonus token from p_K unmasked. The emitted marginal at every
        position is exactly p."""
        K = self.spec_k
        logits = self._verify(tokens, live)
        if self.temperature > 0:
            S = tokens.shape[0]
            scaled = logits / self.temperature
            draft = tokens[:, 1:].long()                       # [S, K]
            logp = torch.log_softmax(scaled, dim=-1)
            u = torch.rand(draft.shape, generator=self.gen,
                           device=self.device)
            p_draft = torch.exp(
                logp[:, :K].gather(-1, draft[..., None])[..., 0])
            acc = (u < p_draft).to(torch.int32)                # [S, K]
            n_acc = torch.cumprod(acc, dim=1).sum(dim=1)       # 0..K
            m = (1 + n_acc).to(torch.int32)
            # residual / bonus sample at every position (the stop position
            # depends on the data): positions 0..K-1 mask their draft token
            # (residual of a point mass), position K samples p_K unmasked
            res_logits = scaled.clone()
            res_logits[:, :K].scatter_(-1, draft[..., None], -torch.inf)
            res = torch.multinomial(
                torch.softmax(res_logits, dim=-1).reshape(S * (K + 1), -1),
                1, generator=self.gen).reshape(S, K + 1)
            dpad = torch.cat([draft, draft.new_full((S, 1), -1)], dim=1)
            stop = n_acc[:, None]
            out = torch.where(
                torch.arange(K + 1, device=self.device)[None] < stop,
                dpad, res.gather(1, stop)).to(torch.int32)
        else:
            out, m = self._greedy_accept(tokens, logits)
        self._rewind(m, live)
        return torch.cat([out, m[:, None]], dim=1)

    def _spec_trip_rounds(self, pending, live):
        """R verify rounds with drafts from the device history buffer, no
        read by the host in between. Returns [R, slots, K+2]. Slots that
        finish mid-trip keep generating garbage for the rest of the trip
        (bounded waste, dropped host-side; their writes stay inside their
        own allocation or on the null page)."""
        K, R, cap = self.spec_k, self.spec_quantum, self._hist_cap
        rows = self._slot_ids[:, None]
        steps = torch.arange(K + 1, device=self.device)[None]
        alive = live[:, None] > 0
        out = []
        for r in range(R):
            draft = speculative.device_ngram_draft(
                self.hist[:, :cap], self.hist_len, K)
            tokens = torch.cat([pending[:, None], draft.to(torch.int32)],
                               dim=1)
            logits = self._verify(tokens, live, r * (K + 1))
            greedy, m = self._greedy_accept(tokens, logits)
            self._rewind(m, live)
            pos = self.hist_len[:, None] + steps
            valid = (steps < m[:, None]) & alive & (pos < cap)
            # invalid or overflowing appends go to the spare column
            self.hist[rows, torch.where(valid, pos, cap).long()] = greedy
            self.hist_len.add_(m * live)
            nxt = greedy.gather(1, (m - 1).long()[:, None])[:, 0]
            pending = torch.where(live > 0, nxt, pending)
            out.append(torch.cat([greedy, m[:, None]], dim=1))
        return torch.stack(out)

    # -- public ---------------------------------------------------------------
    def reset(self, seed: int = 0) -> None:
        """Clear all serving state (pool, allocator, queues) and reseed the
        sampler: benches warm up on a throwaway workload, reset, then
        measure steady state."""
        for t in self.pool.values():
            t.zero_()
        self.alloc = kv_pool.PageAllocator(self.pcfg)
        if self.pcache is not None:
            # the pool's pages were just zeroed: drop every cached chain
            self.pcache = kv_pool.PrefixCache(self.pcfg.page_size)
        self._slot_shared = {}
        self.experts.zero_()
        self._inflight = []
        self._pending_dev = self._zeros(self.pcfg.slots)
        if self.hist is not None:
            self.hist.zero_()
            self.hist_len.zero_()
        self.gen.manual_seed(int(seed))
        self.queue = []
        self.live = {}
        self.done = {}
        self.waste = {"emitted": 0, "dropped": 0}
        self.spec_stats = {"rounds": 0, "emitted": 0}
        self._next_rid = 0

    def submit(self, prompt: List[int], max_new: int = 32,
               eos_id: Optional[int] = None, draft_fn=None,
               lora_expert: int = 0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new, eos_id,
                                  draft_fn=draft_fn,
                                  lora_expert=lora_expert))
        return rid

    def submit_fused(self, input_embeds, max_new: int = 32,
                     eos_id: Optional[int] = None, draft_fn=None,
                     lora_expert: int = 0) -> int:
        """Admit a soft-token (fusion) prompt: pre-assembled input
        embeddings [T, dim] (unified.assemble_input_embeds row, unpadded),
        a numpy array or a tensor. Prefill rides
        llama.paged_forward(input_embeds=...)."""
        rid = self._next_rid
        self._next_rid += 1
        if isinstance(input_embeds, torch.Tensor):
            input_embeds = input_embeds.detach().float().cpu().numpy()
        embeds = np.asarray(input_embeds)
        self.queue.append(Request(rid, [0] * embeds.shape[0], max_new,
                                  eos_id, embeds=embeds, draft_fn=draft_fn,
                                  lora_expert=lora_expert))
        return rid

    @torch.no_grad()
    def submit_batch(self, params_unified, cfg_unified, batch,
                     max_new: int = 32,
                     eos_id: Optional[int] = None) -> List[int]:
        """Admit every row of a canonical collator batch (soft-token
        prompts). Rows are unpadded to their true lengths; the shared soft
        bank is assembled once for the batch."""
        from procyon_tpu_torch.models import unified

        dev = {k: torch.as_tensor(np.asarray(v)).to(self.device)
               for k, v in batch.items()
               if k != "reference_indices" and v is not None
               and not np.isscalar(v)}
        embeds = unified.assemble_input_embeds(
            params_unified, cfg_unified, dev).float().cpu().numpy()
        seg = np.asarray(batch["seg_ids"])
        return [self.submit_fused(embeds[r, seg[r] > 0], max_new, eos_id)
                for r in range(embeds.shape[0])]

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request finishes; returns
        rid -> generated token list."""
        self._admit()
        while self.live or self._inflight:
            self.tick()
        return self.done

    @torch.no_grad()
    def tick(self, k: Optional[int] = None) -> None:
        """One serving round: advance every live slot by up to k (default
        step_quantum) tokens, process finishes, admit queued requests. The
        bench / server drive loop: submit() between ticks = requests
        joining mid-flight.

        async_rounds: dispatch round k+1 from the device pending tensor,
        then wait for round k's block; with nothing live, drain the
        backlog."""
        if self.async_rounds:
            if self.live:
                self._dispatch_round_async(k or self.step_quantum)
            while len(self._inflight) > (1 if self.live else 0):
                self._process_round_async()
        elif self.live:
            if self.spec_k and self.spec_quantum > 1:
                self._spec_trip()
            elif self.spec_k:
                self._spec_round()
            else:
                self._round(k or self.step_quantum)
        self._admit()

    def _dispatch_round_async(self, k: int) -> None:
        seg = np.zeros((self.pcfg.slots,), np.int32)
        for slot in self.live:
            seg[slot] = 1
        # snapshot slot -> rid: by processing time a slot may have been
        # finished and re-admitted; its garbage tokens from this round must
        # not be attributed to the new request
        snap = {slot: st["req"].rid for slot, st in self.live.items()}
        self._pending_dev, ys = self._decode_round(
            k, self._pending_dev, self._to_dev(seg))
        for st in self.live.values():
            st["len"] += k
        event = None
        if self.device.type == "cuda":
            host = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
            host.copy_(ys, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            ys = host
        self._inflight.append((ys, event, snap, k))

    def _process_round_async(self) -> None:
        ys, event, snap, k = self._inflight.pop(0)
        if event is not None:
            event.synchronize()                   # this round's block only
        ys = ys.numpy()
        for slot, rid in snap.items():
            st = self.live.get(slot)
            if st is None or st["req"].rid != rid:
                # finished a round ago: this whole round was garbage
                self.waste["dropped"] += k
                continue
            self._consume(slot, ys[:k, slot])

    # -- internals ------------------------------------------------------------
    def _free_slots(self):
        return [s for s in range(self.pcfg.slots) if s not in self.live]

    def _prefill(self, x, seg, slots, valids, experts, fused: bool,
                 bound: int):
        """One prefill forward over [W, T] rows; samples each row's
        last-valid-position logits on the device. Returns [W] int32."""
        kw = {"input_embeds": x} if fused else {"tokens": x}
        logits, _ = llama.paged_forward(
            self.params, self.cfg, self.pool, self.pcfg, slots,
            seg_ids=seg, lora_expert=self._lora(experts),
            logits_at=valids - 1, max_position=bound, **kw)
        return self._sample(logits[:, 0])

    def _promote_blocks(self, slot, row, n_shared, keys):
        """Move a freshly-prefilled request's full blocks into the
        prefix cache (blocks n_shared..len(keys)-1 of its page row)."""
        for j in range(n_shared, len(keys)):
            page = int(row[j])
            if self.pcache.promote(keys[j], page):
                self.alloc.disown(slot, page)
                self._slot_shared.setdefault(slot, []).append(page)

    def _dispatch_prefill_wave(self, items):
        """Batched-wave prefill of this admission wave's requests:
        `items` = [[slot, req, start]]. Token and fused prompts batch
        separately (different input kinds). Returns {slot: first-token
        device scalar}. Up to prefill_batch requests share a forward, the
        reference's grouping; the forward is exactly as wide as its group.
        (The reference pads the width to a power of two to bound its
        compiled programs and parks the pad rows on a slot outside the
        group; where that slot is live and within a chunk of a full page
        table, their writes wrap onto its last page. The port has no
        programs to bound and no pad rows.) Greedy outputs equal the [1, C]
        chunked path (same chunk boundaries per request, tested); under
        temperature sampling the random stream differs, like chunked vs
        bucketed."""
        C, Wmax = self.prefill_chunk, self.prefill_batch
        first = {}
        for fused in (False, True):
            queue = [[slot, req, start] for slot, req, start in items
                     if (req.embeds is not None) == fused]
            while queue:
                group = queue[:Wmax]
                W = len(group)
                slots = np.zeros((W,), np.int64)
                seg = np.zeros((W, C), np.int32)
                valids = np.ones((W,), np.int64)
                experts = np.zeros((W,), np.int32)
                if fused:
                    x = np.zeros((W, C, self.cfg.dim), np.float32)
                else:
                    x = np.zeros((W, C), np.int32)
                bound = 0
                for i, it in enumerate(group):
                    slot, req, pos = it
                    valid = min(C, len(req.prompt) - pos)
                    slots[i] = slot
                    seg[i, :valid] = 1
                    valids[i] = valid
                    experts[i] = req.lora_expert
                    if fused:
                        x[i, :valid] = req.embeds[pos:pos + valid]
                    else:
                        x[i, :valid] = req.prompt[pos:pos + valid]
                    it[2] = pos + valid
                    bound = max(bound, pos + valid - 1)
                fw = self._prefill(
                    self._to_dev(x, self.cfg.dtype if fused else None),
                    self._to_dev(seg), self._to_dev(slots),
                    self._to_dev(valids), self._to_dev(experts), fused,
                    bound)
                for i, it in enumerate(group):
                    if it[2] >= len(it[1].prompt):
                        first[it[0]] = fw[i]
                queue = [it for it in queue
                         if it[2] < len(it[1].prompt)]
        return first

    @torch.no_grad()
    def _admit(self):
        # admissions happen in waves: every prefill of a wave is dispatched
        # before any result is read back, so the host pays one read of the
        # device per wave instead of one per request
        batched = self.prefill_batch > 1
        while True:
            staged = []
            staged_slots = set()
            wave_items = []
            wave_promote = []

            def free():
                return [s for s in self._free_slots()
                        if s not in staged_slots]

            while self.queue and free():
                req = self.queue[0]
                budget = len(req.prompt) + req.max_new
                if budget > self.pcfg.max_ctx:
                    raise ValueError(
                        f"request {req.rid} needs {budget} tokens > "
                        f"max_ctx {self.pcfg.max_ctx}")
                shared, keys = [], []
                if self.pcache is not None:
                    # LoRA-expert routing changes the K/V bytes a prefill
                    # writes (lora_wv deltas ride the cached rows): fold
                    # the expert id into the digest domain so pages written
                    # under expert A never match expert B
                    digests = kv_pool.PrefixCache.block_digests(
                        prompt=req.prompt if req.embeds is None else None,
                        embeds=req.embeds,
                        page_size=self.pcfg.page_size,
                        domain=(b"e%d:" % req.lora_expert
                                if self._use_lora else b""))
                    shared, keys = self.pcache.match(digests)
                    if shared:
                        # pin the matched pages before admission-pressure
                        # eviction: their writer may have finished (ref 0),
                        # and evict() must not reclaim the very pages this
                        # admission is about to reuse
                        self.pcache.acquire(shared)
                if not self.alloc.can_admit(budget, reserved=len(shared)):
                    # reclaim idle cached pages before giving up
                    if self.pcache is not None:
                        short = (self.alloc.pages_for(budget)
                                 - len(shared) - len(self.alloc.free))
                        self.alloc.free.extend(self.pcache.evict(short))
                    if not self.alloc.can_admit(budget,
                                                reserved=len(shared)):
                        if shared:
                            self.pcache.release(shared)
                        break  # wait for pages
                self.queue.pop(0)
                slot = free()[0]
                staged_slots.add(slot)
                if shared:
                    self._slot_shared[slot] = list(shared)
                pages = self.alloc.allocate(slot, budget,
                                            reserved=len(shared))
                row = np.zeros((self.pcfg.max_pages_per_seq,), np.int32)
                row[:len(shared)] = shared
                row[len(shared):len(shared) + len(pages)] = pages
                start = len(shared) * self.pcfg.page_size
                self._set_slot(slot, row, start, req.lora_expert)

                if batched:
                    first = None
                    wave_items.append([slot, req, start])
                else:
                    first = self._dispatch_prefill(req, slot, start=start)
                if self.pcache is not None:
                    # promote the freshly-prefilled full blocks: their
                    # lifetime moves from the slot's release to the cache's
                    # refcount (this slot holds one reference). In
                    # batched-wave mode promotion is deferred to the end of
                    # the wave: same-wave chunks interleave, so a same-wave
                    # hit could gather pages whose writes are not yet
                    # dispatched
                    if batched:
                        wave_promote.append(
                            (slot, row, len(shared), keys))
                    else:
                        self._promote_blocks(slot, row, len(shared),
                                             keys)
                    # start <= plen-1 by construction (block_digests leaves
                    # the final prompt token to the private tail)
                    self.pcache.stats["hit_tokens"] += start
                    self.pcache.stats["miss_tokens"] += (
                        len(req.prompt) - start)
                # keep `first` on the device; resolve the whole wave below
                staged.append((slot, req, first))
            if not staged:
                return
            if batched:
                by_slot = self._dispatch_prefill_wave(wave_items)
                staged = [(slot, req, by_slot[slot])
                          for slot, req, _ in staged]
                for slot, row, n_shared, keys in wave_promote:
                    self._promote_blocks(slot, row, n_shared, keys)
            # all first tokens of the wave in one transfer
            firsts = self._to_host(torch.stack([f for _, _, f in staged]))
            for (slot, req, _), tok in zip(staged, firsts):
                last = int(tok)
                # history feeds the n-gram draft proposer (spec_k > 0):
                # token prompts contribute their text, fused prompts only
                # their generations (their token ids are placeholders)
                hist = ([] if req.embeds is not None
                        else list(req.prompt)) + [last]
                self.live[slot] = {"req": req, "generated": [last],
                                   "pending": last, "history": hist,
                                   "len": len(req.prompt)}
                if self.async_rounds:
                    # seed the device pending tensor so the next round can
                    # be dispatched without a read of the device
                    self._pending_dev[slot] = last
                if self.hist is not None:
                    row = np.zeros((self._hist_cap,), np.int32)
                    row[:len(hist)] = hist
                    self.hist[slot, :self._hist_cap] = self._to_dev(row)
                    self.hist_len[slot] = len(hist)
                self._maybe_finish(slot)
            # a request finishing at prefill (max_new=1 / instant EOS)
            # frees its slot: loop for another wave

    def _dispatch_prefill(self, req: Request, slot: int, start: int = 0):
        """Dispatch a request's prefill (no wait for the device; the wave
        resolver reads the returned first-token tensor). Without
        prefill_chunk one forward takes the whole prompt tail; chunked mode
        (prefill_chunk=C) runs ceil(T/C) [1, C] continuation forwards, so
        per-round prefill work is bounded by C. Chunk tails pad with seg
        0: pad KV rows land past seq_len (invisible, overwritten by later
        writes). Mid chunks sample and discard a token, so under
        temperature sampling the random stream differs from the unchunked
        mode (greedy outputs are identical, tested).

        `start` > 0 = prefix-cache hit: the slot's seq_len already sits at
        the shared-prefix boundary and the forward continues from there."""
        plen = len(req.prompt)
        fused = req.embeds is not None
        C = self.prefill_chunk
        chunks = ([(lo, min(plen - lo, C))
                   for lo in range(start, plen, C)] if C
                  else [(start, plen - start)])
        slots = torch.full((1,), slot, dtype=torch.long, device=self.device)
        first = None
        for lo, valid in chunks:
            T = C if C else valid
            seg = np.zeros((1, T), np.int32)
            seg[0, :valid] = 1
            if fused:
                emb = np.zeros((1, T, req.embeds.shape[-1]), np.float32)
                emb[0, :valid] = req.embeds[lo:lo + valid]
                x = self._to_dev(emb, self.cfg.dtype)
            else:
                toks = np.zeros((1, T), np.int32)
                toks[0, :valid] = req.prompt[lo:lo + valid]
                x = self._to_dev(toks)
            valids = torch.full((1,), valid, dtype=torch.long,
                                device=self.device)
            first = self._prefill(x, self._to_dev(seg), slots, valids,
                                  req.lora_expert, fused, lo + valid - 1)[0]
        return first

    def _round(self, k: int):
        """One K-step decode round + host-side finish processing. Slots
        that finish mid-round have their surplus tokens dropped here (the
        device kept feeding them: bounded waste, see the module
        docstring)."""
        tokens = np.zeros((self.pcfg.slots,), np.int32)
        seg = np.zeros((self.pcfg.slots,), np.int32)
        for slot, st in self.live.items():
            tokens[slot] = st["pending"]
            seg[slot] = 1
        _, ys = self._decode_round(k, self._to_dev(tokens),
                                   self._to_dev(seg))
        ys = self._to_host(ys)                    # [k, slots]: one readback
        for slot in list(self.live):
            self.live[slot]["len"] += k
            self._consume(slot, ys[:k, slot])

    def _spec_trip(self):
        """R device-drafted verify rounds per host trip (spec_quantum):
        one readback, the host replays emission round by round (a slot
        that finishes mid-trip stops consuming its later rounds)."""
        K, R = self.spec_k, self.spec_quantum
        pending = np.zeros((self.pcfg.slots,), np.int32)
        live = np.zeros((self.pcfg.slots,), np.int32)
        for slot, st in self.live.items():
            pending[slot] = st["pending"]
            live[slot] = 1
        ys = self._spec_trip_rounds(self._to_dev(pending),
                                    self._to_dev(live))
        ys = self._to_host(ys)                # [R, slots, K+2]: one readback
        snap = {slot: st["req"].rid for slot, st in self.live.items()}
        for r in range(R):
            for slot, rid in snap.items():
                st = self.live.get(slot)
                if st is None or st["req"].rid != rid:
                    # finished mid-trip: the device still ran this slot's
                    # whole verify block this round
                    self.waste["dropped"] += K + 1
                    continue
                m = int(ys[r, slot, K + 1])
                self.spec_stats["rounds"] += 1
                st["len"] += m
                self._consume(slot, ys[r, slot, :m], history=True,
                              spec=True)

    def _spec_round(self):
        """One speculative round: host-side drafts per live slot (no device
        cost), one verify forward, host emit of the accepted prefix. Each
        accepted draft token is a decode step the weight stream never has
        to run; a fully rejected draft still emits one token."""
        K = self.spec_k
        tokens = np.zeros((self.pcfg.slots, K + 1), np.int32)
        live = np.zeros((self.pcfg.slots,), np.int32)
        for slot, st in self.live.items():
            propose = st["req"].draft_fn or speculative.ngram_propose
            tokens[slot, 0] = st["pending"]
            tokens[slot, 1:] = propose(st["history"], K)
            live[slot] = 1
        out = self._spec_verify_round(self._to_dev(tokens),
                                      self._to_dev(live))
        out = self._to_host(out)                  # [slots, K+2]: one readback
        for slot in list(self.live):
            m = int(out[slot, K + 1])
            self.spec_stats["rounds"] += 1
            self.live[slot]["len"] += m
            self._consume(slot, out[slot, :m], history=True, spec=True)

    def _consume(self, slot, toks, *, history: bool = False,
                 spec: bool = False) -> bool:
        """Emit device-computed decode positions `toks` into `slot`'s
        stream in order, stopping at the first finish and counting the
        round's remaining positions as waste (the device computed them;
        the host drops them). history / spec additionally feed the n-gram
        draft history and the speculative emit counter. Returns True if
        the slot finished."""
        st = self.live[slot]
        n = len(toks)
        for t in range(n):
            tok = int(toks[t])
            st["generated"].append(tok)
            if history:
                st["history"].append(tok)
            st["pending"] = tok
            self.waste["emitted"] += 1
            if spec:
                self.spec_stats["emitted"] += 1
            if self._maybe_finish(slot):
                self.waste["dropped"] += n - 1 - t
                return True
        return False

    def _maybe_finish(self, slot) -> bool:
        st = self.live[slot]
        req = st["req"]
        gen = st["generated"]
        hit_eos = req.eos_id is not None and gen and gen[-1] == req.eos_id
        if hit_eos or len(gen) >= req.max_new:
            self.done[req.rid] = gen
            self.alloc.release(slot)
            sh = self._slot_shared.pop(slot, None)
            if sh:
                self.pcache.release(sh)
            del self.live[slot]
            # point the dead slot at the null page and reset its length:
            # idle slots still take part in the fixed-shape decode step,
            # and their writes must not land on reallocated pages
            self._set_slot(slot, None, 0, 0)
            return True
        return False
