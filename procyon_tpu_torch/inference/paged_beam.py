"""Diverse beam search over the paged KV pool (counterpart of
procyon_tpu/inference/paged_beam.py).

The dense beam path (inference/generation.py) gathers full cache rows per
step: a copy of the whole context per beam per token. This module moves
beam decode onto the paged pool (inference/kv_pool.py):

  * beam rows are pool slots; all beams of a prompt share the prompt's
    full KV pages read-only (prompt KV is written once, not `beam` times);
  * parent reorder = a gather on page-table rows (max_pages int32 entries)
    instead of the full KV context;
  * the only per-step KV copy is each beam's current partial page: full
    pages are append-only and immutable, so children can share the
    parent's filled pages and only the in-progress page must be duplicated
    (copy-on-write at page granularity).

Page ownership (no refcounts needed): every beam slot owns a fixed private
page range covering the generation region [g0, last] where
g0 = prompt_len // page_size. Reorder copies the parent's current partial
page into the child's private page for that index and re-points all
indices >= current at the child's private pages; indices < current gather
the parent's (immutable) entries. A private page is only written while it
is the slot's current page, and it only enters other tables once full, so
no write ever lands on a shared page.

Selection math is `generation.diverse_beam_select`, shared with the dense
path: both decoders produce identical hypotheses (tested).

The pool is updated in place throughout. The loop is stepped from the host,
one eager step per token, with every per-step quantity on the device. Of
the reference, the K-step scan trips (`paged_beam_step_trip`, `step_trip`),
the `host_loop` switch and the one-hot matmul page moves
(`_copy_pages_matmul`, `_onehot_page_contraction`, `_move_scales_onehot`)
are not ported: the first two choose between compiled programs, which eager
PyTorch does not have, and the last are work-arounds for XLA's lowering on
the TPU (here the page-move kernel copies bytes and takes the int8 codes
and the f32 scale slabs alike).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from procyon_tpu_torch.inference import kv_pool
from procyon_tpu_torch.inference.generation import (GenerationConfig,
                                                    beam_start,
                                                    diverse_beam_select,
                                                    rank_beams,
                                                    reorder_beams)
from procyon_tpu_torch.models import llama, unified
from procyon_tpu_torch.ops import page_move


def plan_pool_config(cfg: llama.LlamaConfig, prompt_lens, beam: int,
                     max_new: int, *, page_size: int = 64,
                     dtype=None, quantize_kv: bool = False,
                     n_prompt_pages: Optional[int] = None
                     ) -> kv_pool.PagedConfig:
    """Size a pool exactly for one beam run: shared prompt pages + two
    private generation pages per (beam slot, generation index) + the null
    page. Private pages come in ping-pong pairs: step t writes the
    phase-(t%2) page of the slot's current index, so copy-on-write sources
    (the parent's page, last written at phase 1-t%2) and destinations are
    always disjoint sets, and the copy is a direct in-place page copy
    (ops/page_move.move_pages_direct) with no staging pass.

    n_prompt_pages overrides the per-row prompt-page sum (the shared-prefix
    planner passes the deduped count)."""
    P = page_size
    n_prompt = (n_prompt_pages if n_prompt_pages is not None
                else sum(-(-int(L) // P) for L in prompt_lens))
    max_pages_per_seq = max(-(-(int(L) + max_new) // P)
                            for L in prompt_lens)
    slots = len(prompt_lens) * beam
    return kv_pool.PagedConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, page_size=P,
        n_pages=1 + n_prompt
        + slots * _n_private(prompt_lens, max_new, P) * 2,
        max_pages_per_seq=max_pages_per_seq, slots=slots,
        dtype=dtype or cfg.dtype, quantize_kv=quantize_kv)


def _n_private(prompt_lens, max_new: int, P: int) -> int:
    """Generation page indices a beam slot may reach, over the batch."""
    return max((-(-(int(L) + max_new) // P)) - int(L) // P
               for L in prompt_lens)


@dataclasses.dataclass
class _BeamPlan:
    """Host-side page layout for one run."""
    prompt_pages: np.ndarray   # [B, max_pages] page id per prompt page
    private: np.ndarray        # [slots, n_priv, 2] ping-pong private pages
    g0: np.ndarray             # [B] first generation page index
    lens: np.ndarray           # [B] prompt lengths
    start: np.ndarray          # [B] shared-prefix tokens (prefill resumes
    #                            here; 0 without shared_prefix)
    wave: np.ndarray           # [B] prefill wave (a row's shared pages are
    #                            all written by strictly earlier waves)


def _plan_pages(pcfg: kv_pool.PagedConfig, prompt_lens, beam: int,
                max_new: int) -> _BeamPlan:
    P = pcfg.page_size
    B = len(prompt_lens)
    nxt = 1  # page 0 = null
    prompt_pages = np.zeros((B, pcfg.max_pages_per_seq), np.int64)
    g0 = np.zeros((B,), np.int64)
    for r, L in enumerate(prompt_lens):
        n = -(-int(L) // P)
        prompt_pages[r, :n] = np.arange(nxt, nxt + n)
        nxt += n
        g0[r] = int(L) // P
    n_priv = _n_private(prompt_lens, max_new, P)
    private = np.arange(nxt, nxt + B * beam * n_priv * 2).reshape(
        B * beam, n_priv, 2)
    if private.max(initial=0) >= pcfg.n_pages:
        raise ValueError("pool too small for the beam page plan")
    return _BeamPlan(prompt_pages=prompt_pages, private=private, g0=g0,
                     lens=np.asarray(prompt_lens, np.int64),
                     start=np.zeros((B,), np.int64),
                     wave=np.zeros((B,), np.int64))


@dataclasses.dataclass
class _SharedPlan:
    """Result of the shared-prefix dedup pass."""
    pages: np.ndarray     # [B, max_prompt_pages] page id per prompt page
    start: np.ndarray     # [B] shared tokens (prefill resumes here)
    wave: np.ndarray      # [B] prefill dependency wave
    n_prompt: int         # novel prompt pages allocated by this plan
    novel: list           # [(chain node key, page id)] freshly-owned full
    #                       blocks: a BeamPoolSession promotes them into
    #                       its cross-batch cache once their prefill ran
    hit_pages: list       # page ids hit in chain0 (cross-batch cache hits;
    #                       the session refs them for the batch's lifetime)


def _shared_prompt_plan(prompt_lens, page_size: int, digests, *,
                        chain0=None, page_iter=None) -> _SharedPlan:
    """Dedup full prompt blocks across batch rows (shared-prefix prompt
    pages for the bulk-caption workload: every caption batch reuses one
    instruction template, so rows share their leading blocks until the
    first protein-specific token).

    digests[r] = kv_pool.PrefixCache.block_digests of row r's unpadded
    prompt content (full blocks only; the block holding the last prompt
    token is always row-private, so shared pages are write-once and the
    partial-page beam copy-on-write never touches them). Blocks are chained
    by a rolling hash: a block is only shared under an identical full
    prefix.

    chain0: node key -> page id of blocks whose KV was already written in
    an earlier batch (a BeamPoolSession's PrefixCache.chain); hits there
    carry no wave dependency (wave -1). page_iter: callable n -> n fresh
    page ids for novel pages (a session's free list); defaults to the
    1-based arange of the single-run exact pool layout.

    The first row to present a novel chain node owns (and prefills) its
    page; later rows reference it and prefill only their tail as a
    continuation forward, one wave after their deepest dependency."""
    P = page_size
    B = len(prompt_lens)
    max_prompt = max(-(-int(L) // P) for L in prompt_lens)
    prompt_pages = np.zeros((B, max_prompt), np.int64)
    start = np.zeros((B,), np.int64)
    wave = np.zeros((B,), np.int64)
    # rolling node key -> (page id, writer wave); cross-batch pages were
    # written before this batch ran anything: wave -1
    chain = {k: (int(p), -1) for k, p in (chain0 or {}).items()}
    nxt = [1]                   # page 0 = null
    if page_iter is None:
        def page_iter(n):
            out = np.arange(nxt[0], nxt[0] + n)
            nxt[0] += n
            return out
    n_novel = 0
    novel = []
    hit_pages = {}              # ordered de-dup of cross-batch hits
    hasher = kv_pool.PrefixCache(P)
    for r, L in enumerate(prompt_lens):
        L = int(L)
        n = -(-L // P)
        keys = hasher.node_keys(list(digests[r]))
        hits = []
        dep = -1
        for k in keys:
            ent = chain.get(k)
            if ent is None:
                break
            hits.append(ent[0])
            dep = max(dep, ent[1])
            if ent[1] < 0:
                hit_pages[ent[0]] = None
        s = len(hits)
        wave[r] = dep + 1
        own = np.asarray(page_iter(n - s), np.int64)
        n_novel += n - s
        for j in range(s, len(keys)):     # promote novel full blocks
            chain[keys[j]] = (int(own[j - s]), int(wave[r]))
            novel.append((keys[j], int(own[j - s])))
        prompt_pages[r, :s] = hits
        prompt_pages[r, s:n] = own
        start[r] = s * P
    return _SharedPlan(pages=prompt_pages, start=start, wave=wave,
                       n_prompt=n_novel, novel=novel,
                       hit_pages=list(hit_pages))


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class BeamPoolSession:
    """Persistent cross-batch pool for bulk captioning.

    paged_beam_init sizes an exact pool per batch and re-prefills the
    instruction template's KV every batch even though `shared_prefix`
    dedups it within one. A session keeps one PagedConfig and one pool for
    the whole run and a kv_pool.PrefixCache whose entries outlive batches:
    the template blocks written by batch k are cache hits for batches
    k+1..n, which prefill only their protein-specific tails (wave 0, no
    dependency: the bytes were written by an earlier batch).

    Page lifetime: novel pages are batch-owned (freed by end_batch); full
    prompt blocks are promoted into the cache at end_batch (their lifetime
    becomes the cache's LRU / refcount); cache hits are ref'd for the batch
    and released after. Zero-ref cached pages are evicted back to the free
    list only when an allocation needs them. Generation and partial-page
    copy-on-write writes land exclusively on batch-private pages, so cached
    pages are write-once.

    Usage: pass `session=` to paged_beam_generate (ProcyonCaptionEval does
    this when shared_prefix=True); every batch must present the same
    batch_size x beam_size (pad the last chunk; the eval wrapper does). The
    pool is allocated on the parameters' device at the first batch."""

    def __init__(self, *, page_size: int = 64, quantize_kv: bool = False,
                 cache_pages: Optional[int] = None):
        self.page_size = page_size
        self.quantize_kv = quantize_kv
        self.cache_pages = cache_pages
        self.pcfg: Optional[kv_pool.PagedConfig] = None
        self.pool = None
        self.cache = kv_pool.PrefixCache(page_size)
        self.free: Optional[list] = None
        self.n_priv = 0
        self._beam = 0
        self._max_new = 0
        self._max_prompt = 0

    # -- sizing -----------------------------------------------------------
    def _build(self, lcfg: llama.LlamaConfig, B: int, beam: int,
               max_prompt: int, max_new: int, device):
        P = self.page_size
        prompt_rows = -(-max_prompt // P)
        # worst-case private pages per beam slot over any prompt length
        n_priv = -(-max_new // P) + 1
        cache_budget = (self.cache_pages if self.cache_pages is not None
                        else 2 * prompt_rows)
        n_pages = (1 + cache_budget + B * prompt_rows
                   + B * beam * n_priv * 2)
        self.pcfg = kv_pool.PagedConfig(
            n_layers=lcfg.n_layers, n_kv_heads=lcfg.n_kv_heads,
            head_dim=lcfg.head_dim, page_size=P, n_pages=n_pages,
            max_pages_per_seq=-(-(max_prompt + max_new) // P),
            slots=B * beam, dtype=lcfg.dtype,
            quantize_kv=self.quantize_kv)
        self.pool = kv_pool.init_pool(self.pcfg, device=device)
        self.free = list(range(n_pages - 1, 0, -1))
        self.n_priv = n_priv
        self._beam, self._max_new, self._max_prompt = beam, max_new, \
            max_prompt

    def _take(self, n: int) -> np.ndarray:
        if n > len(self.free):
            self.free.extend(self.cache.evict(n - len(self.free)))
        if n > len(self.free):
            raise MemoryError(
                f"beam session pool exhausted: need {n} pages, "
                f"{len(self.free)} free and no evictable cache entries")
        return np.asarray([self.free.pop() for _ in range(n)], np.int64)

    # -- per-batch plan -----------------------------------------------------
    def begin_batch(self, lcfg: llama.LlamaConfig, lens, digests,
                    beam: int, max_new: int, max_prompt_bound: int,
                    device="cuda"):
        if self.pcfg is None:
            self._build(lcfg, len(lens), beam, max_prompt_bound, max_new,
                        device)
        B = len(lens)
        if B * beam != self.pcfg.slots or beam != self._beam:
            raise ValueError(
                f"beam session is shaped for {self.pcfg.slots // self._beam}"
                f" x beam {self._beam}; got {B} x {beam} (pad the last "
                "chunk to the session batch size)")
        if max_new > self._max_new or int(max(lens)) > self._max_prompt:
            raise ValueError("prompt/generation length exceeds the "
                             "session's first-batch bound")
        taken: list = []

        def page_iter(n):
            pages = self._take(n)
            taken.extend(int(p) for p in pages)
            return pages

        # Pin every cached page while the plan reads the chain: _take's
        # LRU eviction must not reclaim a zero-ref page an earlier row of
        # this very plan already hit (refs for the batch are acquired
        # only once the plan is complete). Private pages are taken after
        # unpinning, when evicting non-hit cold entries is safe again.
        pinned = list(self.cache.meta)
        self.cache.acquire(pinned)
        try:
            plan = _shared_prompt_plan(lens, self.page_size, digests,
                                       chain0=self.cache.chain,
                                       page_iter=page_iter)
            self.cache.acquire(plan.hit_pages)
        except MemoryError:
            self.free.extend(sorted(set(taken), reverse=True))
            raise
        finally:
            self.cache.release(pinned)
        try:
            priv = self._take(B * beam * self.n_priv * 2)
        except MemoryError:
            self.cache.release(plan.hit_pages)
            self.free.extend(sorted(set(taken), reverse=True))
            raise
        taken.extend(int(p) for p in priv)
        private = priv.reshape(B * beam, self.n_priv, 2)
        pp = np.zeros((B, self.pcfg.max_pages_per_seq), np.int64)
        pp[:, :plan.pages.shape[1]] = plan.pages
        lens64 = np.asarray(lens, np.int64)
        beam_plan = _BeamPlan(
            prompt_pages=pp, private=private,
            g0=lens64 // self.page_size, lens=lens64,
            start=plan.start, wave=plan.wave)
        rec = {"taken": set(taken), "novel": plan.novel,
               "hits": plan.hit_pages}
        return beam_plan, rec

    def end_batch(self, rec, pool) -> None:
        """Keep the batch's KV tensors (they are the session's own, written
        in place), promote its novel full prompt blocks into the
        cross-batch cache, release its refs, and free its remaining
        pages."""
        self.pool.update({k: pool[k] for k in _kv_arrays(pool)})
        promoted = []
        for key, page in rec["novel"]:
            if self.cache.promote(key, page):
                rec["taken"].discard(page)   # lifetime -> cache
                promoted.append(page)
        # promote() refs the page for the prefilling batch; that batch
        # is done now: pages stay cached at ref 0 (evictable, reusable)
        self.cache.release(promoted)
        self.cache.release(rec["hits"])
        self.free.extend(sorted(rec["taken"], reverse=True))


def _beam_tables(plan: _BeamPlan, pcfg: kv_pool.PagedConfig, beam: int):
    """Initial per-slot page tables: shared prompt pages below g0, private
    pages from g0 on. Generation entries start at phase 1 (the init
    partial-prompt copy counts as the write of "step -1", so step 0's
    copy-on-write destinations, phase 0, never overlap its sources)."""
    B = plan.prompt_pages.shape[0]
    tables = np.zeros((B * beam, pcfg.max_pages_per_seq), np.int64)
    for r in range(B):
        for k in range(beam):
            s = r * beam + k
            g = int(plan.g0[r])
            tables[s, :g] = plan.prompt_pages[r, :g]
            n_priv = plan.private.shape[1]
            end = min(g + n_priv, pcfg.max_pages_per_seq)
            tables[s, g:end] = plan.private[s, :end - g, 1]
    return tables


_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _kv_arrays(pool):
    return [k for k in _KV_KEYS if k in pool]


def _copy_pages(pool, n_pages, src_pages, dst_pages):
    """pool k/v (+ int8-KV scale arrays) [L*n_pages, page, X] (flat
    layer-major rows): copy page src -> dst per entry, in every layer, in
    place, by indexing a [L, n_pages, ...] view. All sources are read
    before any destination is written, so the sets may overlap. The form
    the CPU reference backend ("ref") takes."""
    src, dst = src_pages.long(), dst_pages.long()
    for key in _kv_arrays(pool):
        a4 = pool[key].view(-1, n_pages, *pool[key].shape[1:])
        a4[:, dst] = a4[:, src]
    return pool


def _copy_pages_kernel(pool, n_pages, src_pages, dst_pages):
    """_copy_pages through ops/page_move.move_pages_direct: exactly the
    moved pages are read once and written once, in place. The per-layer
    moves are spread over the flat layer-major page axis. The int8 codes
    and the f32 scale slabs of a quantized pool go through the same call.
    Sources and destinations must be disjoint (the ping-pong page plan);
    on CPU tensors the plain version checks it."""
    L = pool["k"].shape[0] // n_pages
    offs = torch.arange(L, dtype=torch.int32,
                        device=src_pages.device)[:, None] * n_pages
    src_flat = (offs + src_pages.to(torch.int32)[None, :]).reshape(-1)
    dst_flat = (offs + dst_pages.to(torch.int32)[None, :]).reshape(-1)
    for key in _kv_arrays(pool):
        page_move.move_pages_direct(pool[key], src_flat, dst_flat)
    return pool


def _page_copy(lcfg: llama.LlamaConfig, pool):
    """The page copy of a beam run: the indexed copy on the CPU reference
    backend ("ref", which refuses a pool on any other device), else the
    page-move kernel's wrapper."""
    if lcfg.attn_backend == "ref":
        llama.require_cpu_for_ref(lcfg, pool["k"])
        return _copy_pages
    return _copy_pages_kernel


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def to_device(batch, device):
    """A collator's batch (numpy arrays or tensors) as tensors on `device`,
    without its host-only bookkeeping."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()
            if k != "reference_indices" and v is not None
            and not np.isscalar(v)}


@torch.no_grad()
def paged_beam_init(params, cfg: unified.UnifiedConfig, batch,
                    gen: GenerationConfig, *, page_size: int = 64,
                    prefill_bucket: Optional[int] = None,
                    quantize_kv: bool = False,
                    shared_prefix: bool = False,
                    session: Optional[BeamPoolSession] = None,
                    cascade: Optional[bool] = None):
    """Prefill prompts once (not once per beam) and lay out the beam pool
    on the parameters' device.

    batch: canonical (soft-token) model-input batch of numpy arrays or
    tensors, left-padded like the dense beam path; rows are unpacked to
    their true lengths for paged prefill. Returns (state, ctx) for
    `paged_beam_step`.

    shared_prefix=True dedups full prompt blocks across batch rows
    (content-addressed, _shared_prompt_plan): the shared leading blocks are
    written once; later rows point their tables at them and prefill only
    their private tail as a continuation forward.

    session= extends the dedup across batches on a persistent fixed-size
    pool (see BeamPoolSession): cache-hit blocks skip prefill entirely.
    Implies shared_prefix; page_size / quantize_kv come from the session.
    """
    dev = params["llama"]["embed"].device
    input_ids = np.asarray(_host(batch["input_ids"]))
    seg = np.asarray(_host(batch["seg_ids"]))
    B, Lmax = input_ids.shape
    beam = gen.beam_size
    lens = seg.sum(1).astype(np.int64)
    if session is not None:
        page_size = session.page_size
        quantize_kv = session.quantize_kv
        shared_prefix = True

    # fused-prompt embeddings for the full (padded) batch, then per-row
    # unpadding: paged prefill is position-0-based (no left padding).
    # Assembled before pool planning: the shared-prefix planner
    # content-addresses the embedding blocks (their float32 bytes).
    embeds = unified.assemble_input_embeds(
        params, cfg, to_device(batch, dev)).float().cpu().numpy()
    Lu = int(lens.max())
    dense = np.zeros((B, Lu, embeds.shape[-1]), np.float32)
    for r in range(B):
        dense[r, :int(lens[r])] = embeds[r, seg[r] > 0]

    rec = None
    if shared_prefix:
        digests = [kv_pool.PrefixCache.block_digests(
            embeds=dense[r, :int(lens[r])], page_size=page_size)
            for r in range(B)]
        if session is not None:
            plan, rec = session.begin_batch(
                cfg.llama, lens, digests, beam, gen.max_new_tokens,
                max_prompt_bound=Lmax, device=dev)
            pcfg = session.pcfg
        else:
            splan = _shared_prompt_plan(lens, page_size, digests)
            pcfg = plan_pool_config(cfg.llama, lens, beam,
                                    gen.max_new_tokens,
                                    page_size=page_size,
                                    quantize_kv=quantize_kv,
                                    n_prompt_pages=splan.n_prompt)
            # private generation pages start right after the deduped
            # prompt pages (same ping-pong pairing as _plan_pages)
            P = page_size
            n_priv = _n_private(lens, gen.max_new_tokens, P)
            priv0 = 1 + splan.n_prompt
            private = np.arange(
                priv0, priv0 + B * beam * n_priv * 2).reshape(
                B * beam, n_priv, 2)
            if private.max(initial=0) >= pcfg.n_pages:
                raise ValueError("pool too small for the beam page plan")
            pp = np.zeros((B, pcfg.max_pages_per_seq), np.int64)
            pp[:, :splan.pages.shape[1]] = splan.pages
            plan = _BeamPlan(prompt_pages=pp, private=private,
                             g0=(lens // P).astype(np.int64),
                             lens=np.asarray(lens, np.int64),
                             start=splan.start, wave=splan.wave)
    else:
        pcfg = plan_pool_config(cfg.llama, lens, beam, gen.max_new_tokens,
                                page_size=page_size,
                                quantize_kv=quantize_kv)
        plan = _plan_pages(pcfg, lens, beam, gen.max_new_tokens)
    # a session's pool carries the cached pages' bytes across batches;
    # single-run pools start zeroed. The dict is this batch's own; the k/v
    # tensors in it are the session's and are written in place.
    pool = (dict(session.pool) if session is not None
            else kv_pool.init_pool(pcfg, device=dev))

    # prefill rows r=0..B-1 through slots 0..B-1 whose tables point at the
    # prompt pages (partial last page included: beams copy it right after)
    pt = np.zeros((pcfg.slots, pcfg.max_pages_per_seq), np.int64)
    pt[:B] = plan.prompt_pages
    pool["page_table"] = torch.as_tensor(pt, dtype=torch.int32, device=dev)
    pool["seq_len"] = torch.zeros((pcfg.slots,), dtype=torch.int32,
                                  device=dev)

    # prefill in dependency waves (one wave of all rows without sharing):
    # a row runs only after the rows that wrote its shared pages
    last_logits = torch.empty((B, cfg.llama.vocab_size), dtype=torch.float32,
                              device=dev)
    for w in range(int(plan.wave.max()) + 1):
        rows = np.nonzero(plan.wave == w)[0]
        tails = (lens[rows] - plan.start[rows]).astype(np.int64)
        T = int(tails.max())
        if prefill_bucket and prefill_bucket >= T:
            T = prefill_bucket
        elif session is not None:
            T = _next_pow2(T)  # a bounded set of prefill widths per session
        emb_w = np.zeros((len(rows), T, dense.shape[-1]), np.float32)
        seg_w = np.zeros((len(rows), T), np.int32)
        for i, r in enumerate(rows):
            s, L = int(plan.start[r]), int(lens[r])
            emb_w[i, :L - s] = dense[r, s:L]
            seg_w[i, :L - s] = 1
        rows_t = torch.as_tensor(rows, dtype=torch.long, device=dev)
        # continuation semantics: positions derive from seq_len, so a row
        # with a shared prefix resumes at its boundary and attends to the
        # shared pages through its table
        pool["seq_len"][rows_t] = torch.as_tensor(
            plan.start[rows], dtype=torch.int32, device=dev)
        logits, pool = llama.paged_forward(
            params["llama"], cfg.llama, pool, pcfg, rows_t,
            input_embeds=torch.from_numpy(emb_w).to(dev, cfg.llama.dtype),
            seg_ids=torch.from_numpy(seg_w).to(dev),
            logits_at=torch.as_tensor(tails - 1, device=dev),
            max_position=int(lens[rows].max()) - 1)
        last_logits[rows_t] = logits[:, 0]

    # beam tables + copy each prompt's partial page into every beam's
    # private page 0 (only when the prompt ends mid-page)
    tables = _beam_tables(plan, pcfg, beam)
    src, dst = [], []
    for r in range(B):
        if lens[r] % pcfg.page_size != 0:
            for k in range(beam):
                s = r * beam + k
                src.append(plan.prompt_pages[r, plan.g0[r]])
                dst.append(plan.private[s, 0, 1])  # phase 1 = "step -1"
    if src:
        # a prompt page is never a private page, so the sets are disjoint
        # and the direct page move applies here as in the steps
        copy = _page_copy(cfg.llama, pool)
        copy(pool, pcfg.n_pages,
             torch.as_tensor(np.asarray(src), dtype=torch.int32, device=dev),
             torch.as_tensor(np.asarray(dst), dtype=torch.int32, device=dev))
    pool["page_table"] = torch.as_tensor(tables, dtype=torch.int32,
                                         device=dev)
    pool["seq_len"] = torch.as_tensor(np.repeat(lens, beam),
                                      dtype=torch.int32, device=dev)

    logp0 = torch.log_softmax(last_logits, dim=-1).repeat_interleave(
        beam, dim=0)                                       # [B*beam, V]
    tokens0, scores0, done0 = beam_start(B, gen, dev)
    state = (tokens0, pool, logp0, scores0, done0)
    # grouped-prefix cascade decode (llama._cascade_decode_attention):
    # default on off the "ref" CPU backend: the prompt's full pages are
    # gathered once per beam group instead of once per beam. Fixed widths:
    # prefix = full prompt pages (the session bound keeps one width across
    # batches), tail = private generation pages + the partial prompt page.
    if cascade is None:
        cascade = cfg.llama.attn_backend != "ref" and beam > 1
    pp_static = (session._max_prompt // page_size if session is not None
                 else int(plan.g0.max()))
    cpages = ((pp_static, plan.private.shape[1] + 1)
              if cascade and beam > 1 and pp_static > 0 else None)
    ctx = {"pcfg": pcfg, "beam": beam, "B": B,
           "private": torch.as_tensor(plan.private, dtype=torch.long,
                                      device=dev),
           "g0": torch.as_tensor(plan.g0, dtype=torch.long, device=dev),
           "start": plan.start, "wave": plan.wave, "session_rec": rec,
           "cascade_pages": cpages, "max_len": int(lens.max())}
    return state, ctx


@torch.no_grad()
def paged_beam_step(params, cfg: unified.UnifiedConfig,
                    gen: GenerationConfig, pcfg: kv_pool.PagedConfig,
                    beam: int, private, g0, state, t: int,
                    cascade_pages=None, max_position: Optional[int] = None):
    """One paged diverse-beam step: shared selection -> page-table row
    gather + partial-page copy-on-write -> one paged decode token. The pool
    is updated in place. private [slots, n_priv, 2] and g0 [B] are the page
    plan on the device; t is the step's index, a host int (its parity is
    the ping-pong phase).

    cascade_pages=(prefix_pages, tail_pages) routes the decode forward
    through the grouped-prefix cascade attention
    (llama._cascade_decode_attention): each prompt's immutable full pages
    are gathered once per beam group instead of once per beam.
    max_position: the host-side bound of this step's positions (the
    longest prompt + t), see llama.paged_forward."""
    tokens, pool, logp, scores, done = state
    B = scores.shape[0]
    dev = scores.device
    new_tokens, new_parent, new_scores = diverse_beam_select(
        logp.reshape(B, beam, -1), scores, done, gen)
    # token history + done reorder (as dense); absolute parent slot ids
    tokens, done, flat_parent = reorder_beams(tokens, done, new_tokens,
                                              new_parent, t, gen)

    # --- page-table reorder: max_pages int32 per slot, not KV ---
    table = pool["page_table"].long()                # [slots, P]
    seq_len = pool["seq_len"].long()                 # [slots]
    parent_table = table[flat_parent]                # [slots, P]
    cur_idx = (seq_len // pcfg.page_size)[:, None]   # [slots, 1]
    g0_slot = g0.repeat_interleave(beam)             # [slots]
    # entries >= cur point at this slot's private pages; below cur share
    # the parent's immutable pages
    idx = torch.arange(pcfg.max_pages_per_seq, device=dev)[None, :]
    priv_cols = (idx - g0_slot[:, None]).clamp(0, private.shape[1] - 1)
    # ping-pong phase: step t writes its slots' phase-(t%2) pages, so
    # copy-on-write sources (parent pages, last written at phase 1-t%2
    # or at prefill) never collide with destinations
    own_pages = torch.gather(private[..., t % 2], 1, priv_cols)
    new_table = torch.where(idx >= cur_idx, own_pages, parent_table)

    # copy-on-write: parent's current partial page -> own private page
    src = torch.gather(parent_table, 1, cur_idx)[:, 0]
    dst = torch.gather(new_table, 1, cur_idx)[:, 0]
    copy = _page_copy(cfg.llama, pool)
    copy(pool, pcfg.n_pages, src, dst)
    pool["page_table"] = new_table.to(torch.int32)

    # one paged decode token for every slot
    step_tok = torch.where(done.reshape(-1), gen.pad_token_id,
                           new_tokens.reshape(-1))
    share = {}
    if cascade_pages is not None:
        share = dict(share_gsz=beam,
                     share_prefix_pages=int(cascade_pages[0]),
                     share_tail_pages=int(cascade_pages[1]),
                     share_g0=g0_slot)
    logits, pool = llama.paged_forward(
        params["llama"], cfg.llama, pool, pcfg,
        torch.arange(B * beam, device=dev), tokens=step_tok[:, None],
        max_position=max_position, **share)
    logp_next = torch.log_softmax(logits[:, -1], dim=-1)
    return (tokens, pool, logp_next, new_scores, done)


@torch.no_grad()
def paged_beam_generate(params, cfg: unified.UnifiedConfig, batch,
                        gen: GenerationConfig, *, page_size: int = 64,
                        quantize_kv: bool = False,
                        shared_prefix: bool = False,
                        session: Optional[BeamPoolSession] = None,
                        cascade: Optional[bool] = None, after_init=None):
    """Full paged diverse-beam generation on the parameters' device.
    Returns (tokens [B, beam, T], scores [B, beam]) ranked by score: the
    same contract (and the same tokens, tested) as
    generation.generate_beam. The loop always runs all max_new_tokens
    steps, stepped from the host with nothing read back until the end.

    shared_prefix=True dedups identical leading prompt blocks across the
    batch (see paged_beam_init). session= (a BeamPoolSession) extends the
    dedup across batches on a persistent pool: later batches skip the
    cached instruction prefill. cascade= (default: on off "ref"):
    grouped-prefix cascade decode attention; see paged_beam_init and
    paged_beam_step. after_init: an optional callable, called with the
    init's ctx once the prefill is issued and before the first step (a
    caller that times the prefill and the steps apart, or reads the page
    plan's `start` and `wave`, hooks in here).
    """
    state, ctx = paged_beam_init(params, cfg, batch, gen,
                                 page_size=page_size,
                                 quantize_kv=quantize_kv,
                                 shared_prefix=shared_prefix,
                                 session=session, cascade=cascade)
    if after_init is not None:
        after_init(ctx)
    for t in range(gen.max_new_tokens):
        state = paged_beam_step(params, cfg, gen, ctx["pcfg"], ctx["beam"],
                                ctx["private"], ctx["g0"], state, t,
                                cascade_pages=ctx["cascade_pages"],
                                max_position=ctx["max_len"] + t)
    tokens, pool_f, _, scores, _ = state
    if session is not None:
        session.end_batch(ctx["session_rec"], pool_f)
    return rank_beams(tokens, scores)
