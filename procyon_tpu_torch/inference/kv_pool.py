"""Paged KV cache: pool layout, page allocator, shared-prefix page cache and
the pool write (counterpart of procyon_tpu/inference/kv_pool.py).

A fixed pool of KV pages shared by all live sequences and a host-side page
allocator, so memory scales with the tokens actually cached instead of
n_seqs x max_len.

Layout (a dict of tensors on one device):
  pool k/v : [L * n_pages, page_size, Hkv*D], flat lanes. The layer axis
             is flattened into the page axis: layer l's page p is row
             l*n_pages + p.
  page_table : [slots, max_pages] int32, per-layer page ids 0..n_pages-1;
               consumers add l*n_pages for layer l
  seq_len    : [slots] int32 (tokens cached; 0 = slot empty)
  k_scale/v_scale : [L * n_pages, page_size, Hkv] f32, present only when
               cfg.quantize_kv: the pool then stores int8 K/V with
               per-(token, kv-head) symmetric scales. The K scale
               multiplies each head's score row and the V scale folds into
               the probabilities before the P.V product, so the int8 pool
               halves gather traffic and pool memory with two elementwise
               corrections.

Where the reference returns a new pool dict, the port updates the pool's
tensors in place and returns the same dict.
"""

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 64
    n_pages: int = 256
    max_pages_per_seq: int = 16
    slots: int = 8
    dtype: torch.dtype = torch.bfloat16
    # store K/V pages as int8 with per-(token, head) scales: halves pool
    # memory and decode gather traffic
    quantize_kv: bool = False

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim

    @property
    def max_ctx(self):
        return self.max_pages_per_seq * self.page_size


def init_pool(cfg: PagedConfig, *, device="cuda") -> Dict:
    device = torch.device(device)
    kv_dtype = torch.int8 if cfg.quantize_kv else cfg.dtype
    rows = cfg.n_layers * cfg.n_pages
    pool = {
        "k": torch.zeros((rows, cfg.page_size, cfg.kv_dim), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((rows, cfg.page_size, cfg.kv_dim), dtype=kv_dtype,
                         device=device),
        "page_table": torch.zeros((cfg.slots, cfg.max_pages_per_seq),
                                  dtype=torch.int32, device=device),
        "seq_len": torch.zeros((cfg.slots,), dtype=torch.int32,
                               device=device),
    }
    if cfg.quantize_kv:
        shape = (rows, cfg.page_size, cfg.n_kv_heads)
        pool["k_scale"] = torch.zeros(shape, dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(shape, dtype=torch.float32,
                                      device=device)
    return pool


def quantize_rows(x, n_kv_heads):
    """Per-(row, kv-head) symmetric int8 quantization of flat-lane K/V
    rows [..., Hkv*D] -> (q int8 [..., Hkv*D], scale f32 [..., Hkv]).
    Rounds half to even and divides by the scale (no reciprocal), as the
    reference does."""
    *lead, KD = x.shape
    hd = KD // n_kv_heads
    xh = x.reshape(*lead, n_kv_heads, hd).float()
    amax = xh.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(xh / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(*lead, KD), scale


class PageAllocator:
    """Host-side free-list over pool pages. Page 0 is reserved as the null
    page (page_table entries for unallocated logical pages point at it)."""

    def __init__(self, cfg: PagedConfig):
        self.cfg = cfg
        self.free: List[int] = list(range(cfg.n_pages - 1, 0, -1))
        self.owned: Dict[int, List[int]] = {}

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def can_admit(self, n_tokens: int, reserved: int = 0) -> bool:
        """reserved = page-table entries already covered by shared
        prefix-cache pages (they cost no private budget)."""
        return len(self.free) >= self.pages_for(n_tokens) - reserved

    def allocate(self, slot: int, n_tokens: int,
                 reserved: int = 0) -> List[int]:
        need = (self.pages_for(n_tokens) - reserved
                - len(self.owned.get(slot, [])))
        if need > len(self.free):
            raise MemoryError(
                f"paged KV pool exhausted: need {need} pages, "
                f"{len(self.free)} free")
        pages = [self.free.pop() for _ in range(max(need, 0))]
        self.owned.setdefault(slot, []).extend(pages)
        return self.owned[slot]

    def release(self, slot: int):
        self.free.extend(reversed(self.owned.pop(slot, [])))

    def disown(self, slot: int, page: int):
        """Transfer a page out of this slot's ownership (prefix-cache
        promotion: the page's lifetime is now the cache's refcount, not
        the slot's release)."""
        self.owned[slot].remove(page)


class PrefixCache:
    """Host-side shared-prefix page cache (automatic prefix caching).

    Every full page-size block of a prompt is content-addressed by a
    rolling hash chain (block digest keyed by the digest of everything
    before it, so a block is only shared under an identical prefix); on
    admission the longest chain of cached blocks is reused directly as
    shared page-table entries: the prefill forward starts after the shared
    region and the shared pages cost no pool budget. Pages are refcounted:
    a live user holds a reference on every shared page in its table;
    zero-ref pages stay cached and are evicted LRU back to the free list
    only when an allocation needs them.

    Exactness: a cache hit reuses the bytes an earlier identical prefill
    wrote: positions, rotary phases and page layout are absolute from 0.

    Safety invariant: only full blocks strictly inside the prompt are ever
    shared, and at least the final prompt token is always left to the
    private tail, so writes land in private pages and shared pages are
    write-once.

    Cache lifetimes are per pool: entries are page indices into one
    physical pool's flat page axis.
    """

    _ROOT = b"procyon-prefix-root"

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.chain: Dict[bytes, int] = {}    # node key -> page id
        self.meta: Dict[int, dict] = {}      # page -> {key, ref, clock}
        self._clock = 0
        self.stats = {"hit_tokens": 0, "miss_tokens": 0, "evicted": 0}

    # -- content addressing ---------------------------------------------
    @staticmethod
    def block_digests(prompt=None, embeds=None, page_size: int = 64,
                      domain: bytes = b"") -> List[bytes]:
        """Digests of the prompt's full blocks, shareable region only (the
        last prompt token is excluded so the prefill tail is never empty:
        its logits produce the first sampled token). Token and fused
        (embedding) prompts hash in disjoint domains. `embeds` is a numpy
        array [n, dim]: its rows' bytes are hashed as they are, so callers
        hand over C-contiguous float32.

        `domain` extends the hash domain for anything beyond the prompt
        bytes that changes the KV a prefill writes (a per-request LoRA
        expert)."""
        if embeds is not None:
            n = embeds.shape[0]
            tag = b"emb:" + domain
            block = lambda j: np.ascontiguousarray(
                embeds[j * page_size:(j + 1) * page_size]).tobytes()
        else:
            arr = np.asarray(prompt, np.int32)
            n = arr.shape[0]
            tag = b"tok:" + domain
            block = lambda j: arr[j * page_size:(j + 1) * page_size
                                  ].tobytes()
        n_full = max((n - 1) // page_size, 0)
        return [hashlib.blake2b(tag + block(j), digest_size=16).digest()
                for j in range(n_full)]

    def node_keys(self, digests: List[bytes]) -> List[bytes]:
        keys, parent = [], self._ROOT
        for d in digests:
            parent = hashlib.blake2b(parent + d, digest_size=16).digest()
            keys.append(parent)
        return keys

    # -- lookup / lifetime ------------------------------------------------
    def match(self, digests: List[bytes]) -> Tuple[List[int], List[bytes]]:
        """Longest cached chain for these block digests. Returns (shared
        page ids, node keys for all blocks, hits then misses; the caller
        promotes the miss blocks after prefilling them)."""
        keys = self.node_keys(digests)
        pages = []
        for k in keys:
            p = self.chain.get(k)
            if p is None:
                break
            pages.append(p)
        return pages, keys

    def acquire(self, pages: List[int]) -> None:
        self._clock += 1
        for p in pages:
            m = self.meta[p]
            m["ref"] += 1
            m["clock"] = self._clock

    def release(self, pages: List[int]) -> None:
        for p in pages:
            self.meta[p]["ref"] -= 1

    def promote(self, key: bytes, page: int) -> bool:
        """Register a freshly-prefilled full-block page under its chain
        key with ref 1 (the prefilling user's own use). Returns False if
        the key is already cached (the page stays private)."""
        if key in self.chain:
            return False
        self._clock += 1
        self.chain[key] = page
        self.meta[page] = {"key": key, "ref": 1, "clock": self._clock}
        return True

    def evict(self, n: int) -> List[int]:
        """Evict up to n zero-ref pages, least recently used first;
        returns the page ids (the caller hands them to its free list)."""
        victims = sorted(
            (p for p, m in self.meta.items() if m["ref"] <= 0),
            key=lambda p: self.meta[p]["clock"])[:n]
        for p in victims:
            del self.chain[self.meta.pop(p)["key"]]
        self.stats["evicted"] += len(victims)
        return victims

    def n_evictable(self) -> int:
        return sum(1 for m in self.meta.values() if m["ref"] <= 0)


def write_tokens(pool: Dict, cfg: PagedConfig, layer_k, layer_v, slot_ids,
                 start_pos):
    """Scatter new K/V rows into the pool, in place; returns the pool.
    layer_k/v [L, B, T, Hkv*D] for B slots writing T tokens each starting
    at their start_pos [B]. Positions past max_pages_per_seq are clipped to
    the last page-table column, so overflow writes land on whatever that
    entry holds: the repeated last private page for beam tables, but page 0
    (the null page) for PageAllocator-filled tables whose entries past the
    allocation are 0; callers must guarantee allocation first.

    quantize_kv pools quantize the rows here with the same `quantize_rows`
    the decode step used for the token's own attention (bit-identical by
    construction: one function, same input).

    Called once after the layer loop: a layer attends to the in-flight
    tokens separately, so writing them before that layer's attention would
    count them twice."""
    L, B, T, KD = layer_k.shape
    dev = layer_k.device
    pos = start_pos.long()[:, None] + torch.arange(T, device=dev)[None, :]
    logical = pos // cfg.page_size                               # [B, T]
    offset = pos % cfg.page_size
    table = pool["page_table"][slot_ids.long()].long()           # [B, P]
    page = torch.gather(
        table, 1, logical.clamp(0, cfg.max_pages_per_seq - 1))
    # flat scatter indices: [L*B*T] flat-pool rows (l*n_pages + page)
    l_off = torch.arange(L, device=dev)[:, None] * cfg.n_pages
    flat_page = (page.reshape(1, -1) + l_off).reshape(-1)
    off_f = offset.reshape(1, -1).expand(L, -1).reshape(-1)
    idx = (flat_page, off_f)
    if cfg.quantize_kv:
        kq, ks = quantize_rows(layer_k.reshape(-1, KD), cfg.n_kv_heads)
        vq, vs = quantize_rows(layer_v.reshape(-1, KD), cfg.n_kv_heads)
        pool["k"].index_put_(idx, kq)
        pool["v"].index_put_(idx, vq)
        pool["k_scale"].index_put_(idx, ks)
        pool["v_scale"].index_put_(idx, vs)
    else:
        pool["k"].index_put_(idx, layer_k.reshape(-1, KD).to(pool["k"].dtype))
        pool["v"].index_put_(idx, layer_v.reshape(-1, KD).to(pool["v"].dtype))
    return pool
