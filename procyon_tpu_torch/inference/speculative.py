"""Self-speculative greedy decoding over the paged KV pool (counterpart of
procyon_tpu/inference/speculative.py).

A decode step is bound by streaming the weights, so verifying K drafted
tokens in one forward costs little more than decoding one token: the
[B, K+1] token block rides the same weight stream, and every accepted draft
token is a decode step the server never has to run.

Greedy speculative decoding is exact: the emitted sequence is the verify
forward's own greedy sequence whatever the draft proposes; drafts change
cost, never tokens (the verify forward is causal, so an accepted prefix
reproduces its logits on re-run). On the CPU in f32 this equals the plain
T=1 decode path token for token (tested); in bf16 on the card the T=K+1 and
T=1 routes can differ in argmax on near ties (with random weights almost
everywhere; models/synthetic.py builds weights whose margin rules that
out). One verify round:

    feed   [t0, d1 .. dK]      t0 = the pending (last emitted) token
    greedy g_i = argmax logits at position i
    accept the longest prefix where d_{i+1} == g_i
    emit   g_0 .. g_m' (m = m'+1 tokens, 1 <= m <= K+1)
    rewind the slot's seq_len from start+K+1 to start+m

The rewind makes the rejected rows invisible (paged attention masks cached
positions >= seq_len) and the next round's writes overwrite them in place.

Drafts come from an n-gram proposer over the slot's own token history
(prompt + generated): the continuation that followed the most recent
occurrence of the current n-gram. No second network and no extra weights;
the draft quality rides the repetitiveness of the text. A model-based
drafter can replace `propose` without touching the verify math.

Temperature sampling composes through the rejection-sampling correction
(Leviathan et al. 2023) in serving.ContinuousBatcher, specialised to
deterministic proposers (every drafter here is a point mass): accept d with
probability p(d), resample the stop token from p renormalised over x != d,
draw a bonus token from p unmasked after a full accept. The emitted
marginal at every position is exactly p. The device-drafted spec_quantum
trip is greedy only.
"""

from typing import List, Sequence

import numpy as np
import torch


def ngram_propose(history: Sequence[int], k: int, *, n_max: int = 3,
                  n_min: int = 1) -> List[int]:
    """Draft k tokens: find the most recent earlier occurrence of the
    longest suffix n-gram (n_max down to n_min) of `history` and return
    the k tokens that followed it. Pads by repeating the last token when
    no match (or not enough continuation) exists — a wrong draft costs
    nothing (exact verify), an absent one wastes the slot's lane.

    Host-side numpy over the slot's python token list: runs between
    serving rounds, never touches the device.
    """
    h = np.asarray(history, dtype=np.int64)
    L = h.shape[0]
    last = int(h[-1]) if L else 0
    draft = None
    for n in range(min(n_max, L - 1), n_min - 1, -1):
        pat = h[L - n:]
        # candidate start positions of the n-gram, excluding the suffix
        # occurrence itself; windows end before L-n
        if L - n <= 0:
            continue
        win = np.lib.stride_tricks.sliding_window_view(h[:L - 1], n) \
            if L - 1 >= n else np.empty((0, n), np.int64)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if hits.size:
            p = int(hits[-1])
            cont = h[p + n:p + n + k]
            draft = list(int(t) for t in cont)
            break
    if draft is None:
        draft = []
    while len(draft) < k:
        draft.append(draft[-1] if draft else last)
    return draft[:k]


def accept_counts(draft_tail: np.ndarray, greedy: np.ndarray) -> np.ndarray:
    """m [B]: tokens emitted per row. draft_tail [B, K] (the d_1..d_K fed
    after the pending token), greedy [B, K+1] (argmax at every fed
    position). m = 1 + length of the matched prefix d_{i+1} == g_i.

    numpy mirror of the rule in serving.ContinuousBatcher's verify round,
    for tests."""
    match = draft_tail == greedy[:, :-1]
    # cumulative prefix: stop at the first mismatch
    prefix = np.cumprod(match.astype(np.int64), axis=1)
    return 1 + prefix.sum(axis=1)


def device_ngram_draft(hist: torch.Tensor, lens: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Device-side n-gram drafter: the tensor counterpart of
    `ngram_propose` for speculative trips (serving spec_quantum > 1), where
    R verify rounds run per host trip and the draft is computed between
    rounds without a read by the host.

    hist [B, H] int32 (prompt + generated, front-aligned), lens [B] valid
    lengths, both on one device. Matches the most recent earlier occurrence
    of the trailing 2-gram, falling back to the trailing 1-gram, then to
    repeating the last token. Simpler than the host proposer's 3->1-gram
    ladder: the draft only affects cost, never tokens, so the two
    proposers need not agree. Rows with lens == 0 return garbage (callers
    mask dead slots). Returns [B, k] in hist's dtype."""
    B, H = hist.shape
    dev = hist.device
    lens = lens.long()
    idx = torch.arange(H, device=dev)
    last = hist.gather(1, (lens - 1).clamp_min(0)[:, None])        # [B, 1]
    prev = hist.gather(1, (lens - 2).clamp_min(0)[:, None])
    # 2-gram matches at p: hist[p] == prev, hist[p+1] == last, with the
    # continuation starting inside the valid region and the suffix's own
    # occurrence (p = lens-2) excluded
    m2 = (hist[:, :-1] == prev) & (hist[:, 1:] == last)
    m2 &= (idx[None, :H - 1] < (lens - 2)[:, None]) & (lens > 2)[:, None]
    has2 = m2.any(dim=1)
    p2 = torch.where(m2, idx[None, :H - 1], -1).amax(dim=1)
    # 1-gram fallback: hist[p] == last, p < lens-1
    m1 = (hist == last) & (idx[None] < (lens - 1)[:, None])
    has1 = m1.any(dim=1)
    p1 = torch.where(m1, idx[None], -1).amax(dim=1)
    # without a match the reference's argmax of an all -1 row is 0
    start = torch.where(has2, p2.clamp_min(0) + 2, p1.clamp_min(0) + 1)
    cont_idx = start[:, None] + torch.arange(k, device=dev)[None]
    cont = hist.gather(1, cont_idx.clamp(0, H - 1))
    # positions past the valid history repeat the last token
    cont = torch.where(cont_idx < lens[:, None], cont, last)
    return torch.where((has2 | has1)[:, None], cont, last.expand(B, k))
