"""ESM alphabet protein tokenizer + long-protein chunk splitting.

Replaces fair-esm's Alphabet/BatchConverter usage (reference:
procyon/data/data_utils.py:53-142 convert_batch_protein) and the
batched_split_long_seq / reverse_batched_split machinery
(procyon/training/train_utils.py:1497-1649): long sequences become extra
rows with a shared group id, and CLS/EOS are placed per-chunk so each row is
a valid encoder input.

The 33-symbol alphabet matches the standard ESM ordering exactly so released
ESM2 checkpoints convert weight-for-weight.
"""

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

TOKENS = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
TOK_TO_IDX = {t: i for i, t in enumerate(TOKENS)}
CLS_IDX = TOK_TO_IDX["<cls>"]
PAD_IDX = TOK_TO_IDX["<pad>"]
EOS_IDX = TOK_TO_IDX["<eos>"]
UNK_IDX = TOK_TO_IDX["<unk>"]
MASK_IDX = TOK_TO_IDX["<mask>"]
VOCAB = len(TOKENS)


def encode(seq: str) -> np.ndarray:
    """Residue string -> ids (no cls/eos)."""
    return np.asarray([TOK_TO_IDX.get(c, UNK_IDX) for c in seq.upper()],
                      np.int32)


@dataclasses.dataclass(frozen=True)
class ProteinBatch:
    tokens: np.ndarray        # [R, Lp] with cls/eos/pad
    group_ids: np.ndarray     # [R] row -> original protein index
    row_valid: np.ndarray     # [R] 1.0 valid, 0.0 padding row
    num_groups: int


def batch_encode(seqs: Sequence[str], *, max_len: int = 1024,
                 long_strategy: str = "split", max_rows: int = 0,
                 pad_rows_to: int = 0) -> ProteinBatch:
    """Encode proteins to a fixed-shape row batch.

    max_len: residues per row (excluding cls/eos).
    long_strategy: "split" -> extra rows per chunk (reference
      long_protein_strategy="split"); "truncate" -> crop.
    pad_rows_to: pad the row dim to this static size (0 = exact).
    """
    rows: List[np.ndarray] = []
    group_ids: List[int] = []
    for gi, seq in enumerate(seqs):
        ids = encode(seq)
        if long_strategy == "truncate" or len(ids) <= max_len:
            chunks = [ids[:max_len]]
        else:
            chunks = [ids[i:i + max_len] for i in range(0, len(ids), max_len)]
        for ch in chunks:
            rows.append(ch)
            group_ids.append(gi)
            if max_rows and len(rows) >= max_rows:
                break
        if max_rows and len(rows) >= max_rows:
            break

    R = max(len(rows), 1)
    if pad_rows_to:
        R = max(R, pad_rows_to)
    width = max((len(r) for r in rows), default=1) + 2
    tokens = np.full((R, width), PAD_IDX, np.int32)
    valid = np.zeros((R,), np.float32)
    gids = np.zeros((R,), np.int32)
    for i, (r, g) in enumerate(zip(rows, group_ids)):
        tokens[i, 0] = CLS_IDX
        tokens[i, 1:1 + len(r)] = r
        tokens[i, 1 + len(r)] = EOS_IDX
        valid[i] = 1.0
        gids[i] = g
    return ProteinBatch(tokens=tokens, group_ids=gids, row_valid=valid,
                        num_groups=len(seqs))


def bucket_protein_batch(pb: "ProteinBatch", *, width: int,
                         row_bucket: int = 64) -> "ProteinBatch":
    """Re-pad a ProteinBatch to jit-stable shapes: token width pinned to
    `width` (= max_len + 2 for cls/eos) and rows rounded UP to a multiple
    of `row_bucket`. batch_encode emits exact shapes (width tracks the
    longest row; rows track chunk splits), which would recompile the
    all-protein eval sweeps once per distinct shape on the remote TPU."""
    R, W = pb.tokens.shape
    assert W <= width, (W, width)
    Rb = -(-max(R, 1) // row_bucket) * row_bucket
    tokens = np.full((Rb, width), PAD_IDX, np.int32)
    tokens[:R, :W] = pb.tokens
    group_ids = np.zeros((Rb,), np.int32)
    group_ids[:R] = pb.group_ids
    row_valid = np.zeros((Rb,), np.float32)
    row_valid[:R] = pb.row_valid
    return ProteinBatch(tokens=tokens, group_ids=group_ids,
                        row_valid=row_valid, num_groups=pb.num_groups)


def mask_for_mlm(tokens: np.ndarray, rng: np.random.Generator, *,
                 mask_prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """BERT-style masking (ProteinMLMCollator._mask_tokens,
    procyon/data/data_collator.py:113-174): select 15% of residues;
    80% -> <mask>, 10% -> random residue, 10% unchanged. Returns
    (masked_tokens, labels) with -100 on unselected positions."""
    special = np.isin(tokens, [PAD_IDX, CLS_IDX, EOS_IDX])
    sel = (rng.random(tokens.shape) < mask_prob) & ~special
    labels = np.where(sel, tokens, -100).astype(np.int32)
    r = rng.random(tokens.shape)
    out = tokens.copy()
    out[sel & (r < 0.8)] = MASK_IDX
    rand_idx = sel & (r >= 0.8) & (r < 0.9)
    out[rand_idx] = rng.integers(4, 24, rand_idx.sum())
    return out, labels
