"""WordPiece tokenizer for the BERT-family text encoders (a copy of
procyon_tpu/data/wordpiece.py: host code, numpy only).

Native equivalent of the HF ``BertTokenizer`` the reference loads for every
BERT baseline (procyon/model/pubmedbert.py:29, biotranslator_tencoder.py,
evaluate/framework/caption.py:68-103 via bert_score): basic tokenization
(lowercase, accent strip, punctuation split) followed by greedy
longest-match WordPiece with ``##`` continuation pieces.  Dependency-free -
reads a plain ``vocab.txt`` so released BERT/SciBERT/PubMedBERT vocabs load
directly; a deterministic synthetic vocab supports weight-free tests.
"""

import dataclasses
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """Whitespace split + punctuation isolation + accent stripping (the
    HF BasicTokenizer behavior bert_score inherits)."""
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    word: List[str] = []
    for ch in text:
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punct(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


@dataclasses.dataclass
class Encoded:
    ids: np.ndarray        # [B, S] int32, PAD-padded
    attention_mask: np.ndarray  # [B, S] int32
    token_type_ids: np.ndarray  # [B, S] int32 (all zeros; single segment)


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.mask_id = vocab.get(MASK, self.unk_id)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase=lowercase)

    @classmethod
    def synthetic(cls, words: Sequence[str] = (), vocab_size: int = 512):
        """Deterministic test vocab: specials + a-z single chars (+ their
        ## continuations) + the given whole words."""
        vocab: Dict[str, int] = {}
        for tok in (PAD, UNK, CLS, SEP, MASK):
            vocab[tok] = len(vocab)
        for c in "abcdefghijklmnopqrstuvwxyz0123456789.,;:!?-()":
            vocab[c] = len(vocab)
            vocab["##" + c] = len(vocab)
        for w in words:
            for form in (w.lower(), "##" + w.lower()):
                if form not in vocab and len(vocab) < vocab_size:
                    vocab[form] = len(vocab)
        return cls(vocab)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, max_len: Optional[int] = None,
               add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            budget = None if max_len is None else max_len - 2
            if budget is not None:
                ids = ids[:max(budget, 0)]
            return [self.cls_id] + ids + [self.sep_id]
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def batch_encode(self, texts: Sequence[str], max_len: int = 512,
                     pad_to: Optional[int] = None) -> Encoded:
        rows = [self.encode(t, max_len=max_len) for t in texts]
        S = pad_to or max(len(r) for r in rows)
        ids = np.full((len(rows), S), self.pad_id, np.int32)
        mask = np.zeros((len(rows), S), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return Encoded(ids=ids, attention_mask=mask,
                       token_type_ids=np.zeros_like(ids))

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        words: List[str] = []
        special = {self.pad_id, self.cls_id, self.sep_id}
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            piece = self.inv.get(i, UNK)
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)
