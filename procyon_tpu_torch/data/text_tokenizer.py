"""Text tokenizer protocol + adapters.

The reference builds its tokenizer from the HF Llama tokenizer and appends
special tokens in a load-bearing order (model_unified.py:1088-1133:
`<|protein|>`, `[PROT]`, `[ANSWER]`, `<|struct|>`, `<|drug|>`, then `[EXT]`
last). Here the tokenizer is an interface the collators consume:

  * HFTokenizerAdapter — wraps a transformers tokenizer loaded from a local
    path (Llama-2 sentencepiece or Llama-3 tiktoken files), adding the same
    special tokens in the same order so checkpoint embeddings line up.
  * WordTokenizer — dependency-free deterministic hash tokenizer for tests
    and synthetic pipelines.

Special tokens `<|protein|>`/`<|struct|>`/`<|drug|>` are *placeholders*:
the collator rewrites their positions into soft_map entries.  `[EXT]` is a
splice marker consumed by the prompt composer (never reaches the model).
"""

import dataclasses
from typing import List, Optional, Sequence

SPECIAL_TOKENS = ["<|protein|>", "[PROT]", "[ANSWER]", "<|struct|>",
                  "<|drug|>", "[EXT]"]


@dataclasses.dataclass
class TokenizerSpec:
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_id: int
    protein_id: int
    prot_query_id: int   # [PROT]
    answer_id: int
    struct_id: int
    drug_id: int
    ext_id: int
    yes_id: int
    no_id: int


class WordTokenizer:
    """Deterministic word-hash tokenizer (tests / synthetic data).

    ids: 0=pad, 1=bos, 2=eos, 3..8 special tokens, 9=yes, 10=no,
    11.. hashed words.
    """

    def __init__(self, vocab_size: int = 4096):
        self._vocab = vocab_size
        self.spec = TokenizerSpec(
            vocab_size=vocab_size, pad_id=0, bos_id=1, eos_id=2,
            protein_id=3, prot_query_id=4, answer_id=5, struct_id=6,
            drug_id=7, ext_id=8, yes_id=9, no_id=10)
        self._special = {
            "<|protein|>": 3, "[PROT]": 4, "[ANSWER]": 5, "<|struct|>": 6,
            "<|drug|>": 7, "[EXT]": 8, "yes": 9, "no": 10,
        }

    def _word_id(self, w: str) -> int:
        if w in self._special:
            return self._special[w]
        h = 0
        for c in w:
            h = (h * 131 + ord(c)) % (2 ** 31)
        return 11 + h % (self._vocab - 11)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = [self._word_id(w) for w in text.split()]
        if add_bos:
            ids = [self.spec.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        rev = {v: k for k, v in self._special.items()}
        out = []
        for i in ids:
            i = int(i)
            if i in (self.spec.pad_id, self.spec.bos_id, self.spec.eos_id):
                continue
            out.append(rev.get(i, f"w{i}"))
        return " ".join(out)


class HFTokenizerAdapter:
    """Wraps a local transformers tokenizer, adding ProCyon special tokens in
    the reference order (model_unified.py:1111-1133)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        # reference order: protein/PROT/ANSWER/struct/drug first, EXT last
        self.tok.add_special_tokens(
            {"additional_special_tokens": SPECIAL_TOKENS})

        def tid(s):
            return self.tok.convert_tokens_to_ids(s)

        # llama-3 " yes"/" no" leading-space handling
        # (model_unified.py:342-347)
        yes_ids = self.tok.encode(" yes", add_special_tokens=False)
        no_ids = self.tok.encode(" no", add_special_tokens=False)
        self.spec = TokenizerSpec(
            vocab_size=len(self.tok), pad_id=self.tok.pad_token_id or 0,
            bos_id=self.tok.bos_token_id, eos_id=self.tok.eos_token_id,
            protein_id=tid("<|protein|>"), prot_query_id=tid("[PROT]"),
            answer_id=tid("[ANSWER]"), struct_id=tid("<|struct|>"),
            drug_id=tid("<|drug|>"), ext_id=tid("[EXT]"),
            yes_id=yes_ids[-1], no_id=no_ids[-1])

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.spec.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) != self.spec.pad_id]
        return self.tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(path: Optional[str] = None, vocab_size: int = 4096):
    if path:
        return HFTokenizerAdapter(path)
    return WordTokenizer(vocab_size)
