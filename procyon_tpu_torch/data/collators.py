"""QA / Retrieval / Caption collators -> fixed-shape model batches.

Equivalent of the reference's it_collator.py (BaseITCollator/QACollator/
RetrievalCollator/CaptionCollator, procyon/data/it_collator.py:38-2305) with
the structural change promised in SURVEY.md §7: instead of the ragged
list-of-lists batch contract (§2.2), collators emit static-shape numpy
arrays that jit directly:

  input_ids [B, L]   seg_ids [B, L]   positions [B, L]   soft_map [B, L]
  labels [B, L]      (qa / caption; -100 = unsupervised)
  protein_tokens [R, Lp] + group_ids/row_valid  (live-encoder mode)
  protein_embeds [U, De]                         (frozen-embedding mode)
  ret_pos/ret_target_pos/ret_valid [B] + conflict_mask [B, B]  (retrieval)

Prompt assembly: instruction templates from instruct.get_prompt are split on
the marker tokens; [EXT] splices description text (with the reference's
per-slot token budgeting, model_unified.py:1230-1256), <|protein|> becomes a
single soft-token position recorded in soft_map, [ANSWER] stays a real
token, `{answer}` becomes " yes"/" no" (+ eos). Labels are masked before the
last [ANSWER] (mask_before, model_unified.py:39-82).
"""

import dataclasses
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_logger = logging.getLogger("procyon_tpu_torch.collators")
_truncation_warned = set()

from procyon_tpu_torch.data.instruct import Prompt

_MARKER_RE = re.compile(
    r"(\[EXT\]|<\|protein\|>|<\|struct\|>|<\|drug\|>|\[PROT\]|\[ANSWER\]|"
    r"\[CONTEXT\]|\{answer\}|\{definition\})")


@dataclasses.dataclass
class CollatorConfig:
    max_text_len: int = 512
    max_protein_len: int = 1024
    num_examples: int = 1          # ICL examples included from the task JSON
    use_protein_tokens: bool = False  # live ESM mode vs frozen embeddings
    protein_embed_dim: int = 2560
    aaseq_type: str = "protein"
    long_protein_strategy: str = "split"
    # pad the unique-protein dim to a fixed size for stable jit shapes
    max_unique_proteins: int = 0   # 0 = batch-exact (recompiles per shape)
    max_protein_rows: int = 0
    left_pad: bool = False         # generation prompts are left-padded
    crop_texts: bool = True        # crop descriptions into the length budget
    # sample among task-definition rephrasings per batch
    # (it_collator.py:392-418); batches carry "rephrase_indicator"
    use_task_def_rephrasings: bool = False
    # sample rephrased entity descriptions (it_collator.py:420-460) with
    # this probability per instance; stores without variants fall back to
    # the canonical text
    use_entity_rephrasings: bool = False
    entity_rephrase_prob: float = 0.5
    # sample ICL demonstrations from the task's example pool per batch
    # instead of always the first N (sample_demonstrations_for_prompts,
    # instruct_constructor.py:368)
    sample_icl_examples: bool = False
    # protein structure soft tokens: each <|protein|> becomes
    # "<|protein|> <|struct|>" with prob 1-struct_dropout per instruction
    # (model_unified.py:421-460); struct embeds are per-unique-protein
    use_protein_struct: bool = False
    struct_dropout: float = 0.0
    struct_embed_dim: int = 512
    # drug soft tokens: descriptions of drug-bearing texts get
    # "\nDrug: <|drug|>" appended, drug embeds indexed by text id
    # (inference_utils.py:770-803)
    use_drug_embeddings: bool = False
    drug_embed_dim: int = 512
    max_unique_drugs: int = 0


class TextStore:
    """Minimal store interface the collators need. Implementations:
    datasets.SyntheticStore (tests), datasets.ProCyonDataStore (real data)."""

    def protein_sequence(self, idx: int) -> str:
        raise NotImplementedError

    def protein_embedding(self, idx: int) -> np.ndarray:
        raise NotImplementedError

    def text(self, idx: int) -> str:
        raise NotImplementedError

    def text_variant(self, idx: int, variant: int) -> str:
        return self.text(idx)   # stores without rephrasings


def _assemble(prompt_text: str, tokenizer, ext_texts: Sequence[str],
              answer: Optional[str], max_len: int, crop: bool,
              rng: Optional[np.random.Generator],
              context_texts: Sequence[str] = ()) -> Tuple[
                  List[int], List[int], Optional[int], Optional[int],
                  List[int]]:
    """Tokenize a template, splicing [EXT] texts and markers.

    Returns (ids, slots, prot_query_pos, answer_pos, []) where slots is a
    list of (position, kind) with kind in {"protein", "struct", "drug"} —
    soft-token positions get placeholder ids; the collator resolves each
    slot to a soft-bank row by modality.

    [EXT] description texts may themselves contain <|drug|> / <|struct|>
    markers (the reference appends "\nDrug: <|drug|>" to drug-bearing
    descriptions, inference_utils.py:770-803) — they are split and slotted
    too.
    """
    spec = tokenizer.spec
    parts = _MARKER_RE.split(prompt_text)
    ext_iter = iter(ext_texts)
    ctx_iter = iter(context_texts)

    # budget for [EXT] splices: remaining context divided by slot count
    # (model_unified.py:1230: (max_text_len - prompt_len) / num_texts)
    n_ext = prompt_text.count("[EXT]")
    fixed_len = sum(len(tokenizer.encode(p)) for p in parts
                    if not _MARKER_RE.fullmatch(p))
    budget = max((max_len - fixed_len - 8) // max(n_ext, 1), 8) if n_ext \
        else 0

    ids: List[int] = []
    slots: List[Tuple[int, str]] = []
    prot_query_pos: Optional[int] = None
    answer_positions: List[int] = []

    _SLOT_IDS = {"<|protein|>": (spec.protein_id, "protein"),
                 "<|struct|>": (spec.struct_id, "struct"),
                 "<|drug|>": (spec.drug_id, "drug")}

    def emit_text(text: str, limit: int):
        """Tokenize description text, honoring embedded soft-token
        markers; limit applies to the plain-text budget."""
        if "<|" in text:
            segs = _MARKER_RE.split(text)
        else:
            segs = [text]
        for seg in segs:
            if seg in _SLOT_IDS:
                tok, kind = _SLOT_IDS[seg]
                slots.append((len(ids), kind))
                ids.append(tok)
            elif seg:
                t_ids = tokenizer.encode(seg)
                if len(t_ids) > limit > 0:
                    if crop and rng is not None:
                        start = int(rng.integers(0,
                                                 len(t_ids) - limit + 1))
                        t_ids = t_ids[start:start + limit]
                    else:
                        t_ids = t_ids[:limit]
                ids.extend(t_ids)

    for part in parts:
        if part == "[EXT]":
            emit_text(next(ext_iter, ""), budget)
        elif part in _SLOT_IDS:
            tok, kind = _SLOT_IDS[part]
            slots.append((len(ids), kind))
            ids.append(tok)
        elif part == "[PROT]":
            prot_query_pos = len(ids)
            ids.append(spec.prot_query_id)
        elif part == "[ANSWER]":
            answer_positions.append(len(ids))
            ids.append(spec.answer_id)
        elif part == "[CONTEXT]":
            ctx = next(ctx_iter, "")
            if ctx:
                ids.extend(tokenizer.encode(ctx))
        elif part == "{answer}":
            if answer is not None:
                a_ids = tokenizer.encode(answer)
                ids.extend(a_ids)
                ids.append(spec.eos_id)
        elif part == "{definition}":
            continue
        else:
            ids.extend(tokenizer.encode(part))

    answer_pos = answer_positions[-1] if answer_positions else None
    return ids, slots, prot_query_pos, answer_pos, []


def _pad_batch(rows: List[Dict], max_len: int, left_pad: bool,
               bank_offsets=(0, 0, 0)):
    """rows[b]["soft"] entries are (pos, bank, idx) with bank 0=protein,
    1=struct, 2=drug; bank_offsets maps each bank into the concatenated
    soft-bank layout [proteins | structs | drugs]
    (models/unified.build_soft_bank)."""
    B = len(rows)
    L = max_len
    input_ids = np.zeros((B, L), np.int32)
    seg_ids = np.zeros((B, L), np.int32)
    positions = np.zeros((B, L), np.int32)
    soft_map = np.full((B, L), -1, np.int32)
    labels = np.full((B, L), -100, np.int32)
    extra = {"ret_pos": np.zeros((B,), np.int32),
             "answer_pos": np.zeros((B,), np.int32)}
    for b, row in enumerate(rows):
        ids = row["ids"][:L]
        n = len(ids)
        # a truncated answer/[PROT] position silently removes supervision —
        # warn once per (surplus bucket) so misconfigured max_text_len is
        # visible (the reference crops descriptions into the budget instead)
        for key in ("answer_pos", "ret_pos"):
            p = row.get(key)
            if p is not None and p >= L:
                bucket = (key, len(row["ids"]) // 64)
                if bucket not in _truncation_warned:
                    _truncation_warned.add(bucket)
                    _logger.warning(
                        "%s at token %d exceeds max_text_len=%d — "
                        "supervision truncated; raise max_text_len or "
                        "reduce num_examples", key, p, L)
        off = L - n if left_pad else 0
        input_ids[b, off:off + n] = ids
        seg_ids[b, off:off + n] = 1
        positions[b, off:off + n] = np.arange(n)
        for entry in row.get("soft", []):
            pos, bank, idx = entry
            if pos < L:
                soft_map[b, off + pos] = bank_offsets[bank] + idx
        if row.get("labels") is not None:
            lab = row["labels"][:L]
            labels[b, off:off + len(lab)] = lab
        if row.get("ret_pos") is not None and row["ret_pos"] < L:
            extra["ret_pos"][b] = off + row["ret_pos"]
        if row.get("answer_pos") is not None and row["answer_pos"] < L:
            extra["answer_pos"][b] = off + row["answer_pos"]
    return {"input_ids": input_ids, "seg_ids": seg_ids,
            "positions": positions, "soft_map": soft_map,
            "labels": labels, **extra}


CONFLICT_ID_STRIDE = 1_000_000_000_000  # int64 holds ~9.2e18: ds_id<9.2e6


def encode_conflict_ids(ds_id: int, local_ids: Sequence[int]) -> np.ndarray:
    """Dataset-tagged ids for the in-graph global conflict mask
    (compute_conflict_matrix semantics, model_utils.py:135-150). The
    stride must exceed every local text/aaseq id or ids from different
    datasets alias and wrongly mask negatives — assert the bound."""
    ids = np.asarray(list(local_ids), np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= CONFLICT_ID_STRIDE):
        raise ValueError(
            f"conflict id out of range [0, {CONFLICT_ID_STRIDE}): "
            f"min={ids.min()} max={ids.max()} (dataset id {ds_id})")
    return ds_id * CONFLICT_ID_STRIDE + ids


class _UniqueProteins:
    """Dedup proteins across a batch; rows of the soft bank."""

    def __init__(self):
        self.order: List[int] = []
        self.index: Dict[int, int] = {}

    def add(self, aaseq_idx: int) -> int:
        if aaseq_idx not in self.index:
            self.index[aaseq_idx] = len(self.order)
            self.order.append(aaseq_idx)
        return self.index[aaseq_idx]


class BaseCollator:
    def __init__(self, cfg: CollatorConfig, tokenizer, store: TextStore,
                 task: Dict, *, seed: int = 0, context_provider=None,
                 text_type: str = ""):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.store = store
        self.task = task
        self.rng = np.random.default_rng(seed)
        self.context_provider = context_provider
        self.text_type = text_type or task.get("DATASET_IDENTIFIER", "")

    def _instance_text(self, text_idx: int) -> str:
        """Canonical or rephrased description for an instance (entity
        rephrasings, it_collator.py:420-460)."""
        if (self.cfg.use_entity_rephrasings
                and self.rng.random() < self.cfg.entity_rephrase_prob
                and hasattr(self.store, "text_variant")):
            return self.store.text_variant(
                text_idx, int(self.rng.integers(0, 6)))
        return self.store.text(text_idx)

    def _contexts(self, prompt, query_text_idx) -> list:
        """[CONTEXT] strings in marker order: ICL examples then the
        instance (it_collator.py context augmentation)."""
        if self.context_provider is None:
            return []
        out = [self.context_provider.context(self.text_type, t)
               for t in prompt.example_text_ids]
        out.append(self.context_provider.context(self.text_type,
                                                 query_text_idx))
        return out

    def _protein_arrays(self, unique: _UniqueProteins) -> Dict:
        cfg = self.cfg
        idxs = unique.order or [0]
        if cfg.use_protein_tokens:
            from procyon_tpu_torch.data import protein_tokenizer

            seqs = [self.store.protein_sequence(i) for i in idxs]
            pb = protein_tokenizer.batch_encode(
                seqs, max_len=cfg.max_protein_len,
                long_strategy=cfg.long_protein_strategy,
                pad_rows_to=cfg.max_protein_rows)
            return {"protein_tokens": pb.tokens,
                    "protein_group_ids": pb.group_ids,
                    "protein_row_valid": pb.row_valid,
                    "num_proteins": pb.num_groups}
        embeds = np.stack([self.store.protein_embedding(i) for i in idxs])
        if cfg.max_unique_proteins and len(idxs) < cfg.max_unique_proteins:
            pad = np.zeros((cfg.max_unique_proteins - len(idxs),
                            embeds.shape[1]), embeds.dtype)
            embeds = np.concatenate([embeds, pad], 0)
        return {"protein_embeds": embeds}

    # ---- struct / drug soft-token modalities ---------------------------

    def _n_protein_rows(self, parrays: Dict) -> int:
        if "protein_embeds" in parrays:
            return parrays["protein_embeds"].shape[0]
        return parrays["protein_tokens"].shape[0]

    def _modality_arrays(self, parrays: Dict, unique: _UniqueProteins,
                         unique_drugs: Optional[_UniqueProteins]) -> Tuple[
                             Dict, Tuple[int, int, int]]:
        """struct/drug embedding banks + soft_map bank offsets for the
        [proteins | structs | drugs] layout (build_soft_bank)."""
        cfg = self.cfg
        n_prot = self._n_protein_rows(parrays)
        out = {}
        off_struct = 0
        off_drug = n_prot
        if cfg.use_protein_struct:
            se = np.zeros((n_prot, cfg.struct_embed_dim), np.float32)
            for row, aaseq_idx in enumerate(unique.order):
                emb = self._struct_embedding(aaseq_idx)
                if emb is not None:
                    se[row] = emb
            out["struct_embeds"] = se
            off_struct = n_prot
            off_drug = 2 * n_prot
        want_drugs = unique_drugs is not None and (
            unique_drugs.order or (cfg.use_drug_embeddings and
                                   cfg.max_unique_drugs))
        if want_drugs:
            if unique_drugs.order:
                de = np.stack([self._drug_embedding(d)
                               for d in unique_drugs.order])
            else:
                de = np.zeros((0, cfg.drug_embed_dim), np.float32)
            if cfg.max_unique_drugs and de.shape[0] < cfg.max_unique_drugs:
                pad = np.zeros((cfg.max_unique_drugs - de.shape[0],
                                de.shape[1]), de.dtype)
                de = np.concatenate([de, pad], 0)
            out["drug_embeds"] = de
        return out, (0, off_struct, off_drug)

    def _struct_embedding(self, aaseq_idx: int):
        fn = getattr(self.store, "struct_embedding", None)
        return fn(aaseq_idx) if fn is not None else None

    def _drug_embedding(self, drug_idx: int):
        return self.store.drug_embedding(drug_idx)

    def _has_drug(self, text_idx: int) -> bool:
        if not self.cfg.use_drug_embeddings:
            return False
        fn = getattr(self.store, "has_drug", None)
        if fn is not None:
            return bool(fn(text_idx))
        return hasattr(self.store, "drug_embedding")

    def _struct_prompt(self, prompt_text: str) -> str:
        """With prob 1-struct_dropout, every <|protein|> slot gains a
        trailing <|struct|> token (model_unified.py:421-437)."""
        if self.cfg.use_protein_struct and \
                self.rng.random() >= self.cfg.struct_dropout:
            return prompt_text.replace("<|protein|>",
                                       "<|protein|> <|struct|>")
        return prompt_text

    def _with_drug_marker(self, text: str, text_idx: int,
                          drug_slot_ids: List[int]) -> str:
        """Drug-bearing descriptions get "\\nDrug: <|drug|>" appended and
        the drug id recorded in slot order (inference_utils.py:770-803;
        drug id == the drugbank text id)."""
        if self._has_drug(text_idx):
            drug_slot_ids.append(text_idx)
            return text + "\nDrug: <|drug|>"
        return text

    def _resolve_slots(self, slots, aaseq_slot_ids: Sequence[int],
                       drug_slot_ids: Sequence[int],
                       unique: _UniqueProteins,
                       unique_drugs: _UniqueProteins) -> List[Tuple]:
        """Typed slots -> (pos, bank, idx) rows. Struct slots bind to the
        most recent protein slot's bank row (the reference injects
        "<|protein|> <|struct|>" pairs and indexes struct embeds by the
        same unique aaseq, model_unified.py:440-460)."""
        soft = []
        ai = iter(aaseq_slot_ids)
        di = iter(drug_slot_ids)
        last_prot = None
        for pos, kind in slots:
            if kind == "protein":
                nxt = next(ai, None)
                if nxt is None:
                    continue
                last_prot = unique.add(nxt)
                soft.append((pos, 0, last_prot))
            elif kind == "struct":
                if last_prot is not None:
                    soft.append((pos, 1, last_prot))
            else:
                d = next(di, None)
                if d is not None:
                    soft.append((pos, 2, unique_drugs.add(d)))
        return soft

    def _prompt_exts(self, prompt: Prompt, query_text: Optional[str]):
        """ICL example description texts + the query description."""
        texts = [self.store.text(t) for t in prompt.example_text_ids]
        if query_text is not None:
            texts.append(query_text)
        return texts


class QACollator(BaseCollator):
    """Yes/no instruction batches (QACollator, it_collator.py:942-1500).

    samples: list of (aaseq_idx, text_idx, is_positive).
    """

    def __call__(self, samples, prompt: Prompt) -> Dict:
        spec = self.tokenizer.spec
        unique = _UniqueProteins()
        unique_drugs = _UniqueProteins()
        rows = []
        yes_no = []
        for aaseq_idx, text_idx, positive in samples:
            answer = " yes" if positive else " no"
            drug_ids: List[int] = []
            icl = [self._with_drug_marker(self.store.text(t), t, drug_ids)
                   for t in prompt.example_text_ids]
            exts = icl + [self._with_drug_marker(
                self._instance_text(text_idx), text_idx, drug_ids)]
            ids, slots, _, ans_pos, _ = _assemble(
                self._struct_prompt(prompt.text), self.tokenizer, exts,
                answer, self.cfg.max_text_len, self.cfg.crop_texts,
                self.rng, context_texts=self._contexts(prompt, text_idx))
            # ICL example proteins then the query protein, in slot order
            slot_aaseqs = list(prompt.example_aaseq_ids) + [aaseq_idx]
            soft = self._resolve_slots(slots, slot_aaseqs, drug_ids,
                                       unique, unique_drugs)
            labels = np.full((len(ids),), -100, np.int32)
            if ans_pos is not None:
                labels[ans_pos + 1:] = ids[ans_pos + 1:]
            rows.append({"ids": ids, "soft": soft, "labels": labels,
                         "answer_pos": ans_pos})
            yes_no.append(1 if positive else 0)
        parrays = self._protein_arrays(unique)
        marrays, offsets = self._modality_arrays(parrays, unique,
                                                 unique_drugs)
        batch = _pad_batch(rows, self.cfg.max_text_len, self.cfg.left_pad,
                           offsets)
        batch.update(parrays)
        batch.update(marrays)
        batch["qa_labels"] = np.asarray(yes_no, np.int32)
        # 0-d arrays (np.isscalar(np.int32(x)) is True!) so they survive
        # scalar-filtering in host->device batch conversion
        batch["yes_token"] = np.asarray(spec.yes_id, np.int32)
        batch["no_token"] = np.asarray(spec.no_id, np.int32)
        return batch


class RetrievalCollator(BaseCollator):
    """Contrastive retrieval batches (RetrievalCollator,
    it_collator.py:1504-1924).

    samples: list of (positive_aaseq_idx, text_idx) — in-batch negatives;
    conflict mask kills colliding negatives (same text id or known positive
    pair; model_unified.py:615-693 semantics via model_utils.py:135-150).
    """

    def __init__(self, *args, known_positive_pairs=None, **kw):
        super().__init__(*args, **kw)
        self.known_pairs = known_positive_pairs or set()

    def __call__(self, samples, prompt: Prompt,
                 negatives: Optional[Sequence[Sequence[int]]] = None
                 ) -> Dict:
        """negatives: optional per-sample preset negative protein indices
        (the reference's PresetNegativeSampler / with_N_negatives path,
        dataset.py:844-956); when given, the model scores against them
        instead of in-batch negatives."""
        unique = _UniqueProteins()
        unique_drugs = _UniqueProteins()
        rows = []
        target_pos = []
        text_ids = []
        aaseq_ids = []
        neg_pos = [] if negatives is not None else None
        for si, (aaseq_idx, text_idx) in enumerate(samples):
            drug_ids: List[int] = []
            icl = [self._with_drug_marker(self.store.text(t), t, drug_ids)
                   for t in prompt.example_text_ids]
            exts = icl + [self._with_drug_marker(
                self._instance_text(text_idx), text_idx, drug_ids)]
            # no struct injection: the reference skips struct tokens for
            # retrieval during training (model_unified.py:511-512)
            ids, slots, prot_query, _, _ = _assemble(
                prompt.text, self.tokenizer, exts, None,
                self.cfg.max_text_len, self.cfg.crop_texts, self.rng,
                context_texts=self._contexts(prompt, text_idx))
            soft = self._resolve_slots(slots, prompt.example_aaseq_ids,
                                       drug_ids, unique, unique_drugs)
            rows.append({"ids": ids, "soft": soft, "labels": None,
                         "ret_pos": prot_query})
            target_pos.append(unique.add(aaseq_idx))
            text_ids.append(text_idx)
            aaseq_ids.append(aaseq_idx)
            if neg_pos is not None:
                neg_pos.append([unique.add(n) for n in negatives[si]])
        parrays = self._protein_arrays(unique)
        marrays, offsets = self._modality_arrays(parrays, unique,
                                                 unique_drugs)
        batch = _pad_batch(rows, self.cfg.max_text_len, self.cfg.left_pad,
                           offsets)
        del batch["labels"]
        batch.update(parrays)
        batch.update(marrays)
        B = len(samples)
        batch["ret_target_pos"] = np.asarray(target_pos, np.int32)
        batch["ret_valid"] = np.ones((B,), bool)
        # conflict mask [B, B]: 0 where a column is a known positive of the
        # row's query (other than the diagonal positive itself)
        mask = np.ones((B, B), np.float32)
        for i in range(B):
            for j in range(B):
                if i == j:
                    continue
                if text_ids[i] == text_ids[j] or \
                        (aaseq_ids[j], text_ids[i]) in self.known_pairs:
                    mask[i, j] = 0.0
        batch["conflict_mask"] = mask
        # dataset-tagged text ids for the in-graph global mask under
        # explicit collectives (compute_conflict_matrix semantics,
        # model_utils.py:135-150; DATASET_ID offsets keep ids unique
        # across datasets)
        from procyon_tpu_torch.data import registry

        ds_id = max(registry.dataset_id(self.text_type), 0)
        batch["conflict_ids"] = encode_conflict_ids(ds_id, text_ids)
        if neg_pos is not None:
            batch["ret_negative_pos"] = np.asarray(neg_pos, np.int32)
        batch["reference_indices"] = {"text": text_ids, "aaseq": aaseq_ids}
        return batch


class CaptionCollator(BaseCollator):
    """Free-text phenotype generation batches (CaptionCollator,
    it_collator.py:1929-2305). samples: list of (aaseq_idx, text_idx)."""

    def __call__(self, samples, prompt: Prompt, *, for_generation=False
                 ) -> Dict:
        spec = self.tokenizer.spec
        unique = _UniqueProteins()
        unique_drugs = _UniqueProteins()
        rows = []
        # the final [EXT] in a caption template is the target text; split
        # the template at "Output: [ANSWER] [EXT]" tail
        for aaseq_idx, text_idx in samples:
            caption = self._instance_text(text_idx)
            # ICL exts fill earlier [EXT]s; the last is the caption target.
            # drug markers only on ICL descriptions — the generated caption
            # must stay pure text
            drug_ids: List[int] = []
            icl_exts = [self._with_drug_marker(self.store.text(t), t,
                                               drug_ids)
                        for t in prompt.example_text_ids]
            exts = icl_exts + ([""] if for_generation else [caption])
            ids, slots, _, ans_pos, _ = _assemble(
                self._struct_prompt(prompt.text), self.tokenizer, exts,
                None, self.cfg.max_text_len, self.cfg.crop_texts, self.rng,
                context_texts=self._contexts(prompt, text_idx))
            if not for_generation:
                ids = ids + [spec.eos_id]
            slot_aaseqs = list(prompt.example_aaseq_ids) + [aaseq_idx]
            soft = self._resolve_slots(slots, slot_aaseqs, drug_ids,
                                       unique, unique_drugs)
            labels = None
            if not for_generation and ans_pos is not None:
                labels = np.full((len(ids),), -100, np.int32)
                labels[ans_pos + 1:] = ids[ans_pos + 1:]
            rows.append({"ids": ids, "soft": soft, "labels": labels,
                         "answer_pos": ans_pos})
        left_pad = self.cfg.left_pad or for_generation
        parrays = self._protein_arrays(unique)
        marrays, offsets = self._modality_arrays(parrays, unique,
                                                 unique_drugs)
        batch = _pad_batch(rows, self.cfg.max_text_len, left_pad, offsets)
        batch.update(parrays)
        batch.update(marrays)
        if for_generation:
            del batch["labels"]
        batch["reference_indices"] = {
            "aaseq": [s[0] for s in samples],
            "text": [s[1] for s in samples]}
        return batch


class PPIQACollator(BaseCollator):
    """Protein-protein interaction yes/no batches (is_ppi QA prompts,
    instruct_constructor compose_qa_examples PPI branch).

    samples: list of (aaseq_idx_1, aaseq_idx_2, is_positive).
    """

    def __call__(self, samples, prompt: Prompt) -> Dict:
        unique = _UniqueProteins()
        rows = []
        yes_no = []
        for a1, a2, positive in samples:
            answer = " yes" if positive else " no"
            ids, slots, _, ans_pos, _ = _assemble(
                self._struct_prompt(prompt.text), self.tokenizer, [],
                answer, self.cfg.max_text_len, self.cfg.crop_texts,
                self.rng)
            slot_aaseqs = list(prompt.example_aaseq_ids) + [a1, a2]
            soft = self._resolve_slots(slots, slot_aaseqs, [], unique,
                                       _UniqueProteins())
            labels = np.full((len(ids),), -100, np.int32)
            if ans_pos is not None:
                labels[ans_pos + 1:] = ids[ans_pos + 1:]
            rows.append({"ids": ids, "soft": soft, "labels": labels,
                         "answer_pos": ans_pos})
            yes_no.append(1 if positive else 0)
        parrays = self._protein_arrays(unique)
        marrays, offsets = self._modality_arrays(parrays, unique, None)
        batch = _pad_batch(rows, self.cfg.max_text_len, self.cfg.left_pad,
                           offsets)
        batch.update(parrays)
        batch.update(marrays)
        batch["qa_labels"] = np.asarray(yes_no, np.int32)
        return batch


class PPIRetrievalCollator(BaseCollator):
    """PPI retrieval: query protein 1 in the prompt, [PROT] retrieves
    protein 2. samples: list of (aaseq_idx_1, aaseq_idx_2)."""

    def __call__(self, samples, prompt: Prompt) -> Dict:
        unique = _UniqueProteins()
        rows = []
        target_pos = []
        pair_ids = []
        for a1, a2 in samples:
            ids, slots, prot_query, _, _ = _assemble(
                prompt.text, self.tokenizer, [], None,
                self.cfg.max_text_len, self.cfg.crop_texts, self.rng)
            slot_aaseqs = list(prompt.example_aaseq_ids) + [a1]
            soft = self._resolve_slots(slots, slot_aaseqs, [], unique,
                                       _UniqueProteins())
            rows.append({"ids": ids, "soft": soft, "labels": None,
                         "ret_pos": prot_query})
            target_pos.append(unique.add(a2))
            pair_ids.append((a1, a2))
        parrays = self._protein_arrays(unique)
        marrays, offsets = self._modality_arrays(parrays, unique, None)
        batch = _pad_batch(rows, self.cfg.max_text_len, self.cfg.left_pad,
                           offsets)
        del batch["labels"]
        batch.update(parrays)
        batch.update(marrays)
        B = len(samples)
        batch["ret_target_pos"] = np.asarray(target_pos, np.int32)
        batch["ret_valid"] = np.ones((B,), bool)
        mask = np.ones((B, B), np.float32)
        known = {p for p in pair_ids} | {(b, a) for a, b in pair_ids}
        for i in range(B):
            for j in range(B):
                if i != j and (pair_ids[i][0], pair_ids[j][1]) in known:
                    mask[i, j] = 0.0
        batch["conflict_mask"] = mask
        from procyon_tpu_torch.data import registry

        ds_id = max(registry.dataset_id(self.text_type or "string"), 0)
        batch["conflict_ids"] = encode_conflict_ids(
            ds_id, [a2 for _, a2 in pair_ids])
        batch["reference_indices"] = {"pairs": pair_ids}
        return batch
