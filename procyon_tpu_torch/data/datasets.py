"""Relation datasets + data stores + negative samplers.

Equivalent of procyon/data/dataset.py:
  * AASeqTextRelationDataset  <- AASeqTextUnifiedDataset (:986-1283): loads
    `{aaseq}_{text}_relations_indexed.unified.csv` under the split-method
    dir, filters relation + split, yields (aaseq_idx, rel_idx, text_idx)
    with sampled negatives.
  * AASeqPairDataset          <- AASeqDataset (:1284-...): undirected PPI
    pairs with swap_prob.
  * Negative samplers (:844-956): Null / Repeat / Preset / SimBased.

Stores give the collators sequence/text/embedding lookups:
  * ProCyonDataStore — reads the reference's DATA_DIR layout
    (integrated_data/v1/..., FASTA, precomputed embedding .pt/.pkl —
    data_utils.py:19-399). torch is used only to unpickle .pt files.
  * SyntheticStore — deterministic fake data for tests/benches.
"""

import dataclasses
import os
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------


class SyntheticStore:
    """Deterministic synthetic proteins/texts/embeddings (test fixture à la
    DummyAASeqTextDataset, evaluate/framework/testing.py:223-263)."""

    AA = "LAGVSERTIDPKQNFYMHWC"

    def __init__(self, n_proteins=64, n_texts=64, embed_dim=64, seed=0,
                 min_len=20, max_len=60, struct_dim=16, drug_dim=16):
        self.n_proteins = n_proteins
        self.n_texts = n_texts
        self.embed_dim = embed_dim
        self.struct_dim = struct_dim
        self.drug_dim = drug_dim
        rng = np.random.default_rng(seed)
        self._lens = rng.integers(min_len, max_len, n_proteins)
        self._embeds = rng.standard_normal(
            (n_proteins, embed_dim)).astype(np.float32)
        self._seeds = rng.integers(0, 2 ** 31, n_proteins)

    def protein_sequence(self, idx: int) -> str:
        rng = np.random.default_rng(int(self._seeds[idx % self.n_proteins]))
        n = int(self._lens[idx % self.n_proteins])
        return "".join(rng.choice(list(self.AA), n))

    def protein_embedding(self, idx: int) -> np.ndarray:
        return self._embeds[idx % self.n_proteins]

    def text(self, idx: int) -> str:
        idx = idx % self.n_texts
        return (f"synthetic phenotype description number {idx} involving "
                f"pathway p{idx % 7} and function f{idx % 11}")

    def text_variant(self, idx: int, variant: int) -> str:
        """Deterministic alternative wordings of text(idx) (entity
        rephrasings, it_collator.py:420-460)."""
        idx = idx % self.n_texts
        forms = [
            (f"phenotype {idx}, linked to pathway p{idx % 7} and "
             f"function f{idx % 11} (synthetic rephrasing)"),
            (f"a synthetic trait record ({idx}) tied to p{idx % 7} "
             f"signalling and the f{idx % 11} activity"),
            (f"record {idx}: pathway p{idx % 7}; function f{idx % 11}"),
        ]
        return forms[variant % len(forms)]

    # struct/drug modality fixtures (gearnet & drug-structure analogues,
    # model_unified.py:269-297)
    def struct_embedding(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(7_000_003 + idx % self.n_proteins)
        return rng.standard_normal(self.struct_dim).astype(np.float32)

    def drug_embedding(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(9_000_017 + idx % self.n_texts)
        return rng.standard_normal(self.drug_dim).astype(np.float32)

    def has_drug(self, text_idx: int) -> bool:
        # every other text id carries a drug record (DRUGMASK analogue,
        # inference_utils.py:770-781)
        return text_idx % 2 == 0


class ProCyonDataStore:
    """Reads the ProCyon-Instruct DATA_DIR layout (README.md:39-59).

    Lazy: nothing is touched until first access, so the store can be
    constructed in environments without the dataset.
    """

    def __init__(self, data_dir: Optional[str] = None,
                 aaseq_type: str = "protein",
                 embedding_file: Optional[str] = None):
        self.data_dir = data_dir or os.environ.get("DATA_DIR", "")
        self.aaseq_type = aaseq_type
        self.embedding_file = embedding_file
        self._seqs = None
        self._texts: Dict[str, "object"] = {}
        self._embeds = None
        self._embed_map = None

    # -- sequences (integrated_data/v1/{type}/{type}_sequences.fa) via the
    # native FASTA offset index (no full-file load for 57k-protein stores)
    def _load_sequences(self):
        if self._seqs is not None:
            return
        from procyon_tpu_torch.native import FastaIndex

        fa = os.path.join(self.data_dir, "integrated_data", "v1",
                          self.aaseq_type,
                          f"{self.aaseq_type}_sequences.fa")
        self._seqs = FastaIndex(fa)

    def protein_sequence(self, idx: int) -> str:
        self._load_sequences()
        return self._seqs.get(idx)

    # -- precomputed embeddings (data_utils.py:365-388)
    def _load_embeddings(self):
        if self._embeds is not None:
            return
        import pickle

        path = self.embedding_file or os.path.join(
            self.data_dir, "generated_data", "aaseq_embeddings",
            f"{self.aaseq_type}_esm2-3b_mean.pt")
        if path.endswith(".pt"):
            import torch

            self._embeds = torch.load(path, map_location="cpu").numpy()
        else:
            self._embeds = np.load(path)
        map_path = os.path.splitext(path)[0] + "_idmap.pkl"
        if os.path.exists(map_path):
            with open(map_path, "rb") as f:
                self._embed_map = pickle.load(f)

    def protein_embedding(self, idx: int) -> np.ndarray:
        self._load_embeddings()
        row = self._embed_map[idx] if self._embed_map is not None else idx
        return np.asarray(self._embeds[row], np.float32)

    # -- texts: per-dataset info csv (data_utils.py:143-353)
    def load_text_table(self, text_type: str, columns: Sequence[str]):
        import pandas as pd

        if text_type not in self._texts:
            path = os.path.join(
                self.data_dir, "integrated_data", "v1", text_type,
                f"{text_type}_info_filtered_composed.pkl")
            if not os.path.exists(path):
                path = os.path.join(
                    self.data_dir, "integrated_data", "v1", text_type,
                    f"{text_type}_info_filtered.pkl")
            self._texts[text_type] = pd.read_pickle(path)
        df = self._texts[text_type]
        cols = [c for c in columns if c in df.columns]
        return df, cols

    def text(self, idx: int) -> str:
        # single-dataset adapter: bind via TextTableStore below
        raise NotImplementedError(
            "wrap ProCyonDataStore in TextTableStore(text_type, columns)")

    # -- auxiliary embedding tables (data_utils.py:389-412) ---------------
    @staticmethod
    def _load_tensor_file(path):
        if path.endswith(".pt"):
            import torch

            t = torch.load(path, map_location="cpu")
            return t.float().numpy() if hasattr(t, "numpy") else np.asarray(t)
        return np.load(path)

    def protein_struct_embeddings(self, path: Optional[str] = None):
        """Structure-model protein embeddings
        (data_utils.py:389-393 load_protein_struct_embeddings)."""
        path = path or os.path.join(self.data_dir, "generated_data",
                                    "aaseq_embeddings",
                                    f"{self.aaseq_type}_struct.pt")
        return self._load_tensor_file(path)

    def drug_structure_embeddings(self, path: Optional[str] = None):
        """Drug structure embeddings for the <|drug|> soft-token bank
        (data_utils.py:395-399 load_drug_structure_embeddings)."""
        path = path or os.path.join(self.data_dir, "generated_data",
                                    "drug_embeddings", "drug_struct.pt")
        return self._load_tensor_file(path)

    def text_embeddings(self, path: str, text_type: str):
        """Precomputed text embeddings, length-checked against the text
        info table (data_utils.py:401-412 load_text_embeddings)."""
        emb = self._load_tensor_file(path)
        df, _ = self.load_text_table(text_type, [])
        assert len(df) == len(emb), (len(df), len(emb))
        return emb

    # -- per-index struct/drug accessors for the collator soft banks
    # (model_unified.py:269-297 frozen nn.Embedding tables)
    def struct_embedding(self, idx: int,
                         path: Optional[str] = None) -> Optional[np.ndarray]:
        if not hasattr(self, "_struct_table"):
            try:
                self._struct_table = self.protein_struct_embeddings(path)
            except (FileNotFoundError, OSError):
                self._struct_table = None
        if self._struct_table is None or idx >= len(self._struct_table):
            return None
        return np.asarray(self._struct_table[idx], np.float32)

    def drug_embedding(self, idx: int,
                       path: Optional[str] = None) -> np.ndarray:
        if not hasattr(self, "_drug_table"):
            self._drug_table = self.drug_structure_embeddings(path)
        return np.asarray(self._drug_table[idx], np.float32)

    def has_drug(self, text_idx: int) -> bool:
        """DRUGMASK analogue (inference_utils.py:770-781): a text id has a
        drug record when the drug table has a finite, non-zero row."""
        if not hasattr(self, "_drug_table"):
            try:
                self._drug_table = self.drug_structure_embeddings()
            except (FileNotFoundError, OSError):
                self._drug_table = None
        if self._drug_table is None or text_idx >= len(self._drug_table):
            return False
        row = self._drug_table[text_idx]
        return bool(np.isfinite(row).all() and np.abs(row).sum() > 0)


class TextTableStore:
    """Binds a ProCyonDataStore to one text dataset + composed columns."""

    def __init__(self, base: ProCyonDataStore, text_type: str,
                 columns: Sequence[str],
                 rephrase_suffixes: Sequence[str] = (
                     "junior_rephrasing", "mid_rephrasing",
                     "senior_rephrasing", "junior_summarisation",
                     "mid_summarisation", "senior_summarisation")):
        self.base = base
        self.text_type = text_type
        self.columns = columns
        # entity-rephrasing columns, "{col}_{expertise}_{level}" layout
        # (constants.py EXPERTISE_LEVEL x REPHRASE_ENTITY_LEVEL)
        self.rephrase_suffixes = list(rephrase_suffixes)

    def protein_sequence(self, idx):
        return self.base.protein_sequence(idx)

    def protein_embedding(self, idx):
        return self.base.protein_embedding(idx)

    def struct_embedding(self, idx):
        return self.base.struct_embedding(idx)

    def drug_embedding(self, idx):
        return self.base.drug_embedding(idx)

    def has_drug(self, text_idx):
        return self.base.has_drug(text_idx)

    def text(self, idx: int) -> str:
        df, cols = self.base.load_text_table(self.text_type, self.columns)
        row = df.iloc[idx]
        parts = [str(row[c]) for c in cols if str(row[c]) != "nan"]
        return " ".join(parts)

    def text_variant(self, idx: int, variant: int) -> str:
        """Rephrased composed description: each base column is replaced by
        its "{col}_{suffix}" rephrasing column when the table provides one
        (reference stores *_filtered_rephrased.pkl tables with
        expertise x level column variants); falls back to the canonical
        column otherwise."""
        df, cols = self.base.load_text_table(self.text_type, self.columns)
        suffix = self.rephrase_suffixes[variant % len(self.rephrase_suffixes)]
        row = df.iloc[idx]
        parts = []
        for c in cols:
            rc = f"{c}_{suffix}"
            v = row[rc] if rc in df.columns else row[c]
            if str(v) != "nan":
                parts.append(str(v))
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Negative samplers (dataset.py:844-956)
# ---------------------------------------------------------------------------


def negative_sampling_random_tail(pos_idx: int, num_entities: int,
                                  num_negs: int, true_set: Set[int],
                                  rng: np.random.Generator,
                                  probs: Optional[np.ndarray] = None,
                                  mask: Optional[np.ndarray] = None
                                  ) -> np.ndarray:
    """Masked categorical sampling without replacement avoiding known
    positives (procyon/data/sampling.py:4-41). probs weights candidates
    (e.g. a similarity-matrix row for hard negatives); mask restricts the
    candidate set (e.g. GO namespace masks)."""
    p = (np.ones(num_entities) if probs is None
         else np.asarray(probs, np.float64).copy())
    if mask is not None:
        p = p * np.asarray(mask, np.float64)
    p[list(true_set & set(range(num_entities)))] = 0.0
    p[pos_idx] = 0.0
    p = np.maximum(p, 0.0)
    total = p.sum()
    if total <= 0:
        return rng.integers(0, num_entities, num_negs)
    p /= total
    return rng.choice(num_entities, size=min(num_negs, int((p > 0).sum())),
                      replace=False, p=p)


class NullNegativeSampler:
    def sample(self, aaseq_idx, text_idx, rng):
        return [], []


class RandomNegativeSampler:
    """Uniform negatives avoiding true relations (SimBased without the
    similarity weighting)."""

    def __init__(self, n_proteins, n_texts, true_pairs: Set[Tuple[int, int]],
                 num_neg_protein=1, num_neg_text=0):
        self.n_proteins = n_proteins
        self.n_texts = n_texts
        self.num_neg_protein = num_neg_protein
        self.num_neg_text = num_neg_text
        self._true_by_text: Dict[int, Set[int]] = {}
        self._true_by_protein: Dict[int, Set[int]] = {}
        for a, t in true_pairs:
            self._true_by_text.setdefault(t, set()).add(a)
            self._true_by_protein.setdefault(a, set()).add(t)

    def sample(self, aaseq_idx, text_idx, rng):
        negs_a = negative_sampling_random_tail(
            aaseq_idx, self.n_proteins, self.num_neg_protein,
            self._true_by_text.get(text_idx, set()), rng) \
            if self.num_neg_protein else []
        negs_t = negative_sampling_random_tail(
            text_idx, self.n_texts, self.num_neg_text,
            self._true_by_protein.get(aaseq_idx, set()), rng) \
            if self.num_neg_text else []
        return list(negs_a), list(negs_t)


class SimNegativeSampler(RandomNegativeSampler):
    """Similarity-weighted hard negatives (dataset.py:204-310
    negative_sampling_probs): candidate weight = sims row of the positive,
    optionally gated by a namespace/validity mask row. Similarity matrices
    follow the reference layout (generated_data/negative_sampling_probs/
    {protein|go}_sims_{type}.npy, memmap-friendly); pass arrays directly
    for synthetic/in-memory use."""

    def __init__(self, n_proteins, n_texts, true_pairs,
                 num_neg_protein=1, num_neg_text=0,
                 protein_sims: Optional[np.ndarray] = None,
                 text_sims: Optional[np.ndarray] = None,
                 protein_mask: Optional[np.ndarray] = None,
                 text_mask: Optional[np.ndarray] = None):
        super().__init__(n_proteins, n_texts, true_pairs,
                         num_neg_protein, num_neg_text)
        self.protein_sims = protein_sims
        self.text_sims = text_sims
        self.protein_mask = protein_mask
        self.text_mask = text_mask

    @classmethod
    def from_data_dir(cls, data_dir, kind, sims_type, **kw):
        """Load reference-layout sims/mask .npy files (mmap) for
        kind in {"protein", "go"}."""
        probs_path = os.path.join(
            data_dir, "generated_data", "negative_sampling_probs",
            f"{kind}_sims_{sims_type}.npy")
        mask_path = os.path.join(
            data_dir, "generated_data", "negative_sampling_masks",
            f"{kind}_generic_masks.npy")
        sims = np.load(probs_path, mmap_mode="r") \
            if os.path.exists(probs_path) else None
        mask = np.load(mask_path, mmap_mode="r") \
            if os.path.exists(mask_path) else None
        key = "protein_sims" if kind == "protein" else "text_sims"
        mkey = "protein_mask" if kind == "protein" else "text_mask"
        return cls(**{key: sims, mkey: mask}, **kw)

    def sample(self, aaseq_idx, text_idx, rng):
        negs_a, negs_t = [], []
        if self.num_neg_protein:
            row = None if self.protein_sims is None \
                else np.asarray(self.protein_sims[aaseq_idx])
            mrow = None if self.protein_mask is None \
                else np.asarray(self.protein_mask[aaseq_idx])
            negs_a = list(negative_sampling_random_tail(
                aaseq_idx, self.n_proteins, self.num_neg_protein,
                self._true_by_text.get(text_idx, set()), rng,
                probs=row, mask=mrow))
        if self.num_neg_text:
            row = None if self.text_sims is None \
                else np.asarray(self.text_sims[text_idx])
            mrow = None if self.text_mask is None \
                else np.asarray(self.text_mask[text_idx])
            negs_t = list(negative_sampling_random_tail(
                text_idx, self.n_texts, self.num_neg_text,
                self._true_by_protein.get(aaseq_idx, set()), rng,
                probs=row, mask=mrow))
        return negs_a, negs_t


# ---------------------------------------------------------------------------
# Relation datasets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Relation:
    aaseq_idx: int
    text_idx: int
    relation: str = ""


class AASeqTextRelationDataset:
    """Protein<->text relations with split filtering.

    relations: sequence of (aaseq_idx, text_idx) or Relation. In the real
    layout these come from `{aaseq}_{text}_relations_indexed.unified.csv`
    under the split-method dir (dataset.py:1087-1117) — use
    `from_csv(...)`; tests construct directly.
    """

    def __init__(self, relations: Sequence, store, *, name="dataset",
                 negative_sampler=None, seed: int = 0):
        self.relations = [r if isinstance(r, Relation) else Relation(*r)
                          for r in relations]
        self.store = store
        self.name = name
        self.negative_sampler = negative_sampler or NullNegativeSampler()
        self.seed = seed
        self.true_pairs = {(r.aaseq_idx, r.text_idx) for r in self.relations}

    @classmethod
    def from_csv(cls, data_dir, aaseq_type, text_type, relation_filter,
                 split, *, split_method="random_split", store=None, **kw):
        import pandas as pd

        path = os.path.join(
            data_dir, "integrated_data", "v1",
            f"{aaseq_type}_{text_type}", split_method,
            f"{aaseq_type}_{text_type}_relations_indexed.unified.csv")
        df = pd.read_csv(path)
        if relation_filter and "relation" in df.columns:
            df = df[df["relation"].isin(relation_filter)]
        if split and "split" in df.columns:
            df = df[df["split"] == split]
        rel = [Relation(int(r["seq_id"]), int(r["text_id"]),
                        str(r.get("relation", "")))
               for _, r in df.iterrows()]
        return cls(rel, store, **kw)

    def __len__(self):
        return len(self.relations)

    def __getitem__(self, i):
        r = self.relations[i]
        rng = np.random.default_rng((self.seed * 1_000_003 + i) % 2 ** 31)
        neg_a, neg_t = self.negative_sampler.sample(r.aaseq_idx, r.text_idx,
                                                    rng)
        return {"aaseq_idx": r.aaseq_idx, "text_idx": r.text_idx,
                "rel_idx": i, "neg_aaseqs": neg_a, "neg_texts": neg_t}


class AASeqPairDataset:
    """Undirected protein-protein pairs (AASeqDataset, dataset.py:1284+)
    with swap_prob for direction augmentation."""

    def __init__(self, pairs: Sequence[Tuple[int, int]], store, *,
                 name="ppi", swap_prob=0.5, seed=0):
        self.pairs = list(pairs)
        self.store = store
        self.name = name
        self.swap_prob = swap_prob
        self.seed = seed
        self.true_pairs = set(pairs) | {(b, a) for a, b in pairs}

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        a, b = self.pairs[i]
        rng = np.random.default_rng((self.seed * 999_983 + i) % 2 ** 31)
        if rng.random() < self.swap_prob:
            a, b = b, a
        return {"aaseq_idx": a, "aaseq_idx_2": b, "rel_idx": i}
