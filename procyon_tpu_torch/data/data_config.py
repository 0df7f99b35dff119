"""Dataset/collator factory from a dataset-mix YAML (a copy of
procyon_tpu/data/data_config.py: host numpy, the port's data modules).

Equivalent of procyon/data/it_data_config.py: ITDatasetConfig (:242),
ITMultiDatasetConfig.load_from_yaml (:371-431), get_IT_dataset (:38),
get_IT_collator (:146), and package_collators_for_trainer (:475).

YAML schema (compatible in spirit with the reference's data_configs/*.yml):

  datasets:
    - aaseq_type: protein
      text_type: go
      relations: [process]        # relation filter
      tasks: [qa, retrieval, caption]
      splits: [train]
      batch_size: 8               # optional per-dataset override
      weight: 1.0                 # sampling weight in the mix

Returns task streams consumable by training/trainer.Trainer.
"""

import dataclasses
import zlib
from typing import Dict, List, Optional

import numpy as np

from procyon_tpu_torch.data import collators as C
from procyon_tpu_torch.data import datasets as D
from procyon_tpu_torch.data import instruct, mixing


@dataclasses.dataclass
class DatasetEntry:
    aaseq_type: str = "protein"
    text_type: str = "go"
    relations: List[str] = dataclasses.field(default_factory=lambda: ["all"])
    tasks: List[str] = dataclasses.field(
        default_factory=lambda: ["qa", "retrieval", "caption"])
    splits: List[str] = dataclasses.field(default_factory=lambda: ["train"])
    batch_size: Optional[int] = None
    weight: float = 1.0
    # negative sampling: "random" (uniform masked) or "sim" (similarity-
    # weighted hard negatives from generated_data/negative_sampling_probs,
    # dataset.py:204-310); sims_type picks the matrix flavor
    negative_sampling: str = "random"
    sims_type: str = "jaccard"
    # versioned text-column subset (registry.TEXT_COLUMN_SUBSETS); 5 = the
    # released ProCyon-Full configuration
    subset_version: int = 5


@dataclasses.dataclass
class MultiDatasetConfig:
    entries: List[DatasetEntry]

    @classmethod
    def load_from_yaml(cls, path: str) -> "MultiDatasetConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        entries = [DatasetEntry(**e) for e in raw.get("datasets", [])]
        return cls(entries=entries)


def _is_ppi(entry: DatasetEntry) -> bool:
    return entry.text_type == "protein" and entry.aaseq_type == "protein"


# non-protein aaseq types get shorter synthetic sequences (peptides bind;
# domains are protein fragments)
_SYNTH_AASEQ_LENGTHS = {"peptide": (8, 30), "domain": (30, 80)}


def resolve_entry_store(store, entry: DatasetEntry, *, data_dir: str = "",
                        synthetic: bool = False,
                        aaseq_embedding_files: Optional[Dict[str, str]]
                        = None, _cache: Optional[Dict] = None):
    """Per-entry aaseq store: peptide/domain entries (ProCyon-Bind,
    reference configs/data_configs/peptide.yml aaseq_type: peptide) read
    their own sequence FASTA + frozen embedding table
    (peptide_embeddings_path, peptide_tune.yml:39-40) instead of the
    protein ones."""
    at = entry.aaseq_type
    if at == "protein":
        return store
    if _cache is not None and at in _cache:
        return _cache[at]
    if synthetic or isinstance(store, D.SyntheticStore):
        lo, hi = _SYNTH_AASEQ_LENGTHS.get(at, (20, 60))
        base = D.SyntheticStore(
            n_proteins=getattr(store, "n_proteins", 128),
            n_texts=getattr(store, "n_texts", 128),
            embed_dim=getattr(store, "embed_dim", 64),
            seed=sum(map(ord, at)), min_len=lo, max_len=hi)
    else:
        base = D.ProCyonDataStore(
            data_dir or getattr(store, "data_dir", ""), aaseq_type=at,
            embedding_file=(aaseq_embedding_files or {}).get(at) or None)
    if _cache is not None:
        _cache[at] = base
    return base


def _dataset_for_entry(entry: DatasetEntry, relation: str, store, data_dir,
                       split: str, synthetic: bool, seed: int):
    name = f"{entry.aaseq_type}_{entry.text_type}_{relation}_{split}"
    if synthetic:
        # a stable digest of the name (the reference's hash(name) changes
        # with the interpreter's hash seed, so its synthetic pairs differ
        # between processes and a resumed run would see other data)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        n = 256
        n_prot = getattr(store, "n_proteins", 128)
        n_text = getattr(store, "n_texts", 128)
        pairs = [(int(rng.integers(0, n_prot)), int(rng.integers(0, n_text)))
                 for _ in range(n)]
        if _is_ppi(entry):
            return D.AASeqPairDataset(pairs, store, name=name, seed=seed)
        sampler = D.RandomNegativeSampler(n_prot, n_text, set(pairs),
                                          num_neg_protein=1)
        return D.AASeqTextRelationDataset(pairs, store, name=name,
                                          negative_sampler=sampler,
                                          seed=seed)
    if _is_ppi(entry):
        import pandas as pd

        path = f"{data_dir}/integrated_data/v1/protein_protein/" \
               f"protein_protein_relations_indexed.unified.csv"
        df = pd.read_csv(path)
        if "split" in df.columns:
            df = df[df["split"] == split]
        pairs = [(int(r["seq_id"]), int(r["seq_id_2"]))
                 for _, r in df.iterrows()]
        return D.AASeqPairDataset(pairs, store, name=name, seed=seed)
    from procyon_tpu_torch.data import registry

    ds = D.AASeqTextRelationDataset.from_csv(
        data_dir, entry.aaseq_type, entry.text_type,
        None if relation == "all" else [relation], split, store=store,
        split_method=registry.canonical_split(entry.text_type),
        name=name, seed=seed)
    n_prot = max((a for a, _ in ds.true_pairs), default=0) + 1
    n_text = max((t for _, t in ds.true_pairs), default=0) + 1
    if entry.negative_sampling == "sim":
        ds.negative_sampler = D.SimNegativeSampler.from_data_dir(
            data_dir, "protein", entry.sims_type, n_proteins=n_prot,
            n_texts=n_text, true_pairs=ds.true_pairs, num_neg_protein=1)
    else:
        ds.negative_sampler = D.RandomNegativeSampler(
            n_prot, n_text, ds.true_pairs, num_neg_protein=1)
    return ds


def build_mlm_stream(store, *, batch_size: int, n_proteins: int,
                     max_protein_len: int = 1024, seed: int = 0,
                     state_holder: Optional[Dict[str, dict]] = None,
                     resume_state: Optional[dict] = None):
    """ESM2 masked-LM task stream (ProteinMLMCollator equivalent): sample
    proteins, tokenize them (long ones truncated to max_protein_len), mask
    them (native.mask_for_mlm). Batch n (from 1) draws its proteins from a
    generator seeded by (seed, "mlm", n) and masks with seed + n; the count
    of batches drawn goes into state_holder["mlm"] after each batch, and a
    stream built with that state as resume_state continues where it
    stopped. (The reference draws the proteins from one generator that the
    resume state does not hold.)"""
    from procyon_tpu_torch import native

    counter = [int((resume_state or {}).get("batches", 0))]
    tag = zlib.crc32(b"mlm")

    def stream():
        counter[0] += 1
        rng = np.random.default_rng((seed, tag, counter[0]))
        idxs = rng.integers(0, n_proteins, batch_size)
        seqs = [store.protein_sequence(int(i)) for i in idxs]
        pb = native.batch_encode(seqs, max_len=max_protein_len,
                                 long_strategy="truncate")
        masked, labels = native.mask_for_mlm(pb.tokens, seed + counter[0])
        if state_holder is not None:
            state_holder["mlm"] = {"batches": counter[0]}
        return {"protein_tokens": masked, "mlm_labels": labels}

    return stream


def _mark(batch, ridx):
    """Tag a batch with the sampled task-def rephrasing index (0 =
    canonical); mirrors the reference's rephrase_indicator batch field."""
    batch["rephrase_indicator"] = np.int32(ridx)
    return batch


def build_task_streams(cfg: MultiDatasetConfig, *, store, tokenizer,
                       collator_cfg: C.CollatorConfig,
                       batch_sizes: Dict[str, int],
                       data_dir: str = "", synthetic: bool = False,
                       task_library: Optional[instruct.TaskLibrary] = None,
                       seed: int = 0, rank: int = 0, world_size: int = 1,
                       resume_states: Optional[Dict[str, dict]] = None,
                       aaseq_embedding_files: Optional[Dict[str, str]]
                       = None):
    """-> (streams, mixers, state_holder).

    state_holder[task] tracks the mixer position after each stream() call;
    persist it in the trainer checkpoint and pass back as resume_states for
    exact mid-epoch resume (DistributedSamplerResume semantics). A batch's
    random choices (prompt rephrasing, yes / no rows) come from a generator
    seeded by (seed, task, the mixer position after the batch), so a
    resumed stream repeats them; the reference draws them from one
    generator shared by the streams, which the resume state does not
    hold."""
    from procyon_tpu_torch.data import registry

    lib = task_library or instruct.TaskLibrary()

    per_task_datasets: Dict[str, Dict[str, object]] = {}
    per_task_weights: Dict[str, Dict[str, float]] = {}
    prompts: Dict[str, object] = {}
    prompt_meta: Dict[str, tuple] = {}
    # dataset key -> task_id (keys embed the split name, which may itself
    # contain underscores — eval_zero_shot_hard — so parsing the key back
    # with rsplit is not safe)
    key_task_ids: Dict[str, str] = {}
    collators: Dict[str, object] = {}
    store_cache: Dict[str, object] = {}

    for entry in cfg.entries:
        entry_store = resolve_entry_store(
            store, entry, data_dir=data_dir, synthetic=synthetic,
            aaseq_embedding_files=aaseq_embedding_files,
            _cache=store_cache)
        for relation in entry.relations:
            for task in entry.tasks:
                task_id = instruct.construct_task_id(
                    entry.aaseq_type, entry.text_type, relation, task)
                try:
                    template = lib.get(task_id)
                except FileNotFoundError:
                    continue
                for split in entry.splits:
                    # "EVAL:<alias>" splits resolve to per-dataset names
                    # (it_data_config.py:269-277 SPLIT_MAPS semantics)
                    if split.startswith("EVAL:"):
                        split = registry.resolve_eval_split(
                            entry.aaseq_type, entry.text_type, split)
                    ds = _dataset_for_entry(entry, relation, entry_store,
                                            data_dir, split, synthetic,
                                            seed)
                    key = f"{task_id}_{split}"
                    per_task_datasets.setdefault(task, {})[key] = ds
                    per_task_weights.setdefault(task, {})[key] = entry.weight
                    key_task_ids[key] = task_id
                if task_id not in prompts:
                    ppi = _is_ppi(entry)
                    prompt_meta[task_id] = (template, ppi, entry.aaseq_type)
                    n_var = (instruct.n_prompt_variants(template)
                             if collator_cfg.use_task_def_rephrasings
                             else 1)
                    prompts[task_id] = [
                        instruct.get_prompt(
                            template,
                            num_examples=collator_cfg.num_examples,
                            is_ppi=ppi, aaseq_type=entry.aaseq_type,
                            rephrase_idx=r)
                        for r in range(n_var)]
                    if ppi:
                        coll_cls = {"qa": C.PPIQACollator,
                                    "retrieval": C.PPIRetrievalCollator}[task]
                        kwargs = {}
                    else:
                        coll_cls = {"qa": C.QACollator,
                                    "retrieval": C.RetrievalCollator,
                                    "caption": C.CaptionCollator}[task]
                        kwargs = {"known_positive_pairs": set()} \
                            if task == "retrieval" else {}
                    task_store = entry_store
                    if isinstance(entry_store, D.ProCyonDataStore):
                        from procyon_tpu_torch.data import registry
                        task_store = D.TextTableStore(
                            entry_store, entry.text_type,
                            registry.column_subset(
                                task, entry.text_type,
                                entry.subset_version) or [])
                    collators[task_id] = coll_cls(
                        collator_cfg, tokenizer, task_store, template,
                        **kwargs)

    streams = {}
    mixers = {}
    state_holder: Dict[str, dict] = {}
    resume_states = resume_states or {}
    for task, dsets in per_task_datasets.items():
        bs = batch_sizes.get(task, 8)
        mixer = mixing.TaskMixer(
            dsets, {k: bs for k in dsets}, seed=seed, rank=rank,
            world_size=world_size,
            weights=per_task_weights.get(task))
        mixers[task] = mixer
        start = mixing.MixerState.from_dict(resume_states[task]) \
            if task in resume_states else mixing.MixerState()
        it = mixer.iterate(start)

        entry_weights = per_task_weights.get(task, {})

        def make_stream(task=task, it=it, dsets=dsets,
                        entry_weights=entry_weights):
            def stream():
                key, idxs, nxt = next(it)
                state_holder[task] = nxt.to_dict()
                rng = np.random.default_rng(
                    (seed, zlib.crc32(task.encode()), nxt.epoch, nxt.index))
                ds = dsets[key]
                task_id = key_task_ids[key]
                variants = prompts[task_id]
                ridx = int(rng.integers(0, len(variants))) \
                    if len(variants) > 1 else 0
                if collator_cfg.sample_icl_examples:
                    template_, ppi_, atype_ = prompt_meta[task_id]
                    prompt = instruct.get_prompt(
                        template_, num_examples=collator_cfg.num_examples,
                        is_ppi=ppi_, aaseq_type=atype_,
                        rephrase_idx=ridx or None, rng=rng)
                else:
                    prompt = variants[ridx]
                coll = collators[task_id]
                items = [ds[i] for i in idxs]
                is_pair = "aaseq_idx_2" in items[0]
                if task == "qa":
                    if is_pair:
                        samples = [
                            (x["aaseq_idx"],
                             x["aaseq_idx_2"] if rng.random() < 0.5
                             else (x["aaseq_idx_2"] + 1 + int(
                                 rng.integers(0, 16))) % 128,
                             True) for x in items]
                        samples = [(a, b, bool(i % 2 == 0))
                                   for i, (a, b, _) in enumerate(samples)]
                        return _mark(coll(samples, prompt), ridx)
                    # "no" rows use sampled negatives avoiding true
                    # relations (QACollator pos+neg rows,
                    # it_collator.py:995-1060)
                    samples = []
                    for x in items:
                        pos = bool(rng.random() < 0.5)
                        if pos or not x["neg_aaseqs"]:
                            samples.append((x["aaseq_idx"], x["text_idx"],
                                            pos))
                        else:
                            samples.append((int(x["neg_aaseqs"][0]),
                                            x["text_idx"], False))
                    return _mark(coll(samples, prompt), ridx)
                if is_pair:
                    samples = [(x["aaseq_idx"], x["aaseq_idx_2"])
                               for x in items]
                    return _mark(coll(samples, prompt), ridx)
                samples = [(x["aaseq_idx"], x["text_idx"]) for x in items]
                batch = _mark(coll(samples, prompt), ridx)
                if task == "caption":
                    w = entry_weights.get(key, 1.0)
                    if w != 1.0:
                        batch["loss_weight"] = np.float32(w)
                return batch

            return stream

        streams[task] = make_stream()
    return streams, mixers, state_holder


DEFAULT_FULL_MIX = MultiDatasetConfig(entries=[
    DatasetEntry(text_type="go",
                 relations=["process", "component", "function"]),
    DatasetEntry(text_type="pfam", relations=["all"]),
    DatasetEntry(text_type="drugbank",
                 relations=["drug_target", "drug_carrier", "drug_enzyme",
                            "drug_transporter"]),
    DatasetEntry(text_type="reactome", relations=["all"]),
    DatasetEntry(text_type="ec", relations=["all"]),
    DatasetEntry(text_type="gtop", relations=["all"]),
    DatasetEntry(text_type="omim", relations=["all"]),
    DatasetEntry(text_type="disgenet", relations=["all"]),
    DatasetEntry(text_type="uniprot", relations=["all"]),
])
