"""Protein indexing: the program's `training/evaluation.all_protein_target_
embeddings` over calls of the mix's `proteins` proteins, a closed loop of
one caller, as a retrieval index is built.

Set-up draws the weights, puts the encoder in the configuration's layout
and warms up with one call (unit 0; every call has the same lengths, so the
same shapes). Unit i > 0 is one call on the proteins of generator.sequences
(mix, seed, i), with ids new to the store. The record keeps the call's
embeddings on the host and the token counts of its chunk rows (the
benchmark's own chunking: a protein of n residues is ceil(n / max_len)
rows of at most max_len + 2 tokens).

The check: a sample of the window's proteins drawn from the seed, the
longest among them, embedded by the plain reference from the sequences and
the raw weights drawn again; the worst relative L2 gap of a protein's
embedding.
"""

import gc

import numpy as np
import torch

from benchmark.models import esm2 as model
from benchmark.reference import esm2 as ref
from benchmark.traffic import generator

# the reference's precision for each weight layout
REFERENCE = {"w8a8": "w8a8", "bf16": "f32"}
# the control: one step below
CONTROL = {"w8a8": "w4a8", "bf16": "fp8"}
FAULTS = ("half_batch", "answer_altered")


class Store:
    """protein_sequence(id) over the sequences the window generated."""

    def __init__(self):
        self.seqs = []

    def add(self, seqs):
        ids = list(range(len(self.seqs), len(self.seqs) + len(seqs)))
        self.seqs.extend(seqs)
        return ids

    def protein_sequence(self, i):
        return self.seqs[i]


def chunk_tokens(seq_len, max_len):
    """Token counts of a protein's chunk rows (CLS and EOS included)."""
    full, rest = divmod(max(seq_len, 1), max_len)
    return [max_len + 2] * full + ([rest + 2] if rest else [])


class Program:
    first_unit = 1

    def __init__(self, cell, seed, device, fault=None):
        from procyon_tpu_torch.training import evaluation
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} for this driver")
        self.cell, self.seed, self.device, self.fault = cell, seed, device, \
            fault
        self.mix, cfg = cell.traffic, cell.config
        dtype = torch.bfloat16 if device != "cpu" else torch.float32
        esm_cfg = model.port_esm_config(cfg, dtype=dtype)
        self.ucfg = model.port_unified_config(cfg, esm_cfg, dtype=dtype)
        raw = model.raw_weights(cfg, seed, device)
        proj = model.raw_projector(cfg, seed, device)
        if dtype != torch.bfloat16:
            raw = model.cast_tree(raw, dtype)
            proj = proj.to(dtype)
        self.params = {"esm": model.port_serving_params(raw, cfg, esm_cfg),
                       "projectors": {"shared_projector": [{"w": proj}]}}
        del raw
        self.store = Store()
        self.embed_fn = evaluation.all_protein_target_embeddings
        self.unit(0)

    def _embed(self, ids):
        return self.embed_fn(
            self.params, self.ucfg, self.store, ids,
            batch=self.mix["proteins"],
            max_protein_len=self.mix["max_protein_len"],
            device=self.device)

    def unit(self, i):
        seqs = generator.sequences(self.mix, self.seed, i)
        ids = self.store.add(seqs)
        if self.fault == "half_batch":
            half = self._embed(ids[:len(ids) // 2])
            emb = np.concatenate([half, np.repeat(
                half.mean(0, keepdims=True), len(ids) - len(half), 0)])
        else:
            emb = self._embed(ids)
        if self.fault == "answer_altered":
            j = int(np.argmax([len(s) for s in seqs]))
            emb[j, :64] = -emb[j, :64]
        m = self.mix["max_protein_len"]
        rows = [t for s in seqs for t in chunk_tokens(len(s), m)]
        return {"ids": ids, "emb": emb, "proteins": len(ids), "rows": rows,
                "width": m + 2}

    def attempted(self, records):
        n = sum(r["proteins"] for r in records)
        bad = sum(int(r["emb"].shape[0] != r["proteins"]
                      or not np.isfinite(r["emb"]).all()) * r["proteins"]
                  for r in records)
        return n, bad

    def end_to_end(self, records, seconds):
        return {"proteins_per_s": sum(r["proteins"] for r in records)
                / seconds}

    def sample(self, records):
        """Indices into the window's proteins: the longest, and the
        rest of the judge's sample drawn from the seed."""
        ids = [i for r in records for i in r["ids"]]
        k = min(self.cell.limits["sample"], len(ids))
        lengths = np.array([len(self.store.seqs[i]) for i in ids])
        rng = np.random.default_rng([int(self.seed) % 2 ** 63, 1 << 20])
        longest = int(np.argmax(lengths))
        rest = [j for j in rng.permutation(len(ids)) if j != longest]
        return [longest] + [int(j) for j in rest[:k - 1]]

    def reference(self, seqs, precision):
        cfg = self.cell.config
        raw = model.raw_weights(cfg, self.seed, self.device)
        proj = model.raw_projector(cfg, self.seed, self.device)
        ref.no_tf32()
        out = ref.protein_embeddings(
            raw, proj, model.dims(cfg), seqs, self.mix["max_protein_len"],
            precision, device=self.device)
        return out.cpu().double().numpy()

    def release(self):
        self.params = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def judge(self, records):
        self.release()
        emb = np.concatenate([r["emb"] for r in records]).astype(np.float64)
        ids = [i for r in records for i in r["ids"]]
        pick = self.sample(records)
        seqs = [self.store.seqs[ids[j]] for j in pick]
        truth = self.reference(seqs, REFERENCE[self.cell.config["layout"]
                                               ["weights"]])
        return [("embedding_rel_gap_max",
                 worst_gap(emb[pick], truth), self.cell.limits[
                     "embedding_rel_gap_max"])]

    def control(self, records):
        """The check with the reference one precision step below in the
        program's place."""
        self.release()
        ids = [i for r in records for i in r["ids"]]
        seqs = [self.store.seqs[ids[j]] for j in self.sample(records)]
        layout = self.cell.config["layout"]["weights"]
        low = self.reference(seqs, CONTROL[layout])
        truth = self.reference(seqs, REFERENCE[layout])
        return worst_gap(low, truth)


def worst_gap(got, truth):
    gap = np.linalg.norm(got - truth, axis=1) / np.maximum(
        np.linalg.norm(truth, axis=1), 1e-30)
    return float(gap.max())
