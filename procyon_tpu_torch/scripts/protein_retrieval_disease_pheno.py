"""Single disease-phenotype retrieval CLI (counterpart of
scripts/protein_retrieval_disease_pheno.py; the reference's
scripts/protein_retrieval_disease_pheno.py:14-85): a task and a disease
description (inline or from a file) -> ranked proteins, as JSON.

    python -m procyon_tpu_torch.scripts.protein_retrieval_disease_pheno \\
        --synthetic --disease_desc "progressive muscle weakness with \\
        elevated CK" --k 5 [--device cpu]

--synthetic: the reference script's tiny model (dim 128, 2 layers, a
4096-word vocabulary, frozen 64-wide protein tables) on weights drawn from
seed 0, over a synthetic store of 128 proteins; bf16 on the card, f32 on
the plain attention on the CPU. --checkpoint DIR: a model directory
(models/checkpoint_io.load_model) over ProCyonDataStore's proteins (the
first NUM_PROTEINS, 57000 by default). `run` is the body a caller with its
own weights uses.
"""

import argparse
import json
import os

import torch

from procyon_tpu_torch.data import datasets
from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
from procyon_tpu_torch.inference.retrieval_service import startup_retrieval
from procyon_tpu_torch.models import llama, unified


def synthetic_config(device):
    """The reference script's tiny config, on the plain attention in f32
    on the CPU and in bf16 on the card."""
    on_cpu = torch.device(device).type == "cpu"
    dtype = torch.float32 if on_cpu else torch.bfloat16
    return unified.UnifiedConfig(
        llama=llama.LlamaConfig(vocab_size=4096, dim=128, n_layers=2,
                                n_heads=4, n_kv_heads=2, intermediate=256,
                                max_seq_len=512, dtype=dtype,
                                attn_backend="ref" if on_cpu else None),
        esm=None, protein_embed_dim=64, token_projector_layers=2,
        token_projector_hidden=64, retrieval_dim=32, dtype=dtype)


def run(params, cfg, tokenizer, store, ids, *, disease_desc,
        instruction_source_dataset="disgenet", k=10, device="cuda"):
    """The service over `ids`' proteins, then one description's top k:
    [{"protein_id", "score", ...}], best first."""
    service = startup_retrieval(params, cfg, tokenizer, store, ids,
                                device=device)
    task_id = f"{instruction_source_dataset}_all_retrieval"
    return service.retrieve(task_id=task_id, disease_desc=disease_desc, k=k)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--task_desc_infile", type=str, default=None,
                   help="accepted as in the reference; the task comes from "
                        "--instruction_source_dataset")
    p.add_argument("--disease_desc_infile", type=str, default=None)
    p.add_argument("--disease_desc", type=str, default=None)
    p.add_argument("--instruction_source_dataset", type=str,
                   default="disgenet", choices=["disgenet", "omim"])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    desc = args.disease_desc
    if args.disease_desc_infile:
        with open(args.disease_desc_infile) as f:
            desc = f.read().strip()
    if not desc:
        raise SystemExit("provide --disease_desc or --disease_desc_infile")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")

    if args.synthetic:
        cfg = synthetic_config(args.device)
        params = unified.init_params(0, cfg, device=args.device)
        store = datasets.SyntheticStore(n_proteins=128, embed_dim=64)
        tokenizer = load_tokenizer(vocab_size=4096)
        ids = list(range(128))
    else:
        if not args.checkpoint:
            raise SystemExit("provide --checkpoint DIR or --synthetic")
        from procyon_tpu_torch.models.checkpoint_io import load_model

        params, cfg, tokenizer = load_model(args.checkpoint,
                                            device=args.device)
        store = datasets.ProCyonDataStore()
        ids = list(range(int(os.environ.get("NUM_PROTEINS", "57000"))))

    results = run(params, cfg, tokenizer, store, ids, disease_desc=desc,
                  instruction_source_dataset=args.instruction_source_dataset,
                  k=args.k, device=args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
