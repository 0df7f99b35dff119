"""Bulk caption generation CLI (counterpart of scripts/caption_bulk.py).

A protein-id list -> per-protein diverse-beam captions (beam 10, group 2,
diversity 0.8), chunked sharding across workers, CSV output.

Synthetic smoke run:
  python -m procyon_tpu_torch.scripts.caption_bulk --synthetic \
      --n_proteins 4 --max_new_tokens 8 --out captions.csv [--device cpu]
From a model directory (models/checkpoint_io.load_model) over the
ProCyon-Instruct data store (DATA_DIR):
  python -m procyon_tpu_torch.scripts.caption_bulk --checkpoint <dir> \
      --protein_ids ids.txt --out captions.csv
"""

import argparse
import csv


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--protein_ids", type=str, default=None,
                   help="file with one protein index per line")
    p.add_argument("--n_proteins", type=int, default=8)
    p.add_argument("--task", type=str, default="uniprot_all_caption")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--beam_group_size", type=int, default=2)
    p.add_argument("--diversity_penalty", type=float, default=0.8)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--out", type=str, default="captions.csv")
    p.add_argument("--paged", action="store_true",
                   help="beam decode on the paged KV pool (shared prompt "
                        "pages; same tokens as the dense path)")
    p.add_argument("--shared_prefix", action="store_true",
                   help="dedup identical leading prompt blocks, within a "
                        "batch and across batches (a persistent "
                        "BeamPoolSession caches the instruction "
                        "template's KV: batches 2..n skip its prefill); "
                        "needs --paged")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs (cuda unless told otherwise)")
    args = p.parse_args(argv)
    if args.shared_prefix and not args.paged:
        p.error("--shared_prefix needs --paged")

    import torch

    from procyon_tpu_torch.data import collators as C
    from procyon_tpu_torch.data import datasets, instruct
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonCaptionEval
    from procyon_tpu_torch.inference import generation
    from procyon_tpu_torch.models import llama, unified

    device = torch.device(args.device)
    if args.synthetic:
        # the synthetic smoke model: f32 on the CPU's reference backend; on
        # the card bf16, the type the attention kernels take (head_dim 32
        # is one of the flash kernel's)
        on_cpu = device.type == "cpu"
        dtype = torch.float32 if on_cpu else torch.bfloat16
        cfg = unified.UnifiedConfig(
            llama=llama.LlamaConfig(
                vocab_size=4096, dim=128, n_layers=2, n_heads=4,
                n_kv_heads=2, intermediate=256, max_seq_len=512,
                dtype=dtype, attn_backend="ref" if on_cpu else None),
            esm=None, protein_embed_dim=64, token_projector_layers=2,
            token_projector_hidden=64, retrieval_dim=32, dtype=dtype)
        params = unified.init_params(0, cfg, device=device)
        store = datasets.SyntheticStore(n_proteins=64, embed_dim=64)
        tokenizer = load_tokenizer(vocab_size=4096)
        ids = list(range(args.n_proteins))
    else:
        if not args.checkpoint or not args.protein_ids:
            p.error("without --synthetic, --checkpoint and --protein_ids "
                    "are needed")
        from procyon_tpu_torch.models.checkpoint_io import load_model

        params, cfg, tokenizer = load_model(args.checkpoint, device=device)
        store = datasets.ProCyonDataStore()
        with open(args.protein_ids) as f:
            ids = [int(line) for line in f if line.strip()]

    # chunked sharding
    ids = [i for n, i in enumerate(ids)
           if n % args.num_chunks == args.chunk_idx]

    gen = generation.GenerationConfig(
        max_new_tokens=args.max_new_tokens, method="beam",
        beam_size=args.beam_size, beam_group_size=args.beam_group_size,
        diversity_penalty=args.diversity_penalty,
        eos_token_id=tokenizer.spec.eos_id,
        pad_token_id=tokenizer.spec.pad_id)
    lib = instruct.TaskLibrary()
    model = ProcyonCaptionEval(
        params, cfg, tokenizer, store, lib.get(args.task),
        batch_size=args.batch_size, gen=gen, use_paged=args.paged,
        shared_prefix=args.shared_prefix, device=device,
        collator_cfg=C.CollatorConfig(
            protein_embed_dim=cfg.encoder_out_dim))
    captions = model.get_predictions(ids)

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["protein_id", "caption"])
        for pid in ids:
            w.writerow([pid, captions.get(pid, "")])
    print(f"wrote {len(ids)} captions to {args.out}")


if __name__ == "__main__":
    main()
