"""QA-based caption filtering CLI (counterpart of
scripts/qa_filter_captions.py).

Scores generated captions with the model's QA yes-probability
(`ProcyonQAEval.answer_logits` at [ANSWER], `qa_yes_prob`) and keeps those
at or above --threshold (post-hoc hallucination filtering). Writes a CSV
of protein_id, caption, qa_yes_prob.

Synthetic smoke run (the tiny model: bf16 on the card, f32 with --device
cpu):
  python -m procyon_tpu_torch.scripts.caption_bulk --synthetic \\
      --n_proteins 4 --max_new_tokens 8 --out captions.csv
  python -m procyon_tpu_torch.scripts.qa_filter_captions --synthetic \\
      --captions captions.csv --out filtered.csv
From a model directory (models/checkpoint_io.load_model) over the
ProCyon-Instruct data store (DATA_DIR):
  python -m procyon_tpu_torch.scripts.qa_filter_captions \\
      --checkpoint <dir> --captions captions.csv
"""

import argparse
import csv
import sys


class _CaptionStore:
    """A store whose texts at the given ids are the captions; everything
    else is the wrapped store's."""

    def __init__(self, base, captions):
        self.base = base
        self.captions = captions

    def protein_sequence(self, i):
        return self.base.protein_sequence(i)

    def protein_embedding(self, i):
        return self.base.protein_embedding(i)

    def text(self, i):
        return self.captions.get(i, self.base.text(i))


def score_captions(params, cfg, tokenizer, store, rows, *, task,
                   batch_size=16, device="cuda"):
    """[(protein_id, caption, qa_yes_prob)] for rows of (protein_id,
    caption): each caption's yes-probability is ProcyonQAEval's for the
    protein with the caption as the text."""
    from procyon_tpu_torch.data import collators as C
    from procyon_tpu_torch.evaluate.procyon_models import ProcyonQAEval
    from procyon_tpu_torch.evaluate.qa import qa_yes_prob

    # each caption is a text of its own, at an id past the store's
    cap_by_id = {10 ** 9 + n: cap for n, (_, cap) in enumerate(rows)}
    model = ProcyonQAEval(
        params, cfg, tokenizer, _CaptionStore(store, cap_by_id), task,
        batch_size=batch_size, device=device,
        collator_cfg=C.CollatorConfig(protein_embed_dim=cfg.encoder_out_dim))
    spec = tokenizer.spec

    out_rows = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        samples = [(pid, 10 ** 9 + i + n, 1)
                   for n, (pid, _) in enumerate(chunk)]
        probs = qa_yes_prob(model.answer_logits(samples), spec.yes_id,
                            spec.no_id)
        for (pid, cap), prob in zip(chunk, probs):
            out_rows.append((pid, cap, float(prob)))
    return out_rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--captions", type=str, required=True)
    p.add_argument("--task", type=str, default="uniprot_all_qa")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", type=str, default="filtered_captions.csv")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs (cuda unless told otherwise)")
    args = p.parse_args(argv)

    import torch

    from procyon_tpu_torch.data import datasets, instruct
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.models import llama, unified

    device = torch.device(args.device)
    if args.synthetic:
        # f32 on the CPU; on the card bf16, the type the attention kernels
        # take (head_dim 32 is one of the flash kernel's)
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        cfg = unified.UnifiedConfig(
            llama=llama.LlamaConfig(vocab_size=4096, dim=128, n_layers=2,
                                    n_heads=4, n_kv_heads=2,
                                    intermediate=256, max_seq_len=512,
                                    dtype=dtype),
            esm=None, protein_embed_dim=64, token_projector_layers=2,
            token_projector_hidden=64, retrieval_dim=32, dtype=dtype)
        params = unified.init_params(0, cfg, device=device)
        store = datasets.SyntheticStore(n_proteins=64, embed_dim=64)
        tokenizer = load_tokenizer(vocab_size=4096)
    else:
        if not args.checkpoint:
            p.error("without --synthetic, --checkpoint is needed")
        from procyon_tpu_torch.models.checkpoint_io import load_model

        params, cfg, tokenizer = load_model(args.checkpoint, device=device)
        store = datasets.ProCyonDataStore()

    rows = []
    with open(args.captions) as f:
        for row in csv.DictReader(f):
            rows.append((int(row["protein_id"]), row["caption"]))

    out_rows = score_captions(
        params, cfg, tokenizer, store, rows,
        task=instruct.TaskLibrary().get(args.task),
        batch_size=args.batch_size, device=device)

    kept = [(p_, c, s) for p_, c, s in out_rows if s >= args.threshold]
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["protein_id", "caption", "qa_yes_prob"])
        for r in kept:
            w.writerow(r)
    print(f"kept {len(kept)}/{len(out_rows)} captions -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
