"""BERTScore rescaling-baseline constants (counterpart of
scripts/compute_bertscore_baseline.py).

bert_score's rescale_with_baseline=True (the reference's setting,
procyon/evaluate/framework/caption.py:85-95) maps raw scores through
(s - b) / (1 - b), where b is the mean score of unrelated sentence pairs
under the (model, layer). bert_score ships en-sci constants averaged over
about 1M Common Crawl pairs; here b is computed over random pairs from a
corpus the caller gives (the caption references are the natural choice),
so rescaled scores are comparable across runs that share a baseline file
(evaluate/bertscore.compute_baseline). The encoder runs on --device
("cuda" unless told otherwise; bf16 there, f32 on the CPU).

  python -m procyon_tpu_torch.scripts.compute_bertscore_baseline \\
      --sentences refs.txt [--model_dir <scibert dir>] [--layer 8] \\
      [--n_pairs 1000] --out baseline.json
  # then: run_eval_framework --use_bertscore \\
  #           --bertscore_baseline_file baseline.json
  python -m procyon_tpu_torch.scripts.compute_bertscore_baseline \\
      --synthetic --out baseline.json [--device cpu]

main(argv) writes the JSON record, prints it and returns it.
"""

import argparse
import json

# the --synthetic corpus: sentences of 5-11 of these words
SYNTHETIC_WORDS = ["protein", "binding", "membrane", "kinase", "phenotype",
                   "signal", "transport", "enzyme", "pathway", "receptor",
                   "domain", "complex", "nuclear", "growth", "response"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sentences", type=str, default=None,
                   help="text file, one sentence per line (the corpus b is "
                        "computed over)")
    p.add_argument("--synthetic", action="store_true",
                   help="a generated corpus and synthetic weights")
    p.add_argument("--model_dir", type=str, default=None,
                   help="local HF BERT / SciBERT checkpoint directory; "
                        "omitted: synthetic weights")
    p.add_argument("--layer", type=int, default=None)
    p.add_argument("--idf", action="store_true")
    p.add_argument("--n_pairs", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="bertscore_baseline.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the encoder runs (cuda unless told "
                        "otherwise)")
    args = p.parse_args(argv)

    from procyon_tpu_torch.evaluate.bertscore import (compute_baseline,
                                                      make_scorer)

    if args.sentences:
        with open(args.sentences) as f:
            sentences = [ln.strip() for ln in f if ln.strip()]
    elif args.synthetic:
        import numpy as np

        rng = np.random.default_rng(args.seed)
        sentences = [" ".join(rng.choice(SYNTHETIC_WORDS,
                                         rng.integers(5, 12)))
                     for _ in range(64)]
    else:
        p.error("need --sentences or --synthetic")

    kw = {} if args.layer is None else {"layer": args.layer}
    scorer = make_scorer(args.model_dir, idf=args.idf, device=args.device,
                         **kw)
    bp, br, bf = compute_baseline(scorer, sentences, n_pairs=args.n_pairs,
                                  seed=args.seed)
    record = {
        "precision": bp, "recall": br, "f1": bf,
        "layer": scorer.layer, "idf": bool(args.idf),
        "n_pairs": args.n_pairs, "n_sentences": len(sentences),
        "seed": args.seed,
        "model_dir": args.model_dir or "synthetic",
        "method": "random unrelated pairs from the supplied corpus "
                  "(bert_score baseline method; see module docstring for "
                  "the corpus deviation from the shipped en-sci file)",
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
