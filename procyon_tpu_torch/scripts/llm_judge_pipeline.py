"""LLM-as-a-Judge pipeline CLI (counterpart of scripts/llm_judge_pipeline.py;
the reference's paper_analyses/external_llm_eval workflow).

Subcommands (external_llm_eval/README.md):

  select      stratified protein-subset selection from an annotation-score
              CSV (select_llm_samples.ipynb)
  prompts     judge prompts from two caption CSVs and the references
              (generate_judge_prompts.py); the A/B order randomized and
              recorded
  tally       parse the judge's responses, order-corrected win / tie / loss
              rates with bootstrap CIs (parse_llm_judge_results.ipynb)
  refscore    reference-based metrics for both caption sets: BERTScore
              (the encoder on --device), ROUGE-L and BLEU
              (llm_reference_eval.py)

CSV contracts: caption files have columns (entity_id, caption); the
references file (entity_id, reference), an entity_id repeated for several
references; the responses file (entity_id, response). The judge LLM itself
is external. main(argv) prints one JSON line and returns it as a dict.

  python -m procyon_tpu_torch.scripts.llm_judge_pipeline refscore \\
      --ours ours.csv --baseline base.csv --references refs.csv \\
      --use_bertscore [--bertscore_model_dir <dir>] [--device cpu]
"""

import argparse
import csv
import json


def _read_csv(path, cols):
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append(tuple(row[c] for c in cols))
    return out


def cmd_select(args):
    from procyon_tpu_torch.evaluate.llm_judge import stratified_sample

    rows = _read_csv(args.scores, ("entity_id", "score"))
    ids = [r[0] for r in rows]
    scores = [float(r[1]) for r in rows]
    chosen = stratified_sample(ids, scores, args.n_per_stratum,
                               n_strata=args.n_strata, seed=args.seed)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["entity_id"])
        for c in chosen:
            w.writerow([c])
    return {"selected": len(chosen), "out": args.out}


def _load_captions(path):
    return {e: c for e, c in _read_csv(path, ("entity_id", "caption"))}


def _load_references(path):
    refs = {}
    for e, r in _read_csv(path, ("entity_id", "reference")):
        refs.setdefault(e, []).append(r)
    return refs


def cmd_prompts(args):
    from procyon_tpu_torch.evaluate.llm_judge import make_judge_prompts

    ours = _load_captions(args.ours)
    base = _load_captions(args.baseline)
    refs = _load_references(args.references)
    entries = [{"entity_id": e, "question": args.question,
                "references": refs[e], "ours": ours[e],
                "baseline": base[e]}
               for e in sorted(set(ours) & set(base) & set(refs))]
    prompts = make_judge_prompts(entries, seed=args.seed)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["entity_id", "prompt", "ours_is_a"])
        for p in prompts:
            w.writerow([p.entity_id, p.prompt, int(p.ours_is_a)])
    return {"prompts": len(prompts), "out": args.out}


def cmd_tally(args):
    from procyon_tpu_torch.evaluate.llm_judge import (JudgePrompt,
                                                      tally_judge_results)

    prows = _read_csv(args.prompts, ("entity_id", "prompt", "ours_is_a"))
    prompts = [JudgePrompt(e, p, bool(int(a))) for e, p, a in prows]
    responses = dict(_read_csv(args.responses, ("entity_id", "response")))
    ordered = [responses.get(p.entity_id, "") for p in prompts]
    return tally_judge_results(prompts, ordered, seed=args.seed)


def cmd_refscore(args):
    from procyon_tpu_torch.evaluate.llm_judge import reference_metrics

    scorer = None
    if args.use_bertscore:
        from procyon_tpu_torch.evaluate.bertscore import make_scorer

        scorer = make_scorer(args.bertscore_model_dir, device=args.device)
    return reference_metrics(_load_captions(args.ours),
                             _load_captions(args.baseline),
                             _load_references(args.references),
                             bertscorer=scorer)


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("select")
    s.add_argument("--scores", required=True)
    s.add_argument("--n_per_stratum", type=int, default=50)
    s.add_argument("--n_strata", type=int, default=5)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_select)

    s = sub.add_parser("prompts")
    s.add_argument("--ours", required=True)
    s.add_argument("--baseline", required=True)
    s.add_argument("--references", required=True)
    s.add_argument("--question",
                   default="Describe the phenotypes and functions "
                           "associated with this protein.")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out", required=True)
    s.set_defaults(fn=cmd_prompts)

    s = sub.add_parser("tally")
    s.add_argument("--prompts", required=True)
    s.add_argument("--responses", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_tally)

    s = sub.add_parser("refscore")
    s.add_argument("--ours", required=True)
    s.add_argument("--baseline", required=True)
    s.add_argument("--references", required=True)
    s.add_argument("--use_bertscore", action="store_true")
    s.add_argument("--bertscore_model_dir", default=None)
    s.add_argument("--device", type=str, default="cuda",
                   help="where the BERTScore encoder runs (cuda unless "
                        "told otherwise)")
    s.set_defaults(fn=cmd_refscore)

    args = p.parse_args(argv)
    out = args.fn(args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
