"""LLM-as-a-Judge caption-comparison pipeline (a copy of
procyon_tpu/evaluate/llm_judge.py: host code; the reference-based metrics
through the port's caption metrics and BERTScore).

Native equivalent of the reference's external-LLM evaluation workflow
(examples/paper_analyses/external_llm_eval/: generate_llm_prompts.py,
generate_judge_prompts.py, parse_llm_judge_results.ipynb,
llm_reference_eval.py): pairwise phenotype-description ranking by a judge
LLM plus reference-based metrics (BERTScore/ROUGE/BLEU — all native here,
evaluate/bertscore.py + metrics.py).

Pipeline steps (reference README "LLM-as-a-Judge" workflow):
  1. stratified protein-subset selection (UniProt annotation-score strata)
  2. caption generation (the eval framework / caption_bulk.py)
  3. judge-prompt generation with randomized A/B order (position-bias
     control; verdict contract "[[A]]"/"[[B]]"/"[[C]]")
  4. verdict parsing + order-aware win/tie/loss tallies with bootstrap CIs
  5. reference-based scoring of both candidate sets

The judge LLM itself is external (no egress in this environment); this
module produces its inputs and consumes its outputs.
"""

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Same semantic contract as the reference's judge prompt
# (generate_judge_prompts.py:15-35): impartial, correctness-only, explicit
# position/length/name bias warnings, references first, strict verdict
# tokens. Wording is ours; the [[A]]/[[B]]/[[C]] verdict format is the
# load-bearing interface.
JUDGE_TEMPLATE = """You are an impartial judge comparing two AI assistants' \
answers to the question below. Judge ONLY factual consistency with the \
reference answers provided — ignore style, fluency, and formatting.

First compare each assistant's answer against the references in one or two \
sentences. Guard against position bias: the order the answers appear in \
must not affect your decision. Longer answers are not better answers, and \
assistant names must not matter. Some answers may be cut off mid-sentence; \
ignore truncation. Keep the explanation brief.

Then output exactly one final verdict token: "[[A]]" if assistant A's \
answer is more consistent with the references, "[[B]]" if assistant B's \
is, or "[[C]]" for a tie.

[User Question]
{question}

Start Reference Answer:
{answer_ref}
End Reference Answer

Start Assistant A answer
{answer_a}
End Assistant A answer

Start Assistant B answer
{answer_b}
End Assistant B answer"""


@dataclasses.dataclass
class JudgePrompt:
    entity_id: object
    prompt: str
    # True when the model-under-test ("ours") was shown as assistant A
    ours_is_a: bool


def make_judge_prompts(entries: Sequence[Dict], *, seed: int = 0,
                       template: str = JUDGE_TEMPLATE,
                       max_refs: int = 8) -> List[JudgePrompt]:
    """entries: [{"entity_id", "question", "references" (list or str),
    "ours", "baseline"}]. A/B order is randomized per entry so position
    bias cancels in the tally (generate_judge_prompts.py randomization)."""
    rng = np.random.default_rng(seed)
    out = []
    for e in entries:
        refs = e["references"]
        if isinstance(refs, str):
            refs = [refs]
        ref_block = "\n".join(f"- {r}" for r in refs[:max_refs])
        ours_is_a = bool(rng.integers(0, 2))
        a, b = (e["ours"], e["baseline"]) if ours_is_a \
            else (e["baseline"], e["ours"])
        out.append(JudgePrompt(
            entity_id=e["entity_id"],
            prompt=template.format(question=e["question"],
                                   answer_ref=ref_block, answer_a=a,
                                   answer_b=b),
            ours_is_a=ours_is_a))
    return out


_VERDICT_RE = re.compile(r"\[\[([ABC])\]\]")


def parse_judge_verdict(text: str) -> Optional[str]:
    """Last strict verdict token wins (judges often restate the format in
    the explanation; the reference parses the final occurrence).
    Returns "A" / "B" / "tie" / None."""
    hits = _VERDICT_RE.findall(text or "")
    if not hits:
        return None
    return {"A": "A", "B": "B", "C": "tie"}[hits[-1]]


def tally_judge_results(prompts: Sequence[JudgePrompt],
                        responses: Sequence[str], *,
                        n_boot: int = 1000, seed: int = 0) -> Dict:
    """Order-aware win/tie/loss rates for the model-under-test + bootstrap
    CIs over entities (parse_llm_judge_results semantics)."""
    assert len(prompts) == len(responses)
    outcomes = []  # +1 ours wins, 0 tie, -1 baseline wins
    n_unparsed = 0
    for p, r in zip(prompts, responses):
        v = parse_judge_verdict(r)
        if v is None:
            n_unparsed += 1
            continue
        if v == "tie":
            outcomes.append(0)
        elif (v == "A") == p.ours_is_a:
            outcomes.append(1)
        else:
            outcomes.append(-1)
    o = np.asarray(outcomes, np.int32)
    n = max(len(o), 1)
    res = {
        "n": len(o),
        "n_unparsed": n_unparsed,
        "win_rate": float((o == 1).sum() / n),
        "tie_rate": float((o == 0).sum() / n),
        "loss_rate": float((o == -1).sum() / n),
    }
    if len(o):
        rng = np.random.default_rng(seed)
        boots = [(o[rng.integers(0, len(o), len(o))] == 1).mean()
                 for _ in range(n_boot)]
        res["win_rate_ci_low"] = float(np.quantile(boots, 0.025))
        res["win_rate_ci_high"] = float(np.quantile(boots, 0.975))
    return res


def stratified_sample(entity_ids: Sequence, scores: Sequence[float],
                      n_per_stratum: int, *, n_strata: int = 5,
                      seed: int = 0) -> List:
    """Annotation-score-stratified subsampling
    (select_llm_samples.ipynb: UniProt annotation scores 1-5): sample
    n_per_stratum ids from each score stratum so both well- and
    under-studied proteins are covered."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(entity_ids)
    scores = np.asarray(scores, float)
    edges = np.quantile(scores, np.linspace(0, 1, n_strata + 1))
    out: List = []
    for s in range(n_strata):
        lo, hi = edges[s], edges[s + 1]
        mask = (scores >= lo) & ((scores < hi) if s < n_strata - 1
                                 else (scores <= hi))
        pool = ids[mask]
        if len(pool) == 0:
            continue
        take = min(n_per_stratum, len(pool))
        out.extend(pool[rng.choice(len(pool), take, replace=False)]
                   .tolist())
    return out


def reference_metrics(ours: Dict[object, str], baseline: Dict[object, str],
                      references: Dict[object, List[str]], *,
                      bertscorer=None) -> Dict[str, Dict[str, float]]:
    """Reference-based comparison of both candidate sets
    (llm_reference_eval.py): BERTScore F1 / ROUGE-L / BLEU per model over
    the shared entity set."""
    from procyon_tpu_torch.evaluate.caption import calc_caption_metrics

    shared = sorted(set(ours) & set(baseline) & set(references))
    out = {}
    for name, preds in (("ours", ours), ("baseline", baseline)):
        sub = {k: preds[k] for k in shared}
        refs = {k: references[k] for k in shared}
        out[name] = calc_caption_metrics(
            sub, refs, bertscorer=bertscorer,
            use_bertscore=bertscorer is not None, bootstrap=False)
    return out
