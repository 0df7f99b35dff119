"""Instruction prompt construction.

Behavior-compatible with the reference's instruct_constructor
(procyon/data/instruct_tune/instruct_constructor.py:18-437): task JSON files
hold a Definition template with {Relationship Summary} / {Biological
Summary} / {Task-Specific Relationship} slots plus in-context example ids;
`get_prompt` assembles

    Definition: <filled definition>
    Positive example 1: ... / Negative example 1: ...
    Now, complete the following instance:
    <instance block for qa | retrieval | caption>

with `[EXT]` description-splice markers, `<|protein|>` soft-token
placeholders, `[PROT]` retrieval query token, `[ANSWER]` answer marker and
`[CONTEXT]` context-augmentation hook. The emitted strings match the
reference format so prompts (and therefore released-checkpoint behavior)
line up; task JSONs in the reference's schema load as-is, so users can point
`task_dir` at an existing ProCyon-Instruct task set.
"""

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

_AASEQ_PROMPT = {"protein": "Protein", "domain": "Domain",
                 "peptide": "Peptide"}


def aaseq_prompt_name(aaseq_type: Optional[str]) -> str:
    if isinstance(aaseq_type, str):
        return _AASEQ_PROMPT.get(aaseq_type.lower(), "Amino acid sequence")
    return "Amino acid sequence"


def load_task(path_or_dict) -> Dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        return json.load(f)


def construct_task_id(aaseq_type: str, text_type: str, relation: str,
                      task: str) -> str:
    """(aaseq, text, relation, task) -> task file stem
    (it_collator.py:886-940 semantics): protein-side datasets drop the
    aaseq prefix; domain keeps it; aaseq==text collapses (peptide_all_*,
    protein_experiments_* PPI)."""
    if aaseq_type == "protein" or aaseq_type == text_type:
        return f"{text_type}_{relation}_{task}"
    return f"{aaseq_type}_{text_type}_{relation}_{task}"


def fill_definition(task: Dict, template: Optional[str] = None) -> str:
    d = task["Definition"] if template is None else template
    for slot in ("Relationship Summary", "Biological Summary",
                 "Task-Specific Relationship"):
        d = d.replace("{%s}" % slot, task.get(slot, ""))
    return d


def n_prompt_variants(task: Dict) -> int:
    """1 (canonical) + number of task-definition rephrasings."""
    return 1 + len(task.get("Rephrasings") or [])


@dataclasses.dataclass
class Prompt:
    text: str                 # full template (with {answer} slot for qa)
    example_text_ids: List[int]
    example_aaseq_ids: List[int]
    n_protein_slots: int      # count of <|protein|> placeholders
    n_ext_slots: int          # count of [EXT] markers


def _qa_examples(examples: Sequence[Dict], kind: str, n: Optional[int],
                 is_ppi: bool, aaseq: str):
    header = "Positive example" if kind == "positive" else "Negative example"
    output = "yes" if kind == "positive" else "no"
    n = len(examples) if n is None else n
    examples = list(examples)[:n]
    if is_ppi:
        lines = [
            f"{header} {i+1}:\n{aaseq} 1: <|protein|>\n"
            f"{aaseq} 2: <|protein|>\nOutput: [ANSWER] {output}"
            for i in range(len(examples))]
        text_ids: List[int] = []
        aaseq_ids = [x for e in examples for x in (e["aaseq_1"], e["aaseq_2"])]
    else:
        lines = [
            f"{header} {i+1}:\nDescription: [EXT]\n{aaseq}: <|protein|>\n"
            f"[CONTEXT]Output: [ANSWER] {output}"
            for i in range(len(examples))]
        text_ids = [e["text"] for e in examples]
        aaseq_ids = [e["aaseq"] for e in examples]
    return "\n".join(lines), text_ids, aaseq_ids


def _retrieval_examples(examples, n, is_ppi, aaseq):
    n = len(examples) if n is None else n
    examples = list(examples)[:n]
    if is_ppi:
        lines = [
            f"Positive example {i+1}:\n{aaseq} 1: <|protein|>\n"
            f"{aaseq} 2: <|protein|>"
            for i in range(len(examples))]
        text_ids: List[int] = []
        aaseq_ids = [x for e in examples for x in (e["aaseq_1"], e["aaseq_2"])]
    else:
        lines = [
            f"Positive example {i+1}:\n[CONTEXT]Description: [EXT]\n"
            f"{aaseq}: <|protein|>"
            for i in range(len(examples))]
        text_ids = [e["text"] for e in examples]
        aaseq_ids = [e["aaseq"] for e in examples]
    return "\n".join(lines), text_ids, aaseq_ids


def _caption_examples(examples, n, aaseq):
    n = len(examples) if n is None else n
    examples = list(examples)[:n]
    lines = [
        f"Positive example {i+1}:\n[CONTEXT]{aaseq}: <|protein|>\n"
        f"Output: [ANSWER] [EXT]"
        for i in range(len(examples))]
    return ("\n".join(lines), [e["text"] for e in examples],
            [e["aaseq"] for e in examples])


def get_prompt(task: Dict, *, num_examples: Optional[int] = None,
               is_ppi: bool = False, aaseq_type: Optional[str] = "protein",
               open_definition: bool = False,
               rephrase_idx: Optional[int] = None, rng=None) -> Prompt:
    """rephrase_idx: None/0 = canonical Definition; i >= 1 selects
    task["Rephrasings"][i-1] (task-def rephrasings,
    it_collator.py:392-418) — same slots, alternative wording.

    rng: optional np.random.Generator — SAMPLE the ICL demonstrations from
    the task's example pool instead of always taking the first N
    (sample_demonstrations_for_prompts, instruct_constructor.py:368)."""
    aaseq = aaseq_prompt_name(aaseq_type)
    if rng is not None:
        task = dict(task)
        for key in ("Positive Examples", "Negative Examples"):
            pool = task.get(key) or []
            if len(pool) > 1:
                order = rng.permutation(len(pool))
                task[key] = [pool[i] for i in order]
    template = None
    if rephrase_idx:
        variants = task.get("Rephrasings") or []
        if variants:
            template = variants[(rephrase_idx - 1) % len(variants)][
                "Definition"]
    definition = "{definition}" if open_definition \
        else fill_definition(task, template)
    category = task["CATEGORY"]

    if category == "qa":
        pos, pt, pa = _qa_examples(task.get("Positive Examples", []),
                                   "positive", num_examples, is_ppi, aaseq)
        neg, nt, na = _qa_examples(task.get("Negative Examples", []),
                                   "negative", num_examples, is_ppi, aaseq)
        if is_ppi:
            instance = (f"Now, complete the following instance:\n"
                        f"{aaseq} 1: <|protein|>\n{aaseq} 2: <|protein|>\n"
                        f"Output: [ANSWER] ")
        else:
            instance = (f"Now, complete the following instance:\n"
                        f"Description: [EXT]\n{aaseq}: <|protein|>\n"
                        f"[CONTEXT]Output: [ANSWER] ")
        text = (f"Definition: {definition}\n{pos}\n{neg}\n{instance}"
                + "{answer}")
        text_ids, aaseq_ids = pt + nt, pa + na
    elif category == "retrieval":
        pos, pt, pa = _retrieval_examples(task.get("Positive Examples", []),
                                          num_examples, is_ppi, aaseq)
        if is_ppi:
            instance = (f"Now, complete the following instance:\n"
                        f"{aaseq} 1: <|protein|> \n{aaseq} 2: [PROT]")
        else:
            instance = (f"Now, complete the following instance:\n"
                        f"[CONTEXT]Description: [EXT]\n{aaseq}: [PROT]")
        text = f"Definition: {definition}\n{pos}\n{instance}"
        text_ids, aaseq_ids = pt, pa
    elif category == "caption":
        assert not is_ppi, "caption task has no PPI variant"
        pos, pt, pa = _caption_examples(task.get("Positive Examples", []),
                                        num_examples, aaseq)
        instance = (f"Now, complete the following instance:\n"
                    f"[CONTEXT]{aaseq}: <|protein|>\nOutput: [ANSWER] [EXT]")
        text = f"Definition: {definition}\n{pos}\n{instance}"
        text_ids, aaseq_ids = pt, pa
    else:
        raise ValueError(f"unknown CATEGORY {category!r}")

    return Prompt(text=text, example_text_ids=text_ids,
                  example_aaseq_ids=aaseq_ids,
                  n_protein_slots=text.count("<|protein|>"),
                  n_ext_slots=text.count("[EXT]"))


class TaskLibrary:
    """Loads task JSONs from a directory (this package's data/tasks by
    default; point at a ProCyon-Instruct task dir for exact parity)."""

    def __init__(self, task_dir: Optional[str] = None):
        self.task_dir = task_dir or os.path.join(
            os.path.dirname(__file__), "tasks")
        self._cache: Dict[str, Dict] = {}

    def get(self, task_id: str) -> Dict:
        if task_id not in self._cache:
            path = os.path.join(self.task_dir, f"{task_id}.json")
            self._cache[task_id] = load_task(path)
        return self._cache[task_id]

    def available(self) -> List[str]:
        return sorted(f[:-5] for f in os.listdir(self.task_dir)
                      if f.endswith(".json"))
