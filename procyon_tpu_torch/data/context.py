"""Context augmentation providers for [CONTEXT] prompt slots (a copy of
procyon_tpu/data/context.py).

Equivalent of the reference's context machinery in BaseITCollator
(procyon/data/it_collator.py): GO/Reactome ontology-ancestor RAG context
(:258-355), disease/drug functional-description context (:364-390), and
task-definition / entity rephrasings (:392-460).

A ContextProvider maps (text_type, text_idx) -> context string spliced at
the instance's [CONTEXT] marker. Providers compose; empty string = no
context (marker is dropped).
"""

from typing import Dict, List, Sequence


class NullContextProvider:
    def context(self, text_type: str, text_idx: int) -> str:
        return ""


class OntologyAncestorContext:
    """Ancestor-RAG context: for ontology terms (GO/Reactome/EC), prepend
    the names/descriptions of ancestor terms (it_collator.py:258-355).

    parents: {text_idx: [parent_idx, ...]} adjacency (DAG).
    names:   {text_idx: short name}.
    """

    def __init__(self, parents: Dict[int, Sequence[int]],
                 names: Dict[int, str], *, max_ancestors: int = 3,
                 template: str = "Context: This term is a descendant of "
                                 "{ancestors}. "):
        self.parents = parents
        self.names = names
        self.max_ancestors = max_ancestors
        self.template = template

    def _ancestors(self, idx: int) -> List[int]:
        seen, order, stack = set(), [], list(self.parents.get(idx, []))
        while stack and len(order) < self.max_ancestors:
            p = stack.pop(0)
            if p in seen:
                continue
            seen.add(p)
            order.append(p)
            stack.extend(self.parents.get(p, []))
        return order

    def context(self, text_type: str, text_idx: int) -> str:
        anc = [self.names[a] for a in self._ancestors(text_idx)
               if a in self.names]
        if not anc:
            return ""
        return self.template.format(ancestors="; ".join(anc))


class EntityDescriptionContext:
    """Functional-description context for diseases/drugs
    (it_collator.py:364-390): {text_idx: description}."""

    def __init__(self, descriptions: Dict[int, str],
                 template: str = "Context: {desc} "):
        self.descriptions = descriptions
        self.template = template

    def context(self, text_type: str, text_idx: int) -> str:
        d = self.descriptions.get(text_idx, "")
        return self.template.format(desc=d) if d else ""


class ComposedContext:
    def __init__(self, providers: Sequence):
        self.providers = list(providers)

    def context(self, text_type: str, text_idx: int) -> str:
        parts = [p.context(text_type, text_idx) for p in self.providers]
        return "".join(p for p in parts if p)
