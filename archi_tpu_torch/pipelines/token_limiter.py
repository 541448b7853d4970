"""Token-budget pruning of prompt inputs.

Copy of ``archi_tpu/pipelines/token_limiter.py``.

Mirrors the reference's ``TokenLimiter``
(``src/archi/pipelines/classic_pipelines/utils/token_limiter.py:12``;
``prune_inputs_to_token_limit:113``): before a chain call, history and
retrieved documents are trimmed so the rendered prompt fits the model's
context budget.  The reference counts with tiktoken; counting here uses a
chars/4 heuristic by default with a pluggable counter (token counting is not
perf-critical — SURVEY.md §2.9).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from archi_tpu_torch.utils.documents import Document


def approx_token_count(text: str) -> int:
    return max(1, len(text) // 4)


class TokenLimiter:
    def __init__(self, max_tokens: int = 7000, *,
                 reserved_for_output: int = 1000,
                 count_fn: Callable[[str], int] = approx_token_count):
        self.max_tokens = max_tokens
        self.reserved = reserved_for_output
        self.count = count_fn

    @property
    def budget(self) -> int:
        return max(self.max_tokens - self.reserved, 256)

    def count_message(self, item: Any) -> int:
        if isinstance(item, Document):
            return self.count(item.page_content)
        if isinstance(item, (tuple, list)) and len(item) >= 2:
            return self.count(str(item[1]))
        return self.count(str(item))

    def prune_history(self, history: Sequence, budget: int) -> list:
        """Keep the newest turns that fit (drop oldest first, like the
        reference's history pruning)."""
        kept: list = []
        used = 0
        for item in reversed(list(history or [])):
            c = self.count_message(item)
            if used + c > budget:
                break
            kept.insert(0, item)
            used += c
        return kept

    def prune_documents(self, docs: Sequence[Document], budget: int) -> list:
        """Keep the top-ranked docs that fit (docs arrive ranked)."""
        kept: list = []
        used = 0
        for d in docs or []:
            c = self.count_message(d)
            if used + c > budget:
                break
            kept.append(d)
            used += c
        return kept

    def prune_inputs_to_token_limit(
        self, inputs: dict, *, unprunable: Sequence[str] = ("question",),
    ) -> dict:
        """Prune 'history' and document lists in a chain input dict to fit
        the budget after accounting for fixed fields."""
        fixed = sum(
            self.count(str(v)) for k, v in inputs.items()
            if k in unprunable and isinstance(v, str)
        )
        budget = max(self.budget - fixed, 128)
        out = dict(inputs)
        if "history" in out and out["history"]:
            out["history"] = self.prune_history(out["history"], budget // 2)
            budget -= sum(self.count_message(i) for i in out["history"])
        for key in ("retriever_output", "documents", "source_documents"):
            v = out.get(key)
            if isinstance(v, list) and v and isinstance(v[0], Document):
                out[key] = self.prune_documents(v, max(budget, 128))
        return out
