"""RunMemory: per-run accumulator of documents, tool calls, and notes.

Copy of ``archi_tpu/pipelines/agents/run_memory.py``.

Mirrors the reference's ``RunMemory``
(``src/archi/pipelines/agents/utils/run_memory.py:11``): retrieved documents
dedup'd by content hash (``unique_documents:174``), tool inputs by call id
(``tool_inputs_by_id:194``), and free-form notes, all feeding the final
``PipelineOutput.metadata``.
"""

from __future__ import annotations

import hashlib
from typing import Any

from archi_tpu_torch.utils.documents import Document


class RunMemory:
    def __init__(self):
        self._documents: list[tuple[Document, float]] = []
        self._tool_calls: list[dict[str, Any]] = []
        self._notes: list[str] = []
        self.usage = {"input_tokens": 0, "output_tokens": 0}
        self.steps = 0

    # -------------------------------------------------------------- documents
    def add_documents(self, docs_with_scores) -> None:
        for item in docs_with_scores or []:
            if isinstance(item, tuple):
                self._documents.append((item[0], float(item[1])))
            else:
                self._documents.append((item, 0.0))

    @staticmethod
    def _doc_key(doc: Document) -> str:
        return hashlib.sha1(doc.page_content.encode()).hexdigest()

    def unique_documents(self) -> list[tuple[Document, float]]:
        """Dedup by content, keep best score (reference unique_documents:174)."""
        best: dict[str, tuple[Document, float]] = {}
        order: list[str] = []
        for doc, score in self._documents:
            k = self._doc_key(doc)
            if k not in best:
                best[k] = (doc, score)
                order.append(k)
            elif score > best[k][1]:
                best[k] = (doc, score)
        return [best[k] for k in order]

    # ------------------------------------------------------------- tool calls
    def record_tool_call(self, call_id: str, name: str, args: Any,
                         result: str = "") -> None:
        self._tool_calls.append({
            "id": call_id, "tool_name": name, "tool_input": args,
            "result": result,
        })

    def tool_inputs_by_id(self) -> dict[str, dict]:
        return {c["id"]: {"tool_name": c["tool_name"],
                          "tool_input": c["tool_input"]}
                for c in self._tool_calls}

    @property
    def tool_calls(self) -> list[dict[str, Any]]:
        return list(self._tool_calls)

    # ------------------------------------------------------------------ notes
    def add_note(self, note: str) -> None:
        self._notes.append(note)

    @property
    def notes(self) -> list[str]:
        return list(self._notes)

    def add_usage(self, usage: dict[str, int]) -> None:
        for k in ("input_tokens", "output_tokens"):
            self.usage[k] += int(usage.get(k, 0) or 0)
