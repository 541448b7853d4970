"""PipelineOutput — the standard result container.

Copy of ``archi_tpu/orchestrator/output.py``.

Mirrors the reference's ``PipelineOutput``
(``src/archi/utils/output_dataclass.py:10-79``): answer, source_documents,
messages, metadata, ``final`` flag, dict-like access, and
``extract_tool_calls()`` normalization (ids matched to results, args backed
by ``metadata['tool_inputs_by_id']``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

from archi_tpu_torch.utils.documents import Document
from archi_tpu_torch.utils.messages import Message


@dataclasses.dataclass
class PipelineOutput:
    answer: str
    source_documents: list[Document] = dataclasses.field(default_factory=list)
    messages: list[Message] = dataclasses.field(default_factory=list)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    final: bool = True

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str) -> Any:
        return self.to_dict()[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.to_dict())

    def __len__(self) -> int:
        return len(self.to_dict())

    def get(self, key: str, default: Any = None) -> Any:
        return self.to_dict().get(key, default)

    def extract_tool_calls(self) -> list[dict[str, Any]]:
        tool_results: dict[str, Any] = {}
        tool_inputs_by_id = (self.metadata or {}).get("tool_inputs_by_id", {})
        for msg in self.messages:
            if msg.tool_call_id:
                tool_results[msg.tool_call_id] = msg.content

        calls: list[dict[str, Any]] = []
        for msg in self.messages:
            for call in msg.tool_calls or []:
                entry = {
                    "name": call.name,
                    "args": call.args,
                    "id": call.id,
                    "type": call.type,
                }
                if call.id and not entry.get("args"):
                    fallback = tool_inputs_by_id.get(call.id, {})
                    if isinstance(fallback, dict):
                        entry["args"] = fallback.get("tool_input",
                                                     entry.get("args"))
                        if not entry.get("name"):
                            entry["name"] = fallback.get("tool_name")
                if call.id in tool_results:
                    entry["result"] = tool_results[call.id]
                calls.append(entry)
        return calls
