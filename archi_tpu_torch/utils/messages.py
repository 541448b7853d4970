"""Copy of ``archi_tpu/utils/messages.py``.

Chat message containers — LangChain-message-compatible shape without the
dependency (reference passes ``BaseMessage`` lists through pipelines/agents,
``src/archi/utils/output_dataclass.py:22``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ToolCall:
    name: str
    args: dict[str, Any]
    id: str
    type: str = "tool_call"


@dataclasses.dataclass
class Message:
    role: str                      # system|user|assistant|tool
    content: str = ""
    tool_calls: list[ToolCall] = dataclasses.field(default_factory=list)
    tool_call_id: Optional[str] = None  # set on role="tool" results
    name: Optional[str] = None
    usage: dict[str, int] = dataclasses.field(default_factory=dict)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def system(content: str) -> Message:
    return Message("system", content)


def user(content: str) -> Message:
    return Message("user", content)


def assistant(content: str, **kw) -> Message:
    return Message("assistant", content, **kw)


def tool_result(tool_call_id: str, content: str, name: str = "") -> Message:
    return Message("tool", content, tool_call_id=tool_call_id, name=name)


def tuplize_history(history) -> list[tuple[str, str]]:
    """Normalize histories to (role, content) tuples (reference
    ``history_utils.tuplize_history``)."""
    out = []
    for item in history or []:
        if isinstance(item, Message):
            out.append((item.role, item.content))
        elif isinstance(item, dict):
            out.append((item.get("role", "user"),
                        item.get("content", "")))
        elif isinstance(item, (tuple, list)) and len(item) >= 2:
            out.append((str(item[0]), str(item[1])))
        else:
            out.append(("user", str(item)))
    return out
