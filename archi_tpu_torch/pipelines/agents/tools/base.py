"""Tool contract + RBAC gating.

Copy of ``archi_tpu/pipelines/agents/tools/base.py``.

Mirrors the reference's tool base + permission decorators
(``src/archi/pipelines/agents/tools/base.py:19,85``
``check_tool_permission``/``require_tool_permission``): a tool may declare a
required permission; execution checks the session's roles before running.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Optional


class ToolPermissionError(PermissionError):
    pass


@dataclasses.dataclass
class Tool:
    name: str
    description: str
    fn: Callable[..., str]
    parameters: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "object", "properties": {}}
    )
    required_permission: Optional[str] = None

    def schema(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": self.parameters,
        }

    def run(self, args: dict[str, Any],
            session_permissions: Optional[set[str]] = None) -> str:
        check_tool_permission(self, session_permissions)
        try:
            result = self.fn(**(args or {}))
        except TypeError as e:
            return f"Tool argument error: {e}"
        except Exception as e:
            return f"Tool error: {type(e).__name__}: {e}"
        if isinstance(result, str):
            return result
        return json.dumps(result, default=str)


def check_tool_permission(tool: Tool,
                          session_permissions: Optional[set[str]]) -> None:
    """Raise when the tool needs a permission the session lacks (reference
    check_tool_permission/require_tool_permission)."""
    if tool.required_permission is None:
        return
    if session_permissions is None:
        return  # no RBAC context configured → permissive (reference default)
    if tool.required_permission not in session_permissions:
        raise ToolPermissionError(
            f"tool {tool.name!r} requires permission "
            f"{tool.required_permission!r}"
        )


def simple_params(**props: str) -> dict:
    """Shorthand: keyword → description builds a string-typed JSON schema."""
    return {
        "type": "object",
        "properties": {k: {"type": "string", "description": v}
                       for k, v in props.items()},
        "required": list(props),
    }
