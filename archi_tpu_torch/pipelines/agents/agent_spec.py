"""AgentSpec: markdown-with-YAML-frontmatter agent definitions.

Copy of ``archi_tpu/pipelines/agents/agent_spec.py``.

Mirrors the reference's ``AgentSpec``
(``src/archi/pipelines/agents/agent_spec.py:10-113``; example spec
``examples/agents/cms-comp-ops.md``): name/description/tools in frontmatter,
the prompt body below; discovery over a directory; selection by name.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class AgentSpec:
    name: str
    description: str = ""
    tools: list[str] = dataclasses.field(default_factory=list)
    prompt: str = ""
    model: Optional[str] = None
    source_path: Optional[str] = None

    @classmethod
    def from_markdown(cls, text: str,
                      source_path: Optional[str] = None) -> "AgentSpec":
        meta: dict = {}
        body = text
        if text.startswith("---"):
            parts = text.split("---", 2)
            if len(parts) >= 3:
                import yaml

                meta = yaml.safe_load(parts[1]) or {}
                body = parts[2]
        tools = meta.get("tools") or []
        if isinstance(tools, str):
            tools = [t.strip() for t in tools.split(",") if t.strip()]
        return cls(
            name=meta.get("name") or
            (os.path.splitext(os.path.basename(source_path))[0]
             if source_path else "agent"),
            description=meta.get("description", ""),
            tools=tools,
            prompt=body.strip(),
            model=meta.get("model"),
            source_path=source_path,
        )

    @classmethod
    def from_file(cls, path: str) -> "AgentSpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_markdown(f.read(), source_path=path)

    @classmethod
    def discover(cls, directory: str) -> dict[str, "AgentSpec"]:
        specs = {}
        if not os.path.isdir(directory):
            return specs
        for f in sorted(os.listdir(directory)):
            if f.endswith(".md"):
                spec = cls.from_file(os.path.join(directory, f))
                specs[spec.name] = spec
        return specs

    def to_markdown(self) -> str:
        import yaml

        front = {"name": self.name, "description": self.description,
                 "tools": self.tools}
        if self.model:
            front["model"] = self.model
        return f"---\n{yaml.safe_dump(front)}---\n\n{self.prompt}\n"


AGENT_TEMPLATE = """---
name: my-agent
description: One-line purpose of this agent.
tools: [retriever]
# model: openai/gpt-4o        # optional per-agent model override
---

You are a helpful assistant for <domain>. Use the available tools to
ground every answer in retrieved documents, and cite your sources.
"""


class AgentStore:
    """Directory-backed agent registry with CRUD — the storage behind the
    chat app's agents HTTP API (reference agents CRUD
    ``src/interfaces/chat_app/app.py:2840-3111`` and agent template/save
    ``chat_app/api.py:815,835``).  Specs are markdown files so they remain
    hand-editable and versionable, like the reference's ``examples/agents``.
    """

    _NAME_RE = __import__("re").compile(r"^[a-zA-Z0-9][a-zA-Z0-9._-]{0,63}$")

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        if not self._NAME_RE.match(name):
            raise ValueError(f"invalid agent name: {name!r}")
        return os.path.join(self.directory, f"{name}.md")

    def list(self) -> list[AgentSpec]:
        return list(AgentSpec.discover(self.directory).values())

    def get(self, name: str) -> Optional[AgentSpec]:
        path = self._path(name)
        return AgentSpec.from_file(path) if os.path.isfile(path) else None

    def save(self, spec: AgentSpec) -> AgentSpec:
        path = self._path(spec.name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(spec.to_markdown())
        spec.source_path = path
        return spec

    def save_markdown(self, text: str) -> AgentSpec:
        """Save a raw markdown spec (the /api/v2/agent/save analog)."""
        spec = AgentSpec.from_markdown(text)
        if not spec.name or not spec.prompt:
            raise ValueError("agent spec needs a name and a prompt body")
        return self.save(spec)

    def delete(self, name: str) -> bool:
        path = self._path(name)
        if os.path.isfile(path):
            os.remove(path)
            return True
        return False

    @staticmethod
    def template() -> str:
        return AGENT_TEMPLATE
