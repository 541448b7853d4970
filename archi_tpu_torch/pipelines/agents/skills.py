"""Agent skills: markdown context files appended to tool descriptions.

Copy of ``archi_tpu/pipelines/agents/skills.py``.

Mirrors the reference's skill loader
(``src/archi/pipelines/agents/utils/skill_utils.py:32``): a skills directory
of markdown files; each skill names the tool(s) it augments via frontmatter
and its body is appended to those tools' descriptions.
"""

from __future__ import annotations

import os

from archi_tpu_torch.pipelines.agents.agent_spec import AgentSpec
from archi_tpu_torch.pipelines.agents.tools.base import Tool


def load_skills(directory: str) -> list[AgentSpec]:
    """Skill files share the AgentSpec markdown format; ``tools`` lists the
    tools the skill's body augments."""
    out = []
    if not os.path.isdir(directory):
        return out
    for f in sorted(os.listdir(directory)):
        if f.endswith(".md"):
            out.append(AgentSpec.from_file(os.path.join(directory, f)))
    return out


def apply_skills(tools: list[Tool], skills: list[AgentSpec]) -> list[Tool]:
    by_name = {t.name: t for t in tools}
    for skill in skills:
        targets = skill.tools or list(by_name)
        for name in targets:
            t = by_name.get(name)
            if t is not None and skill.prompt:
                t.description = (
                    f"{t.description}\n\nUsage notes ({skill.name}):\n"
                    f"{skill.prompt}"
                )
    return tools
