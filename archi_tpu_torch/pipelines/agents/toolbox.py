"""Toolbox: spec tool names → Tool instances, and AgentSpec → live agent.

Copy of ``archi_tpu/pipelines/agents/toolbox.py``.

Closes the loop between the agents HTTP API (create/edit/select specs —
reference ``chat_app/app.py:2840-3111``) and chat execution: the
``active_agent`` dynamic-config key selects a spec whose frontmatter
``tools:`` list resolves here, the way the reference's
``CMSCompOpsAgent._tool_definitions`` (``cms_comp_ops_agent.py:85-150``)
assembles its registry — but driven by user-editable markdown instead of a
hardcoded subclass.

Known tool names:
- ``retriever`` — hybrid vector search over the live index (added
  automatically by BaseReActAgent when a vectorstore is injected; listing
  it in a spec is allowed and idempotent).
- ``file_search`` / ``metadata_search`` / ``metadata_schema`` /
  ``document_fetch`` — catalog tools (local or remote client).
- ``mcp:<server>`` — all tools of a configured MCP stdio server
  (``config["mcp_servers"][<server>]``).
- ``monit_search`` / ``monit_aggregate`` — MONIT OpenSearch (needs
  ``config["monit"]``).
"""

from __future__ import annotations

import logging
from typing import Optional

from archi_tpu_torch.pipelines.agents.agent_spec import AgentSpec
from archi_tpu_torch.pipelines.agents.base_react import BaseReActAgent
from archi_tpu_torch.pipelines.agents.tools.base import Tool

logger = logging.getLogger(__name__)


def resolve_tools(names: list[str], *, config: Optional[dict] = None,
                  catalog_client=None) -> list[Tool]:
    from archi_tpu_torch.pipelines.agents.tools import catalog_tools

    config = config or {}
    out: list[Tool] = []
    for name in names or []:
        if name == "retriever":
            continue  # injected by the agent itself with the vectorstore
        if name in ("file_search", "metadata_search", "metadata_schema",
                    "document_fetch"):
            if catalog_client is None:
                logger.warning("agent tool %s skipped: no catalog client",
                               name)
                continue
            factory = {
                "file_search": catalog_tools.create_file_search_tool,
                "metadata_search": catalog_tools.create_metadata_search_tool,
                "metadata_schema": catalog_tools.create_metadata_schema_tool,
                "document_fetch": catalog_tools.create_document_fetch_tool,
            }[name]
            out.append(factory(catalog_client))
        elif name.startswith("mcp:"):
            from archi_tpu_torch.pipelines.agents.mcp import initialize_mcp_tools

            server = name.split(":", 1)[1]
            spec = (config.get("mcp_servers") or {}).get(server)
            if not spec:
                logger.warning("agent tool %s skipped: server not configured",
                               name)
                continue
            out.extend(initialize_mcp_tools({server: spec}))
        elif name.startswith("monit"):
            monit_cfg = config.get("monit") or {}
            if not monit_cfg.get("url"):
                logger.warning("agent tool %s skipped: monit not configured",
                               name)
                continue
            from archi_tpu_torch.pipelines.agents.tools.monit import (
                MonitOpenSearchClient, create_monit_agg_tool,
                create_monit_search_tool,
            )

            client = MonitOpenSearchClient(monit_cfg["url"],
                                           auth=monit_cfg.get("auth"))
            if name in ("monit", "monit_search"):
                out.append(create_monit_search_tool(client))
            if name in ("monit", "monit_aggregate"):
                out.append(create_monit_agg_tool(client))
        else:
            logger.warning("unknown agent tool %r skipped", name)
    return out


def agent_from_spec(spec: AgentSpec, config: Optional[dict] = None, *,
                    catalog_client=None,
                    session_permissions=None) -> BaseReActAgent:
    """AgentSpec → configured BaseReActAgent (prompt, tools, model)."""
    config = dict(config or {})
    if spec.model:
        # per-agent model override rides the pipeline config
        pipelines = dict(config.get("pipelines") or {})
        agent_cfg = dict(pipelines.get("BaseReActAgent") or {})
        models = dict(agent_cfg.get("models") or {})
        models["agent_model"] = spec.model
        agent_cfg["models"] = models
        pipelines["BaseReActAgent"] = agent_cfg
        config["pipelines"] = pipelines
    tools = resolve_tools(spec.tools, config=config,
                          catalog_client=catalog_client)
    return BaseReActAgent(
        config, tools=tools, system_prompt=spec.prompt or None,
        session_permissions=session_permissions,
    )
