"""CMSCompOpsAgent: the concrete ops-support agent with the full tool
registry.

Copy of ``archi_tpu/pipelines/agents/comp_ops.py``.

Mirrors the reference's ``CMSCompOpsAgent``
(``src/archi/pipelines/agents/cms_comp_ops_agent.py:27``;
``_tool_definitions:85-150``, ``_update_vector_retrievers:218``): hybrid
vector search + grep file search + metadata search/schema + document fetch
+ MONIT OpenSearch search/aggregate (+ optional MCP tools), assembled per
request around a fresh vectorstore.
"""

from __future__ import annotations

from typing import Optional

from archi_tpu_torch.pipelines.agents.base_react import BaseReActAgent
from archi_tpu_torch.pipelines.agents.tools.catalog_tools import (
    CatalogClient, create_document_fetch_tool, create_file_search_tool,
    create_metadata_schema_tool, create_metadata_search_tool,
)
from archi_tpu_torch.pipelines.agents.tools.monit import (
    MonitOpenSearchClient, create_monit_agg_tool, create_monit_search_tool,
)
from archi_tpu_torch.pipelines.agents.tools.retriever import create_retriever_tool

COMP_OPS_PROMPT = (
    "You are a computing-operations support assistant. You help operators "
    "diagnose issues using the documentation corpus, the raw document "
    "catalog, and monitoring data. Always search before answering, prefer "
    "primary sources, and cite the documents or monitoring queries you "
    "used."
)


class CMSCompOpsAgent(BaseReActAgent):
    def __init__(self, config: Optional[dict] = None, *,
                 catalog_client: Optional[CatalogClient] = None,
                 monit_client: Optional[MonitOpenSearchClient] = None,
                 **kw):
        self.catalog_client = catalog_client
        self.monit_client = monit_client
        kw.setdefault("system_prompt", COMP_OPS_PROMPT)
        super().__init__(config, **kw)

    def _tool_definitions(self, vectorstore=None):
        tools = list(self._extra_tools)
        if vectorstore is not None:
            self.update_retriever(vectorstore, self._enabled_ids)
            tools.append(create_retriever_tool(
                self.retriever, run_memory=self.run_memory,
            ))
        if self.catalog_client is not None:
            tools += [
                create_file_search_tool(self.catalog_client),
                create_metadata_search_tool(self.catalog_client),
                create_metadata_schema_tool(self.catalog_client),
                create_document_fetch_tool(self.catalog_client),
            ]
        if self.monit_client is not None:
            tools += [
                create_monit_search_tool(self.monit_client),
                create_monit_agg_tool(self.monit_client),
            ]
        return tools
