"""Retriever-as-tool: wrap a retriever for agent use.

Copy of ``archi_tpu/pipelines/agents/tools/retriever.py``.

Mirrors the reference's ``create_retriever_tool``
(``src/archi/pipelines/agents/tools/retriever.py:62``): top-k snippets
formatted with source + hash + score, results recorded into RunMemory.
"""

from __future__ import annotations

from typing import Optional

from archi_tpu_torch.pipelines.agents.run_memory import RunMemory
from archi_tpu_torch.pipelines.agents.tools.base import Tool, simple_params


def format_snippets(results) -> str:
    if not results:
        return "No documents found."
    lines = []
    for i, item in enumerate(results):
        doc, score = item if isinstance(item, tuple) else (item, 0.0)
        md = doc.metadata or {}
        src = md.get("display_name") or md.get("url") or md.get(
            "source_type", "unknown")
        h = (md.get("resource_hash") or md.get("chunk_id") or "")[:12]
        lines.append(
            f"[{i + 1}] source={src} hash={h} score={score:.4f}\n"
            f"{doc.page_content[:1500]}"
        )
    return "\n\n".join(lines)


def create_retriever_tool(
    retriever,
    *,
    name: str = "search_vectorstore_hybrid",
    description: str = (
        "Search the document corpus with hybrid (keyword + semantic) "
        "retrieval. Input: a natural-language query. Returns the top "
        "matching snippets with their sources."
    ),
    run_memory: Optional[RunMemory] = None,
    required_permission: Optional[str] = None,
) -> Tool:
    def _run(query: str) -> str:
        results = retriever.invoke(query)
        if run_memory is not None:
            run_memory.add_documents(results)
        return format_snippets(results)

    return Tool(
        name=name,
        description=description,
        fn=_run,
        parameters=simple_params(query="natural-language search query"),
        required_permission=required_permission,
    )
