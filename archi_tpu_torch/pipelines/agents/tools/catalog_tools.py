"""Catalog-backed agent tools: grep search, metadata search/schema, doc fetch.

Copy of ``archi_tpu/pipelines/agents/tools/catalog_tools.py``.

Mirrors the reference's local-files tool family
(``src/archi/pipelines/agents/tools/local_files.py``): a catalog client
(remote HTTP in the reference, ``RemoteCatalogClient:22``; direct or HTTP
here), grep-like content search (``create_file_search_tool:208``), metadata
search (``:327``), metadata schema (``:410``), and full-document fetch
(``:455``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.pipelines.agents.tools.base import Tool, simple_params


class CatalogClient:
    """Direct (in-process) catalog access with the same surface as the
    HTTP ``RemoteCatalogClient`` (search / get_document / schema)."""

    def __init__(self, catalog: CatalogService,
                 persistence: PersistenceService):
        self.catalog = catalog
        self.persistence = persistence

    def search_metadata(self, query: str, limit: int = 20) -> list[dict]:
        return self.catalog.search_documents(query, limit=limit)

    def grep(self, pattern: str, *, max_files: int = 200,
             max_matches: int = 50, context_chars: int = 200) -> list[dict]:
        try:
            rx = re.compile(pattern, re.I)
        except re.error as e:
            raise ValueError(f"bad regex: {e}") from e
        out = []
        for doc in self.catalog.list_documents(limit=max_files):
            text = self.persistence.read_content(doc["resource_hash"]) or ""
            for m in rx.finditer(text):
                s = max(m.start() - context_chars // 2, 0)
                out.append({
                    "resource_hash": doc["resource_hash"],
                    "display_name": doc["display_name"],
                    "snippet": text[s: s + context_chars],
                })
                if len(out) >= max_matches:
                    return out
        return out

    def get_document(self, resource_hash: str,
                     max_chars: int = 20000) -> Optional[str]:
        text = self.persistence.read_content(resource_hash)
        return text[:max_chars] if text else None

    def schema(self) -> dict:
        """Available metadata keys + example values (reference :410)."""
        keys: dict[str, set] = {}
        for doc in self.catalog.list_documents(limit=200):
            for k, v in (doc.get("metadata") or {}).items():
                if isinstance(v, (str, int, float)):
                    keys.setdefault(k, set())
                    if len(keys[k]) < 5:
                        keys[k].add(str(v))
        return {k: sorted(v) for k, v in keys.items()}


class RemoteCatalogClient:
    """HTTP client to a data-manager service exposing the catalog API
    (reference ``local_files.py:22``; endpoints ``uploader_app/app.py:449``)."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 auth_token: str | None = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # shared-secret gate on the data app (DATA_MANAGER_TOKEN); defaults
        # from env so agent tools inside the chat process keep working when
        # the deployment locks the data service down
        self._headers = {}
        token = auth_token or os.environ.get("DATA_MANAGER_TOKEN")
        if token:
            self._headers["x-data-token"] = token

    def _get(self, path: str, **params):
        import requests

        r = requests.get(f"{self.base_url}{path}", params=params,
                         headers=self._headers, timeout=self.timeout)
        r.raise_for_status()
        return r.json()

    def search_metadata(self, query: str, limit: int = 20):
        return self._get("/api/catalog/search", q=query, limit=limit)

    def grep(self, pattern: str, **kw):
        return self._get("/api/catalog/grep", pattern=pattern)

    def get_document(self, resource_hash: str, max_chars: int = 20000):
        data = self._get(f"/api/catalog/document/{resource_hash}")
        return (data or {}).get("content", "")[:max_chars]

    def schema(self):
        return self._get("/api/catalog/schema")


# ------------------------------------------------------------------- tools
def create_file_search_tool(client, **tool_kw) -> Tool:
    def _run(pattern: str) -> str:
        hits = client.grep(pattern)
        if not hits:
            return "No matches."
        return "\n\n".join(
            f"{h['display_name']} ({h['resource_hash'][:12]}):\n{h['snippet']}"
            for h in hits[:25]
        )

    return Tool(
        name="search_file_contents",
        description=("Regex (grep-like) search over the raw contents of all "
                     "catalogued documents. Input: a regular expression."),
        fn=_run,
        parameters=simple_params(pattern="regular expression to search for"),
        **tool_kw,
    )


def create_metadata_search_tool(client, **tool_kw) -> Tool:
    def _run(query: str) -> str:
        docs = client.search_metadata(query)
        if not docs:
            return "No documents matched."
        return "\n".join(
            f"- {d['display_name']} [{d['source_type']}] "
            f"hash={d['resource_hash'][:12]} url={d.get('url') or '-'}"
            for d in docs
        )

    return Tool(
        name="search_document_metadata",
        description=("Search the document catalog by name/url/metadata "
                     "substring. Returns matching documents with hashes."),
        fn=_run,
        parameters=simple_params(query="substring to search metadata for"),
        **tool_kw,
    )


def create_metadata_schema_tool(client, **tool_kw) -> Tool:
    def _run() -> str:
        import json

        return json.dumps(client.schema(), indent=2)

    return Tool(
        name="get_metadata_schema",
        description="List available document metadata keys and example values.",
        fn=_run,
        parameters={"type": "object", "properties": {}},
        **tool_kw,
    )


def create_document_fetch_tool(client, **tool_kw) -> Tool:
    def _run(resource_hash: str) -> str:
        text = client.get_document(resource_hash)
        return text if text else f"Document {resource_hash!r} not found."

    return Tool(
        name="fetch_document",
        description=("Fetch the full text of a catalogued document by its "
                     "resource hash (from search results)."),
        fn=_run,
        parameters=simple_params(resource_hash="document resource hash"),
        **tool_kw,
    )
