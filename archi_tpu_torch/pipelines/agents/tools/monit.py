"""MONIT OpenSearch tools: Lucene search + aggregations over monitoring
indices.

Copy of ``archi_tpu/pipelines/agents/tools/monit.py``.

Mirrors the reference's MONIT tools
(``src/archi/pipelines/agents/tools/monit_opensearch.py:37,468,545``):
query-string search and terms/date-histogram aggregations against an
OpenSearch endpoint, formatted for agent consumption.  The HTTP transport is
injectable for tests/zero-egress runs.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from archi_tpu_torch.pipelines.agents.tools.base import Tool


def _default_post(url: str, payload: dict, *, auth=None, timeout=30.0):
    import requests

    r = requests.post(url, json=payload, auth=auth, timeout=timeout)
    r.raise_for_status()
    return r.json()


class MonitOpenSearchClient:
    def __init__(self, base_url: str, *, auth=None,
                 http_post: Callable = _default_post):
        self.base_url = base_url.rstrip("/")
        self.auth = auth
        self.http_post = http_post

    def search(self, index: str, query: str, *, size: int = 10,
               time_field: Optional[str] = None,
               time_range: Optional[tuple[str, str]] = None) -> dict:
        must: list[dict] = [{"query_string": {"query": query}}]
        if time_field and time_range:
            must.append({"range": {time_field: {
                "gte": time_range[0], "lte": time_range[1]}}})
        payload = {"size": size, "query": {"bool": {"must": must}},
                   "sort": [{"_score": "desc"}]}
        return self.http_post(f"{self.base_url}/{index}/_search", payload,
                              auth=self.auth)

    def aggregate(self, index: str, query: str, *, field: str,
                  agg_type: str = "terms", size: int = 10,
                  interval: str = "1h") -> dict:
        if agg_type == "terms":
            agg = {"result": {"terms": {"field": field, "size": size}}}
        elif agg_type == "date_histogram":
            agg = {"result": {"date_histogram": {
                "field": field, "fixed_interval": interval}}}
        else:
            raise ValueError(f"unsupported agg_type {agg_type}")
        payload = {"size": 0,
                   "query": {"query_string": {"query": query}},
                   "aggs": agg}
        return self.http_post(f"{self.base_url}/{index}/_search", payload,
                              auth=self.auth)


def _fmt_hits(resp: dict, max_chars: int = 4000) -> str:
    hits = (resp.get("hits") or {}).get("hits") or []
    if not hits:
        return "No hits."
    out = []
    for h in hits:
        src = json.dumps(h.get("_source", {}), default=str)[:500]
        out.append(f"[{h.get('_index')}] score={h.get('_score')}: {src}")
    return "\n".join(out)[:max_chars]


def create_monit_search_tool(client: MonitOpenSearchClient, **tool_kw) -> Tool:
    def _run(index: str, query: str, size: str = "10") -> str:
        resp = client.search(index, query, size=int(size))
        return _fmt_hits(resp)

    return Tool(
        name="monit_opensearch_search",
        description=("Search CERN MONIT OpenSearch indices with a Lucene "
                     "query string. Args: index pattern, query, size."),
        fn=_run,
        parameters={
            "type": "object",
            "properties": {
                "index": {"type": "string", "description": "index pattern"},
                "query": {"type": "string", "description": "Lucene query"},
                "size": {"type": "string", "description": "max hits"},
            },
            "required": ["index", "query"],
        },
        **tool_kw,
    )


def create_monit_agg_tool(client: MonitOpenSearchClient, **tool_kw) -> Tool:
    def _run(index: str, query: str, field: str,
             agg_type: str = "terms") -> str:
        resp = client.aggregate(index, query, field=field, agg_type=agg_type)
        buckets = (((resp.get("aggregations") or {}).get("result") or {})
                   .get("buckets") or [])
        if not buckets:
            return "No buckets."
        return "\n".join(
            f"{b.get('key_as_string', b.get('key'))}: {b.get('doc_count')}"
            for b in buckets
        )

    return Tool(
        name="monit_opensearch_aggregate",
        description=("Aggregate MONIT OpenSearch documents: terms or "
                     "date_histogram over a field, filtered by a Lucene "
                     "query."),
        fn=_run,
        parameters={
            "type": "object",
            "properties": {
                "index": {"type": "string"},
                "query": {"type": "string"},
                "field": {"type": "string"},
                "agg_type": {"type": "string",
                             "enum": ["terms", "date_histogram"]},
            },
            "required": ["index", "query", "field"],
        },
        **tool_kw,
    )
