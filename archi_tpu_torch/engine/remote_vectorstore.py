"""RemoteVectorStore: the store's query surface over HTTP, on ``urllib``.

Counterpart of ``archi_tpu/engine/remote_vectorstore.py``.  One process
(the data-manager service) owns the index on the card and serves its query
routes (``web/data_app.py`` ``/api/query/*``); the chat process queries
through this client, which has the retriever-facing surface of
``TorchVectorStore`` (hybrid_search / similarity_search_with_score /
count).  Queries are embedded by the service.  Writes go through the
data-manager's ingestion API, not here.

The methods, payloads, the ``x-data-token`` header and the timeout are the
JAX package's.  The transport is the standard library's ``urllib.request``
(the JAX package posts with ``requests``, which the card's machine lacks):
an HTTP error status raises ``urllib.error.HTTPError`` where the JAX
package raises ``requests.HTTPError``; both are an ``Exception``, so
``HybridRetriever``'s semantic fallback takes either.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional, Sequence

from archi_tpu_torch.utils.documents import Document


class RemoteVectorStore:
    def __init__(self, base_url: str, *, timeout: float = 600.0,
                 auth_token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._headers = {"x-data-token": auth_token} if auth_token else {}

    def _request(self, path: str, payload: Optional[dict] = None):
        """GET ``path`` (no payload) or POST ``payload`` as JSON → the
        decoded JSON body; an error status raises ``HTTPError``."""
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(f"{self.base_url}{path}", data=data,
                                     headers=dict(self._headers))
        if data is not None:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    @staticmethod
    def _to_results(data) -> list[tuple[Document, float]]:
        return [
            (Document(page_content=d["page_content"],
                      metadata=d.get("metadata") or {}),
             float(d.get("score", 0.0)))
            for d in data
        ]

    # ------------------------------------------------------ query interface
    def hybrid_search(self, query: str, k: int = 4, *,
                      semantic_weight: float = 0.7, bm25_weight: float = 0.3,
                      filter: Optional[dict] = None,
                      enabled_ids: Optional[set] = None):
        data = self._request("/api/query/hybrid", {
            "query": query, "k": k,
            "semantic_weight": semantic_weight,
            "bm25_weight": bm25_weight,
            "filter": filter,
            "enabled_ids": sorted(enabled_ids) if enabled_ids else None,
        })
        return self._to_results(data)

    def similarity_search_with_score(self, query: str, k: int = 4, *,
                                     filter: Optional[dict] = None,
                                     enabled_ids: Optional[set] = None):
        data = self._request("/api/query/semantic", {
            "query": query, "k": k, "filter": filter,
            "enabled_ids": sorted(enabled_ids) if enabled_ids else None,
        })
        return self._to_results(data)

    def similarity_search(self, query: str, k: int = 4, **kw):
        return [d for d, _s in
                self.similarity_search_with_score(query, k, **kw)]

    def count(self) -> int:
        return int(self._request("/api/query/count")["count"])

    def warmup(self) -> None:
        try:
            self.count()
        except Exception:
            pass

    # writes are the data-manager's job
    def add_texts(self, texts: Sequence[str], *a, **kw):
        raise NotImplementedError(
            "RemoteVectorStore is read-only; ingest via the data-manager API"
        )

    def delete(self, *a, **kw):
        raise NotImplementedError(
            "RemoteVectorStore is read-only; delete via the data-manager API"
        )
