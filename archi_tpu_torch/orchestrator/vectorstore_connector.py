"""VectorstoreConnector: builds the embedding model + the store handle.

Counterpart of ``archi_tpu/orchestrator/vectorstore_connector.py``, over
the port's ``resolve_embedder`` and ``TorchVectorStore``; the code is the
reference's.  As the reference's ``VectorstoreConnector``
(``src/archi/utils/vectorstore_connector.py:9-81``) it resolves the
embedding model from the config and returns a store per request.  The
store is process-resident (the index is stateful), so "per request"
returns the shared store; with none given it builds an empty one on the
card, as every entry point of the port does.
"""

from __future__ import annotations

from typing import Any, Optional

from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.models.registry import resolve_embedder


class VectorstoreConnector:
    def __init__(self, config: dict[str, Any] | None = None,
                 vectorstore: Optional[TorchVectorStore] = None):
        self.config = config or {}
        dm = self.config.get("data_manager", {})
        if vectorstore is not None:
            self._store = vectorstore
        else:
            embedder = resolve_embedder(dm)
            self._store = TorchVectorStore(
                embedder,
                collection_name=dm.get("collection_name", "default"),
            )

    def get_vectorstore(self) -> TorchVectorStore:
        return self._store
