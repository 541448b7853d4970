"""DataViewerService: read APIs backing the /data UI.

Counterpart of ``archi_tpu/data/data_viewer.py``, over ``TorchVectorStore``.

Mirrors the reference's ``DataViewerService``
(``src/data_manager/data_viewer_service.py``, 213 LoC): grouped document
listings, per-document detail with its indexed chunks
(``catalog_postgres.get_document_chunks:1047`` analog — chunk texts come
from the vectorstore's row data here), content preview, and corpus stats.
"""

from __future__ import annotations

from typing import Optional

from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.manager import hash_of_chunk_id
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.engine.vectorstore import TorchVectorStore


class DataViewerService:
    def __init__(self, catalog: CatalogService,
                 persistence: PersistenceService,
                 vectorstore: TorchVectorStore):
        self.catalog = catalog
        self.persistence = persistence
        self.vectorstore = vectorstore

    def grouped_documents(self) -> dict:
        return self.catalog.list_documents_grouped()

    def document_detail(self, resource_hash: str,
                        *, content_preview: int = 2000) -> Optional[dict]:
        doc = self.catalog.get_document(resource_hash)
        if doc is None:
            return None
        content = self.persistence.read_content(resource_hash) or ""
        doc["content_preview"] = content[:content_preview]
        doc["content_length"] = len(content)
        doc["chunks"] = self.document_chunks(resource_hash)
        return doc

    def document_chunks(self, resource_hash: str) -> list[dict]:
        """The indexed chunks of a document (reference
        get_document_chunks:1047)."""
        out = []
        for cid, rows in self.vectorstore.index._id_rows.items():
            if hash_of_chunk_id(cid) != resource_hash:
                continue
            for row in rows:
                data = self.vectorstore._row_data.get(row)
                if data:
                    _c, text, meta = data
                    out.append({"chunk_id": cid, "row": row,
                                "text": text[:500],
                                "length": len(text)})
        out.sort(key=lambda c: c["chunk_id"])
        return out

    def stats(self) -> dict:
        return {
            **self.catalog.stats(),
            "chunks": self.vectorstore.count(),
            "bm25_terms": self.vectorstore.bm25.n_terms,
            "index_capacity": self.vectorstore.index.capacity,
            # the dtype's name as the JAX package reports it ("bfloat16",
            # not "torch.bfloat16")
            "index_dtype": str(self.vectorstore.index.dtype).removeprefix(
                "torch."),
        }
