"""Semantic top-k retriever with scores (reference
``src/data_manager/vectorstore/retrievers/semantic_retriever.py:12``; the
Qwen3-style instruction prefix lives in the embedder).

Counterpart of ``archi_tpu/retrievers/semantic.py``; the code is the
reference's.
"""

from __future__ import annotations

from archi_tpu_torch.retrievers.base import BaseRetriever


class SemanticRetriever(BaseRetriever):
    def _get_relevant_documents(self, query: str):
        return self.vectorstore.similarity_search_with_score(
            query, k=self.k, filter=self.metadata_filter,
            enabled_ids=self.enabled_ids,
        )
