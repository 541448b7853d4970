"""Hybrid (BM25 + semantic) retriever (reference
``src/data_manager/vectorstore/retrievers/hybrid_retriever.py:20``): weights
configurable, semantic fallback on lexical miss or engine error.

Counterpart of ``archi_tpu/retrievers/hybrid.py``; the code is the
reference's.
"""

from __future__ import annotations

import logging

from archi_tpu_torch.retrievers.base import BaseRetriever

logger = logging.getLogger(__name__)


class HybridRetriever(BaseRetriever):
    def __init__(self, vectorstore, *, k: int = 5, bm25_weight: float = 0.6,
                 semantic_weight: float = 0.4, **kw):
        super().__init__(vectorstore, k=k, **kw)
        self.bm25_weight = bm25_weight
        self.semantic_weight = semantic_weight

    def _get_relevant_documents(self, query: str):
        try:
            return self.vectorstore.hybrid_search(
                query, k=self.k,
                semantic_weight=self.semantic_weight,
                bm25_weight=self.bm25_weight,
                filter=self.metadata_filter,
                enabled_ids=self.enabled_ids,
            )
        except Exception as e:
            logger.warning("hybrid search failed (%s); semantic fallback", e)
            return self.vectorstore.similarity_search_with_score(
                query, k=self.k, filter=self.metadata_filter,
                enabled_ids=self.enabled_ids,
            )
