"""Plain top-k retriever without scores (reference
``src/data_manager/vectorstore/retrievers/grading_retriever.py:11``).

Counterpart of ``archi_tpu/retrievers/grading.py``; the code is the
reference's.
"""

from __future__ import annotations

from archi_tpu_torch.retrievers.base import BaseRetriever


class GradingRetriever(BaseRetriever):
    def _get_relevant_documents(self, query: str):
        return self.vectorstore.similarity_search(
            query, k=self.k, filter=self.metadata_filter,
            enabled_ids=self.enabled_ids,
        )
