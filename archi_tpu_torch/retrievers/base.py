"""Retriever contract over the port's store.

Counterpart of ``archi_tpu/retrievers/base.py``, over ``TorchVectorStore``
(or any object with its query surface, as ``RemoteVectorStore``); the code
is the reference's.  As in the reference's LangChain ``BaseRetriever``
shape (``src/data_manager/vectorstore/retrievers/``), ``invoke(query)``
returns (Document, score) tuples (or bare Documents for the grading
variant).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from archi_tpu_torch.engine.vectorstore import TorchVectorStore


class BaseRetriever(ABC):
    def __init__(self, vectorstore: TorchVectorStore, *, k: int = 5,
                 metadata_filter: Optional[dict] = None,
                 enabled_ids: Optional[set] = None):
        self.vectorstore = vectorstore
        self.k = k
        self.metadata_filter = metadata_filter
        self.enabled_ids = enabled_ids

    @abstractmethod
    def _get_relevant_documents(self, query: str):
        ...

    def invoke(self, query: str):
        return self._get_relevant_documents(query)

    def __call__(self, query: str):
        return self.invoke(query)
