"""The retrievers over the port's store.

Counterpart of ``archi_tpu/retrievers/__init__.py``; the code is the
reference's.
"""

from archi_tpu_torch.retrievers.base import BaseRetriever
from archi_tpu_torch.retrievers.semantic import SemanticRetriever
from archi_tpu_torch.retrievers.hybrid import HybridRetriever
from archi_tpu_torch.retrievers.grading import GradingRetriever

__all__ = [
    "BaseRetriever", "SemanticRetriever", "HybridRetriever",
    "GradingRetriever",
]
