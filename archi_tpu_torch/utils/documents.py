"""Document container — LangChain-compatible shape without the dependency.

Copy of ``archi_tpu/utils/documents.py``.

The reference returns ``langchain_core.documents.Document`` objects
(``src/data_manager/vectorstore/postgres_vectorstore.py:272-364``).  This
dataclass carries the same two fields and supports dict-style metadata use so
pipelines/retrievers stay drop-in-shaped.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Document:
    page_content: str
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # keep logs short
        head = self.page_content[:60].replace("\n", " ")
        return f"Document(page_content={head!r}..., metadata={self.metadata})"
