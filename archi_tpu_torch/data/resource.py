"""Resource contract: every ingested item is content + metadata + a stable
content hash.

Copy of ``archi_tpu/data/resource.py``.

Mirrors the reference's ``BaseResource`` ABC
(``src/data_manager/collectors/resource_base.py:8``) and ``ResourceMetadata``
(``src/data_manager/collectors/utils/metadata.py:24``): the SHA-256 of the
content is the identity used for diff-based sync, so re-ingesting unchanged
content is a no-op and edits show up as remove+add.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Optional


@dataclasses.dataclass
class ResourceMetadata:
    display_name: str = ""
    source_type: str = "local_files"   # local_files|links|git|jira|redmine|sso
    url: Optional[str] = None
    file_name: Optional[str] = None
    extension: str = ".txt"
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    collected_at: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ResourceMetadata":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Resource:
    """One ingestable item (a file, page, ticket, ...)."""

    def __init__(self, content: str | bytes, metadata: ResourceMetadata):
        self._content = content
        self.metadata = metadata

    @property
    def content(self) -> str | bytes:
        return self._content

    @property
    def text(self) -> str:
        c = self._content
        return c.decode("utf-8", errors="replace") if isinstance(c, bytes) else c

    @property
    def hash(self) -> str:
        """Stable content identity (reference: resource_base.py hash contract)."""
        c = self._content
        raw = c if isinstance(c, bytes) else c.encode("utf-8")
        return hashlib.sha256(raw).hexdigest()

    @property
    def size_bytes(self) -> int:
        c = self._content
        return len(c) if isinstance(c, bytes) else len(c.encode("utf-8"))
