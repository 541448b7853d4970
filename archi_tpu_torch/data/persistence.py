"""PersistenceService: resource content → data dir + catalog row.

Copy of ``archi_tpu/data/persistence.py``.

Mirrors the reference's ``PersistenceService``
(``src/data_manager/collectors/persistence.py:15``): content is written
under ``data_path/<source_type>/<hash><ext>``, a catalog row maps the hash
to path + metadata, delete removes both.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.resource import Resource


class PersistenceService:
    def __init__(self, data_path: str, catalog: CatalogService):
        self.data_path = data_path
        self.catalog = catalog
        os.makedirs(data_path, exist_ok=True)

    def persist_resource(self, resource: Resource) -> str:
        """Write content + upsert catalog; returns the resource hash
        (reference persist_resource:24-67)."""
        h = resource.hash
        meta = resource.metadata
        sub = os.path.join(self.data_path, meta.source_type)
        os.makedirs(sub, exist_ok=True)
        ext = meta.extension or ".txt"
        path = os.path.join(sub, f"{h}{ext}")
        content = resource.content
        mode = "wb" if isinstance(content, bytes) else "w"
        kw = {} if isinstance(content, bytes) else {"encoding": "utf-8"}
        with open(path, mode, **kw) as f:
            f.write(content)
        self.catalog.upsert_resource(
            h,
            display_name=meta.display_name or meta.file_name or h[:12],
            source_type=meta.source_type,
            url=meta.url,
            file_path=path,
            metadata=meta.to_dict(),
            size_bytes=resource.size_bytes,
        )
        return h

    def read_content(self, resource_hash: str) -> Optional[str]:
        doc = self.catalog.get_document(resource_hash)
        if not doc or not doc.get("file_path"):
            return None
        try:
            with open(doc["file_path"], encoding="utf-8", errors="replace") as f:
                return f.read()
        except OSError:
            return None

    def delete_resource(self, resource_hash: str) -> bool:
        doc = self.catalog.get_document(resource_hash)
        if doc and doc.get("file_path") and os.path.exists(doc["file_path"]):
            os.remove(doc["file_path"])
        return self.catalog.delete_resource(resource_hash)

    def reset(self) -> None:
        """Drop all content + catalog rows (reference reset path)."""
        self.catalog.reset()
        if os.path.isdir(self.data_path):
            shutil.rmtree(self.data_path)
        os.makedirs(self.data_path, exist_ok=True)
