"""Local-file collection: configured paths and uploaded files → resources.

Copy of ``archi_tpu/data/collectors/local_files.py``.

Mirrors the reference's ``LocalFileManager``
(``src/data_manager/collectors/localfile_manager.py:17``; uploads
``ingest_uploaded_file:50``).
"""

from __future__ import annotations

import os
from typing import Iterable

from archi_tpu_torch.data.loaders import supported_extensions
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata


class LocalFileManager:
    def __init__(self, persistence: PersistenceService):
        self.persistence = persistence

    def collect_path(self, path: str) -> list[str]:
        """Ingest a file or directory tree; returns resource hashes."""
        hashes = []
        exts = supported_extensions()
        if os.path.isfile(path):
            files: Iterable[str] = [path]
        else:
            files = (
                os.path.join(root, f)
                for root, _dirs, fs in os.walk(path)
                for f in fs
            )
        for f in files:
            ext = os.path.splitext(f)[1].lower()
            if ext not in exts and ext != "":
                continue
            try:
                with open(f, "rb") as fh:
                    content = fh.read()
            except OSError:
                continue
            meta = ResourceMetadata(
                display_name=os.path.basename(f),
                source_type="local_files",
                file_name=os.path.basename(f),
                extension=ext or ".txt",
                extra={"original_path": os.path.abspath(f)},
            )
            hashes.append(self.persistence.persist_resource(Resource(content, meta)))
        return hashes

    def ingest_uploaded_file(self, filename: str, content: bytes) -> str:
        """Upload API entry (reference ingest_uploaded_file:50)."""
        ext = os.path.splitext(filename)[1].lower() or ".txt"
        meta = ResourceMetadata(
            display_name=filename, source_type="local_files",
            file_name=filename, extension=ext, extra={"uploaded": True},
        )
        return self.persistence.persist_resource(Resource(content, meta))

    def collect_all_from_config(self, config: dict) -> list[str]:
        hashes = []
        for p in config.get("paths", []) or []:
            hashes.extend(self.collect_path(p))
        return hashes
