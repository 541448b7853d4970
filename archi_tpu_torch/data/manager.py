"""IndexManager — diff-based sync of the catalog into the port's store.

Counterpart of ``archi_tpu/data/manager.py``, over ``TorchVectorStore``;
the code is the reference's.

The analog of the reference's ``VectorStoreManager``
(``src/data_manager/vectorstore/manager.py:23``): it owns chunking + the
embedding model + the sync algorithm.  Semantics preserved from
``update_vectorstore:177-214``:

- **diff sync**: set(catalog hashes) vs set(hashes in the vectorstore) —
  stale hashes are removed (``_remove_from_postgres:234``), missing ones are
  parsed → chunked → embedded → inserted (``_add_to_postgres:253``).  A
  crashed ingest is resumable by construction: rerun only embeds what's
  missing.
- **per-file fault isolation**: one unparseable/failing file must not poison
  the batch (reference SAVEPOINT-per-file, ``manager.py:370-443``); here the
  parse step is try/excepted per file and a failing merged embed batch
  retries per file to find the culprit.
- **status machine**: pending → embedding → embedded|failed with stored
  error (``catalog_postgres.py:722``).
- **bounded lost work**: insert-and-commit every ``batch_files`` files
  (reference commits every 25, ``manager.py:257,446``).

As in the JAX package, chunks from many files are embedded in ONE merged
batch (the reference embeds file-by-file, ``manager.py:373``): larger
encoder batches on the card, the same isolation.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.chunking import character_split
from archi_tpu_torch.data.loaders import load_text
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.engine.vectorstore import TorchVectorStore

logger = logging.getLogger(__name__)


def chunk_id(resource_hash: str, i: int) -> str:
    return f"{resource_hash}:{i}"


def hash_of_chunk_id(cid: str) -> str:
    return cid.rsplit(":", 1)[0]


class IndexManager:
    def __init__(
        self,
        catalog: CatalogService,
        persistence: PersistenceService,
        vectorstore: TorchVectorStore,
        *,
        chunk_size: int = 1000,
        chunk_overlap: int = 0,
        batch_files: int = 25,
        parallel_workers: int = 32,
    ):
        self.catalog = catalog
        self.persistence = persistence
        self.vectorstore = vectorstore
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.batch_files = batch_files
        # reference caps its parse ThreadPool at 64 (manager.py:86-99)
        self.parallel_workers = max(1, min(int(parallel_workers), 64))
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ sync
    def store_hashes(self) -> set[str]:
        return {hash_of_chunk_id(c) for c in self.vectorstore.ids()}

    def update_vectorstore(self) -> dict:
        """One sync pass; returns counters (added/removed/failed)."""
        with self._lock:
            catalog_hashes = self.catalog.all_hashes()
            present = self.store_hashes()
            stale = present - catalog_hashes
            # failed docs stay failed until an explicit retry (reference
            # semantics: retry endpoints flip failed→pending first)
            failed_hashes = {d["resource_hash"] for d in self.catalog.get_failed()}
            missing = catalog_hashes - present - failed_hashes
            if stale:
                self._remove_hashes(stale)
            added, failed = self._add_hashes(sorted(missing))
            return {
                "added": added,
                "removed": len(stale),
                "failed": failed,
                "total_chunks": self.vectorstore.count(),
            }

    def _remove_hashes(self, hashes: Sequence[str]) -> None:
        ids = [c for c in self.vectorstore.ids()
               if hash_of_chunk_id(c) in set(hashes)]
        if ids:
            self.vectorstore.delete(ids)
        logger.info("removed %d stale resources (%d chunks)", len(hashes), len(ids))

    # ------------------------------------------------------------------- add
    def _parse_and_chunk(self, resource_hash: str) -> Optional[list[str]]:
        """File → chunks; None marks failure (status already written)."""
        doc = self.catalog.get_document(resource_hash)
        if doc is None:
            return None
        try:
            path = doc.get("file_path")
            if path:
                text = load_text(path)
            else:
                text = self.persistence.read_content(resource_hash) or ""
            if not text.strip():
                raise ValueError("empty document")
            return character_split(
                text, self.chunk_size, self.chunk_overlap
            )
        except Exception as e:  # per-file isolation
            logger.warning("parse failed for %s: %s", resource_hash[:12], e)
            self.catalog.update_ingestion_status(
                resource_hash, "failed", f"parse: {e}"
            )
            return None

    def _insert_batch(self, batch: list[tuple[str, list[str], dict]]) -> int:
        """Embed+insert a merged multi-file batch; per-file retry on failure."""
        texts, ids, metas = [], [], []
        for h, chunks, meta in batch:
            for i, c in enumerate(chunks):
                texts.append(c)
                ids.append(chunk_id(h, i))
                metas.append(meta)
        from archi_tpu_torch.utils.metrics import METRICS

        try:
            self.vectorstore.add_texts(texts, metas, ids=ids)
            for h, _c, _m in batch:
                self.catalog.update_ingestion_status(h, "embedded")
            METRICS.inc("archi_ingest_documents", len(batch),
                        {"status": "embedded"})
            METRICS.inc("archi_ingest_chunks", len(texts))
            return len(batch)
        except Exception as e:
            logger.warning("merged embed failed (%s); isolating per file", e)
            ok = 0
            for h, chunks, meta in batch:
                try:
                    self.vectorstore.add_texts(
                        chunks, [meta] * len(chunks),
                        ids=[chunk_id(h, i) for i in range(len(chunks))],
                    )
                    self.catalog.update_ingestion_status(h, "embedded")
                    ok += 1
                except Exception as e2:
                    self.catalog.update_ingestion_status(
                        h, "failed", f"embed: {e2}"
                    )
                    METRICS.inc("archi_ingest_documents",
                                labels={"status": "failed"})
            return ok

    def _doc_meta(self, resource_hash: str) -> dict:
        doc = self.catalog.get_document(resource_hash) or {}
        meta = dict(doc.get("metadata") or {})
        return {
            "resource_hash": resource_hash,
            "display_name": doc.get("display_name"),
            "source_type": doc.get("source_type"),
            "url": doc.get("url"),
            **{k: v for k, v in meta.items() if isinstance(v, (str, int, float))},
        }

    def _parse_group(self, pool, group: Sequence[str]):
        for h in group:
            self.catalog.update_ingestion_status(h, "embedding")
        return list(pool.map(self._parse_and_chunk, group))

    def _add_hashes(self, hashes: Sequence[str]) -> tuple[int, int]:
        """Parse files on a thread pool (reference ThreadPool parsing,
        ``manager.py:86-99,332``), pipelined one group ahead of the
        embed+insert of the current group so host parsing overlaps device
        embedding."""
        from concurrent.futures import ThreadPoolExecutor

        added = failed = 0
        groups = [list(hashes[s: s + self.batch_files])
                  for s in range(0, len(hashes), self.batch_files)]
        # the prefetch driver lives on its OWN single thread: submitting it
        # to `pool` would deadlock at parallel_workers=1 (the group task
        # blocks on per-file tasks that need the worker it occupies)
        with ThreadPoolExecutor(max_workers=self.parallel_workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as prefetch:
            next_parsed = None
            for gi, group in enumerate(groups):
                parsed = (next_parsed if next_parsed is not None
                          else self._parse_group(pool, group))
                # prefetch the NEXT group's parses before embedding this one
                if gi + 1 < len(groups):
                    nxt = groups[gi + 1]
                    next_future = prefetch.submit(
                        self._parse_group, pool, nxt)
                else:
                    next_future = None
                batch = [(h, c, self._doc_meta(h))
                         for h, c in zip(group, parsed) if c is not None]
                failed += sum(1 for c in parsed if c is None)
                if batch:
                    ok = self._insert_batch(batch)
                    added += ok
                    failed += len(batch) - ok
                next_parsed = next_future.result() if next_future else None
        return added, failed

    # -------------------------------------------------------------- retries
    def retry_failed(self, resource_hash: Optional[str] = None) -> dict:
        self.catalog.retry_failed(resource_hash)
        return self.update_vectorstore()
