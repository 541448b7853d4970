"""Document catalog: the relational metadata plane of the framework.

Copy of ``archi_tpu/data/catalog.py``.

The analog of the reference's ``PostgresCatalogService``
(``src/data_manager/collectors/utils/catalog_postgres.py:53``, 1,284 LoC)
and its ``documents`` table (``src/cli/templates/init.sql:200-260``): the
catalog tracks every ingested resource (hash → path + metadata), drives the
ingestion-status machine ``pending → embedding → embedded|failed`` with
stored errors and retry (``catalog_postgres.py:722,761,783``), and resolves
per-conversation document enablement (3-tier selection,
``init.sql:315-336``).

Backend: SQLite by default (always available; the reference also ships a
SQLite legacy catalog, ``collectors/utils/index_utils.py:55``); the SQL is
vanilla enough that the optional Postgres backend (psycopg2, gated) reuses
it with parameter-style translation.  Embeddings do NOT live here — the
vector plane is the TPU-resident index; the catalog remains the source of
truth for WHAT should be indexed (diff-sync, ``IndexManager``).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    resource_hash TEXT UNIQUE NOT NULL,
    display_name TEXT DEFAULT '',
    source_type TEXT DEFAULT 'local_files',
    url TEXT,
    file_path TEXT,
    metadata TEXT DEFAULT '{}',
    size_bytes INTEGER DEFAULT 0,
    ingestion_status TEXT DEFAULT 'pending',
    ingestion_error TEXT,
    is_deleted INTEGER DEFAULT 0,
    created_at REAL,
    updated_at REAL
);
CREATE INDEX IF NOT EXISTS idx_documents_status
    ON documents(ingestion_status);
CREATE INDEX IF NOT EXISTS idx_documents_source
    ON documents(source_type);
CREATE TABLE IF NOT EXISTS document_selections (
    conversation_id TEXT NOT NULL,
    resource_hash TEXT NOT NULL,
    enabled INTEGER NOT NULL DEFAULT 1,
    PRIMARY KEY (conversation_id, resource_hash)
);
CREATE TABLE IF NOT EXISTS migration_state (
    key TEXT PRIMARY KEY,
    state TEXT NOT NULL,
    updated_at REAL
);
"""

VALID_STATUSES = ("pending", "embedding", "embedded", "failed")


class CatalogService:
    def __init__(self, db_path: str = ":memory:"):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # ------------------------------------------------------------------ CRUD
    def upsert_resource(
        self,
        resource_hash: str,
        *,
        display_name: str = "",
        source_type: str = "local_files",
        url: Optional[str] = None,
        file_path: Optional[str] = None,
        metadata: Optional[dict] = None,
        size_bytes: int = 0,
    ) -> None:
        """Insert or refresh a catalog row (reference upsert_resource:148).
        Re-upserting an existing hash keeps its ingestion status."""
        now = time.time()
        with self._lock:
            self._conn.execute(
                """
                INSERT INTO documents
                    (resource_hash, display_name, source_type, url, file_path,
                     metadata, size_bytes, created_at, updated_at)
                VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)
                ON CONFLICT(resource_hash) DO UPDATE SET
                    display_name=excluded.display_name,
                    source_type=excluded.source_type,
                    url=excluded.url,
                    file_path=excluded.file_path,
                    metadata=excluded.metadata,
                    size_bytes=excluded.size_bytes,
                    is_deleted=0,
                    updated_at=excluded.updated_at
                """,
                (resource_hash, display_name, source_type, url, file_path,
                 json.dumps(metadata or {}), size_bytes, now, now),
            )
            self._conn.commit()

    def get_document(self, resource_hash: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM documents WHERE resource_hash = ?",
                (resource_hash,),
            ).fetchone()
        return self._row_to_dict(row) if row else None

    def delete_resource(self, resource_hash: str, *, hard: bool = False) -> bool:
        with self._lock:
            if hard:
                cur = self._conn.execute(
                    "DELETE FROM documents WHERE resource_hash = ?",
                    (resource_hash,),
                )
            else:
                cur = self._conn.execute(
                    "UPDATE documents SET is_deleted = 1, updated_at = ? "
                    "WHERE resource_hash = ?",
                    (time.time(), resource_hash),
                )
            self._conn.commit()
            return cur.rowcount > 0

    def reset(self) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM documents")
            self._conn.execute("DELETE FROM document_selections")
            self._conn.commit()

    # ----------------------------------------------------------------- lists
    def all_hashes(self, *, include_deleted: bool = False) -> set[str]:
        q = "SELECT resource_hash FROM documents"
        if not include_deleted:
            q += " WHERE is_deleted = 0"
        with self._lock:
            return {r[0] for r in self._conn.execute(q)}

    def list_documents(
        self,
        *,
        source_type: Optional[str] = None,
        status: Optional[str] = None,
        include_deleted: bool = False,
        limit: Optional[int] = None,
        offset: int = 0,
    ) -> list[dict]:
        clauses, params = [], []
        if not include_deleted:
            clauses.append("is_deleted = 0")
        if source_type:
            clauses.append("source_type = ?")
            params.append(source_type)
        if status:
            clauses.append("ingestion_status = ?")
            params.append(status)
        q = "SELECT * FROM documents"
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY updated_at DESC"
        if limit:
            q += f" LIMIT {int(limit)} OFFSET {int(offset)}"
        with self._lock:
            rows = self._conn.execute(q, params).fetchall()
        return [self._row_to_dict(r) for r in rows]

    def list_documents_grouped(self) -> dict[str, list[dict]]:
        """Documents grouped by source type (reference
        list_documents_grouped:801 backing the /data UI)."""
        out: dict[str, list[dict]] = {}
        for d in self.list_documents():
            out.setdefault(d["source_type"], []).append(d)
        return out

    def search_documents(self, query: str, *, limit: int = 50) -> list[dict]:
        """Substring search over display name / url / metadata (the catalog
        API used by the agent's metadata-search tool,
        reference ``uploader_app/app.py:449`` api_catalog_search)."""
        like = f"%{query}%"
        with self._lock:
            rows = self._conn.execute(
                """
                SELECT * FROM documents
                WHERE is_deleted = 0 AND (
                    display_name LIKE ? OR url LIKE ? OR metadata LIKE ?)
                ORDER BY updated_at DESC LIMIT ?
                """,
                (like, like, like, limit),
            ).fetchall()
        return [self._row_to_dict(r) for r in rows]

    # ---------------------------------------------------------- status machine
    def update_ingestion_status(
        self, resource_hash: str, status: str, error: Optional[str] = None
    ) -> None:
        """pending → embedding → embedded|failed (reference
        update_ingestion_status:722, init.sql:237-245)."""
        assert status in VALID_STATUSES, status
        with self._lock:
            self._conn.execute(
                "UPDATE documents SET ingestion_status = ?, "
                "ingestion_error = ?, updated_at = ? WHERE resource_hash = ?",
                (status, error, time.time(), resource_hash),
            )
            self._conn.commit()

    def get_failed(self) -> list[dict]:
        return self.list_documents(status="failed")

    def retry_failed(self, resource_hash: Optional[str] = None) -> int:
        """Reset failed docs to pending — one or all (reference
        catalog_postgres.py:761,783; endpoints app.py:2246-2247)."""
        with self._lock:
            if resource_hash:
                cur = self._conn.execute(
                    "UPDATE documents SET ingestion_status='pending', "
                    "ingestion_error=NULL WHERE resource_hash=? "
                    "AND ingestion_status='failed'",
                    (resource_hash,),
                )
            else:
                cur = self._conn.execute(
                    "UPDATE documents SET ingestion_status='pending', "
                    "ingestion_error=NULL WHERE ingestion_status='failed'"
                )
            self._conn.commit()
            return cur.rowcount

    def stats(self) -> dict:
        with self._lock:
            rows = self._conn.execute(
                "SELECT ingestion_status, COUNT(*), COALESCE(SUM(size_bytes),0) "
                "FROM documents WHERE is_deleted = 0 GROUP BY ingestion_status"
            ).fetchall()
        by_status = {r[0]: r[1] for r in rows}
        return {
            "total": sum(by_status.values()),
            "by_status": by_status,
            "total_bytes": sum(r[2] for r in rows),
        }

    # ------------------------------------------------------- doc selection
    def set_document_enabled(
        self, conversation_id: str, resource_hash: str, enabled: bool
    ) -> None:
        with self._lock:
            self._conn.execute(
                """
                INSERT INTO document_selections
                    (conversation_id, resource_hash, enabled)
                VALUES (?, ?, ?)
                ON CONFLICT(conversation_id, resource_hash)
                DO UPDATE SET enabled=excluded.enabled
                """,
                (conversation_id, resource_hash, int(enabled)),
            )
            self._conn.commit()

    def enabled_hashes(self, conversation_id: str) -> Optional[set[str]]:
        """None = no per-conversation selection (all enabled); otherwise the
        effective enabled set: default-on minus explicit disables, plus
        explicit enables (3-tier resolution analog,
        reference document_selection_service.py:49)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT resource_hash, enabled FROM document_selections "
                "WHERE conversation_id = ?",
                (conversation_id,),
            ).fetchall()
        if not rows:
            return None
        disabled = {r[0] for r in rows if not r[1]}
        return self.all_hashes() - disabled

    # ----------------------------------------------------- migration state
    def set_migration_state(self, key: str, state: dict) -> None:
        """JSONB-checkpoint analog for resumable maintenance jobs
        (reference init.sql:520-528 migration_state)."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO migration_state (key, state, updated_at) "
                "VALUES (?, ?, ?) ON CONFLICT(key) DO UPDATE SET "
                "state=excluded.state, updated_at=excluded.updated_at",
                (key, json.dumps(state), time.time()),
            )
            self._conn.commit()

    def get_migration_state(self, key: str) -> Optional[dict]:
        with self._lock:
            row = self._conn.execute(
                "SELECT state FROM migration_state WHERE key = ?", (key,)
            ).fetchone()
        return json.loads(row[0]) if row else None

    # ---------------------------------------------------------------- misc
    @staticmethod
    def _row_to_dict(row: sqlite3.Row) -> dict:
        d = dict(row)
        d["metadata"] = json.loads(d.get("metadata") or "{}")
        d["is_deleted"] = bool(d.get("is_deleted"))
        return d

    def close(self) -> None:
        with self._lock:
            self._conn.close()
