"""Postgres backend for the document catalog.

Copy of ``archi_tpu/data/catalog_postgres.py``.

The reference's primary catalog is Postgres
(``src/data_manager/collectors/utils/catalog_postgres.py:53``) with SQLite
as the legacy fallback (``index_utils.py:55``); archi-tpu inverts the
default (SQLite ships everywhere; the TPU engine owns the vector plane) but
keeps a Postgres backend for deployments that already run one for the
conversation/metadata plane.

Implementation: ``CatalogService``'s SQL is deliberately vanilla; this
subclass swaps the connection for a psycopg2 one behind a DBAPI adapter
that translates the ``?`` paramstyle to ``%s``, maps the DDL to Postgres
types, and keeps the same retry-with-backoff connection behavior as the
reference (``catalog_postgres.py:74-89``).  The adapter is injectable so
the translation layer is unit-tested without a server (the reference tests
its catalog the same way — mocked cursors).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from archi_tpu_torch.data.catalog import CatalogService

_PG_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id BIGSERIAL PRIMARY KEY,
    resource_hash TEXT UNIQUE NOT NULL,
    display_name TEXT DEFAULT '',
    source_type TEXT DEFAULT 'local_files',
    url TEXT,
    file_path TEXT,
    metadata TEXT DEFAULT '{}',
    size_bytes BIGINT DEFAULT 0,
    ingestion_status TEXT DEFAULT 'pending',
    ingestion_error TEXT,
    is_deleted INTEGER DEFAULT 0,
    created_at DOUBLE PRECISION,
    updated_at DOUBLE PRECISION
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
    updated_at DOUBLE PRECISION
);
"""


class _ParamStyleCursor:
    """Wraps a %s-paramstyle DBAPI cursor behind sqlite's ? paramstyle."""

    def __init__(self, cursor):
        self._c = cursor

    @staticmethod
    def _translate(sql: str) -> str:
        # catalog SQL never contains literal '?', so plain replace is safe
        return sql.replace("?", "%s")

    def execute(self, sql: str, params=()):
        self._c.execute(self._translate(sql), tuple(params))
        return self

    def fetchone(self):
        return self._c.fetchone()

    def fetchall(self):
        return self._c.fetchall()

    def __iter__(self):
        return iter(self._c.fetchall())

    @property
    def rowcount(self):
        return self._c.rowcount

    @property
    def lastrowid(self):  # pragma: no cover - catalog doesn't use it on PG
        return None


class _ParamStyleConnection:
    """DBAPI connection adapter presenting the sqlite3 surface the base
    CatalogService uses (execute/commit/executescript/close, dict rows)."""

    def __init__(self, conn):
        self._conn = conn

    def _rollback(self):
        # A failed statement leaves a non-autocommit DBAPI connection in an
        # aborted-transaction state (psycopg2 InFailedSqlTransaction), which
        # poisons every later statement on the shared connection.  Roll it
        # back eagerly so one bad query can't wedge the whole service.
        try:
            self._conn.rollback()
        except Exception:
            pass

    def execute(self, sql: str, params=()):
        wrapped = _ParamStyleCursor(self._conn.cursor())
        try:
            wrapped.execute(sql, params)
        except Exception:
            self._rollback()
            raise
        return wrapped

    def executescript(self, script: str):
        cur = self._conn.cursor()
        try:
            for stmt in script.split(";"):
                if stmt.strip():
                    cur.execute(stmt)
        except Exception:
            self._rollback()
            raise
        return cur

    def commit(self):
        self._conn.commit()

    def close(self):
        self._conn.close()

    @property
    def row_factory(self):  # compat no-op; dict rows come from the driver
        return None

    @row_factory.setter
    def row_factory(self, _v):
        pass


def connect_with_retry(dsn: str, *, attempts: int = 5,
                       backoff: float = 1.0,
                       connect: Optional[Callable] = None):
    """Connection retry with exponential backoff (reference
    catalog_postgres.py:74-89)."""
    last: Optional[Exception] = None
    for i in range(attempts):
        try:
            if connect is None:
                import psycopg2
                from psycopg2.extras import RealDictConnection

                conn = psycopg2.connect(
                    dsn, connection_factory=RealDictConnection)
                # One statement = one transaction.  The services use the
                # sqlite-style commit-per-write pattern, so transactional
                # batching buys nothing here, while non-autocommit leaves
                # reads idle-in-transaction and failed statements aborting
                # the shared connection.
                conn.autocommit = True
                return conn
            return connect(dsn)
        except Exception as e:  # pragma: no cover - needs a server
            last = e
            time.sleep(backoff * (2 ** i))
    raise ConnectionError(f"postgres unreachable after {attempts} tries: {last}")


class _EagerRows:
    """Cursor results materialized before a pooled connection is released
    (a lazy cursor would touch a connection another thread now owns)."""

    def __init__(self, rows, rowcount):
        self._rows = rows
        self.rowcount = rowcount
        self.lastrowid = None

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self):
        return list(self._rows)

    def __iter__(self):
        return iter(self._rows)


class _PooledParamStyleConnection:
    """The _ParamStyleConnection surface over a ConnectionPool: each call
    checks out a healthy connection (``SELECT 1``-probed when idle past
    the interval, reconnected on failure) and returns it before the call
    completes.  Statements are one-per-transaction (real connections are
    autocommit), so per-call checkout preserves today's semantics while
    removing the single shared socket as a serialization point and a
    single point of permanent failure."""

    def __init__(self, pool):
        self._pool = pool

    def execute(self, sql: str, params=()):
        with self._pool.acquire() as raw:
            wrapped = _ParamStyleConnection(raw)
            cur = wrapped.execute(sql, params)
            try:
                rows = cur.fetchall()
            except Exception:
                rows = []       # writes: nothing to fetch
            wrapped.commit()
            return _EagerRows(rows, cur.rowcount)

    def executescript(self, script: str):
        with self._pool.acquire() as raw:
            wrapped = _ParamStyleConnection(raw)
            cur = wrapped.executescript(script)
            wrapped.commit()
            return cur

    def commit(self):
        pass                     # per-call commit above

    def close(self):
        self._pool.close_all()

    @property
    def row_factory(self):
        return None

    @row_factory.setter
    def row_factory(self, _v):
        pass


class PostgresCatalogService(CatalogService):
    """CatalogService over Postgres.  Requires psycopg2 (gated — not in the
    base image); pass ``connection`` to supply any dict-row DBAPI connection
    (used by tests with a sqlite shim), or ``pool`` /default-dsn for the
    pooled mode (reference ``src/utils/connection_pool.py:34``)."""

    def __init__(self, dsn: str = "", *, connection=None, pool=None,
                 max_conns: int = 8):
        import threading

        if connection is not None:
            self._conn = _ParamStyleConnection(connection)
        else:
            if pool is None:
                from archi_tpu_torch.utils.connection_pool import ConnectionPool

                pool = ConnectionPool(dsn, min_conns=1,
                                      max_conns=max_conns,
                                      connect=lambda d:
                                      connect_with_retry(d))
            self._pool = pool
            self._conn = _PooledParamStyleConnection(pool)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_PG_SCHEMA)
            self._conn.commit()

    def pool_stats(self) -> dict | None:
        pool = getattr(self, "_pool", None)
        return None if pool is None else pool.snapshot()
