"""Postgres backend for the application database.

Copy of ``archi_tpu/utils/app_db_postgres.py``.

Completes the relational-plane parity story: the reference keeps users/
conversations/traces in Postgres (``src/cli/templates/init.sql``); archi-tpu
defaults to SQLite but deployments that already run Postgres for the catalog
can point the app DB there too.  Reuses the paramstyle adapter pattern from
``data/catalog_postgres.py``; ``lastrowid`` (used by the services for
freshly-inserted ids) is emulated with ``SELECT lastval()``.
psycopg2-gated; the translation layer is unit-tested with a fake driver.
"""

from __future__ import annotations

import threading

from archi_tpu_torch.data.catalog_postgres import connect_with_retry
from archi_tpu_torch.utils.app_db import AppDatabase

_PG_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id BIGSERIAL PRIMARY KEY,
    email TEXT UNIQUE NOT NULL,
    name TEXT DEFAULT '',
    roles TEXT DEFAULT '[]',
    preferences TEXT DEFAULT '{}',
    password_hash TEXT,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS conversations (
    id BIGSERIAL PRIMARY KEY,
    user_id BIGINT,
    title TEXT DEFAULT '',
    created_at DOUBLE PRECISION,
    updated_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS messages (
    id BIGSERIAL PRIMARY KEY,
    conversation_id BIGINT NOT NULL,
    sender TEXT NOT NULL,
    content TEXT NOT NULL,
    model_used TEXT,
    metadata TEXT DEFAULT '{}',
    created_at DOUBLE PRECISION
);
CREATE INDEX IF NOT EXISTS idx_messages_conv ON messages(conversation_id);
CREATE TABLE IF NOT EXISTS feedback (
    id BIGSERIAL PRIMARY KEY,
    message_id BIGINT NOT NULL,
    rating TEXT,
    comment TEXT,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS timing (
    message_id BIGINT PRIMARY KEY,
    stamps TEXT DEFAULT '{}',
    msg_duration DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS agent_traces (
    id BIGSERIAL PRIMARY KEY,
    conversation_id BIGINT,
    message_id BIGINT,
    status TEXT DEFAULT 'running',
    events TEXT DEFAULT '[]',
    total_tokens BIGINT DEFAULT 0,
    total_tool_calls BIGINT DEFAULT 0,
    cancelled INTEGER DEFAULT 0,
    created_at DOUBLE PRECISION,
    updated_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS agent_tool_calls (
    id BIGSERIAL PRIMARY KEY,
    message_id BIGINT,
    tool_name TEXT,
    tool_input TEXT,
    result TEXT,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS ab_comparisons (
    id BIGSERIAL PRIMARY KEY,
    conversation_id BIGINT,
    question TEXT,
    answer_a TEXT, answer_b TEXT,
    model_a TEXT, model_b TEXT,
    preference TEXT,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS static_config (
    id INTEGER PRIMARY KEY CHECK (id = 1),
    config TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS dynamic_config (
    id INTEGER PRIMARY KEY CHECK (id = 1),
    config TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS config_audit (
    id BIGSERIAL PRIMARY KEY,
    changed_by TEXT,
    changes TEXT,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS prompts (
    name TEXT PRIMARY KEY,
    content TEXT NOT NULL,
    updated_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS rbac_audit (
    id BIGSERIAL PRIMARY KEY,
    user_email TEXT,
    action TEXT,
    resource TEXT,
    allowed INTEGER,
    created_at DOUBLE PRECISION
);
CREATE TABLE IF NOT EXISTS grader_submissions (
    id BIGSERIAL PRIMARY KEY,
    user_email TEXT,
    submission TEXT,
    grade TEXT,
    analysis TEXT,
    summary TEXT,
    status TEXT DEFAULT 'pending',
    final_grade TEXT,
    decided_by TEXT,
    created_at DOUBLE PRECISION,
    updated_at DOUBLE PRECISION
);
"""


class _PgCursor:
    def __init__(self, conn):
        self._conn = conn
        self._cur = conn.cursor()

    @staticmethod
    def _translate(sql: str) -> str:
        return sql.replace("?", "%s")

    def execute(self, sql: str, params=()):
        self._cur.execute(self._translate(sql), tuple(params))
        return self

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()

    def __iter__(self):
        return iter(self._cur.fetchall())

    @property
    def rowcount(self):
        return self._cur.rowcount

    @property
    def lastrowid(self):
        """SELECT lastval() — valid after any sequence-backed insert."""
        cur = self._conn.cursor()
        cur.execute("SELECT lastval()")
        row = cur.fetchone()
        if row is None:
            return None
        return row[0] if not isinstance(row, dict) else list(row.values())[0]


class _PgConnection:
    def __init__(self, conn):
        self._conn = conn

    def _rollback(self):
        # Failed statements abort a non-autocommit transaction and poison
        # every later call on the shared connection; always roll back on
        # error (real connections are opened autocommit — this protects
        # injected/test connections too).
        try:
            self._conn.rollback()
        except Exception:
            pass

    def execute(self, sql: str, params=()):
        try:
            return _PgCursor(self._conn).execute(sql, params)
        except Exception:
            self._rollback()
            raise

    def executescript(self, script: str):
        cur = self._conn.cursor()
        try:
            for stmt in script.split(";"):
                if stmt.strip():
                    cur.execute(stmt)
        except Exception:
            self._rollback()
            raise

    def commit(self):
        self._conn.commit()

    def close(self):
        self._conn.close()

    @property
    def row_factory(self):  # dict rows come from the driver
        return None

    @row_factory.setter
    def row_factory(self, _v):
        pass


class _EagerCursor:
    """Cursor results materialized before the pooled connection goes back
    to the pool — .fetchall()/.lastrowid after release would otherwise
    touch a connection another thread now owns."""

    def __init__(self, rows, rowcount, lastrowid):
        self._rows = rows
        self.rowcount = rowcount
        self.lastrowid = lastrowid

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self):
        return list(self._rows)

    def __iter__(self):
        return iter(self._rows)


class PostgresAppDatabase(AppDatabase):
    """App DB over Postgres.

    Default mode pools connections (reference
    ``src/utils/connection_pool.py:34``: bounded ThreadedConnectionPool,
    ``SELECT 1`` health checks, reconnect on failure) — the single shared
    connection of earlier rounds serialized every service behind one
    socket and died permanently with it.  ``connection=`` keeps the
    unpooled single-connection mode (tests / injected fakes).
    """

    def __init__(self, dsn: str = "", *, connection=None, pool=None,
                 max_conns: int = 8):
        self.lock = threading.RLock()
        self._pool = None
        if connection is not None:
            self.conn = _PgConnection(connection)
            with self.lock:
                self.conn.executescript(_PG_SCHEMA)
                self.conn.commit()
            return
        if pool is None:
            from archi_tpu_torch.utils.connection_pool import ConnectionPool

            pool = ConnectionPool(dsn, min_conns=1, max_conns=max_conns,
                                  connect=lambda d: connect_with_retry(d))
        self._pool = pool
        self.conn = None
        with pool.acquire() as raw:
            wrapped = _PgConnection(raw)
            wrapped.executescript(_PG_SCHEMA)
            wrapped.commit()

    def pool_stats(self) -> dict | None:
        return None if self._pool is None else self._pool.snapshot()

    def execute(self, sql: str, params=()):
        if self._pool is None:
            return super().execute(sql, params)
        with self._pool.acquire() as raw:
            wrapped = _PgConnection(raw)
            cur = wrapped.execute(sql, params)
            try:
                rows = cur.fetchall()
            except Exception:
                rows = []        # INSERT/UPDATE without RETURNING
            lastrowid = None
            if sql.lstrip()[:6].upper() == "INSERT":
                # only after inserts: lastval() errors when no sequence
                # was touched this session, and on a non-autocommit
                # connection that error would abort (and lose) the write
                try:
                    lastrowid = cur.lastrowid
                except Exception:
                    lastrowid = None
            wrapped.commit()
            return _EagerCursor(rows, cur.rowcount, lastrowid)

    def query(self, sql: str, params=()):
        if self._pool is not None:
            return self.execute(sql, params).fetchall()
        # End the implicit transaction after reads so non-autocommit
        # connections don't sit idle-in-transaction between requests.
        with self.lock:
            rows = self.conn.execute(sql, params).fetchall()
            self.conn.commit()
            return rows

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close_all()
        elif self.conn is not None:
            self.conn.close()


def open_app_database(path_or_dsn: str) -> AppDatabase:
    """Factory: 'postgresql://...' DSNs get the Postgres backend, anything
    else is a SQLite path."""
    if path_or_dsn.startswith(("postgres://", "postgresql://")):
        return PostgresAppDatabase(path_or_dsn)
    return AppDatabase(path_or_dsn)
