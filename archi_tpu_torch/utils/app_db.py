"""Application database: the framework's relational state plane.

Copy of ``archi_tpu/utils/app_db.py``.

The analog of the reference's ``init.sql`` schema (568 lines,
``src/cli/templates/init.sql``) minus the vector plane (which lives on TPU):
users/preferences, conversations/messages, feedback, per-message timing,
agent traces + tool calls, A/B comparisons, static/dynamic config + audit.
SQLite by default (Postgres-gated when psycopg2 exists); access goes through
the service classes (``user_service``/``conversation_service``/...), matching
the reference's ``PostgresServiceFactory`` composition
(``src/utils/postgres_service_factory.py:17``).
"""

from __future__ import annotations

import sqlite3
import threading

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    email TEXT UNIQUE NOT NULL,
    name TEXT DEFAULT '',
    roles TEXT DEFAULT '[]',
    preferences TEXT DEFAULT '{}',
    password_hash TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS conversations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER,
    title TEXT DEFAULT '',
    created_at REAL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS messages (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    conversation_id INTEGER NOT NULL,
    sender TEXT NOT NULL,
    content TEXT NOT NULL,
    model_used TEXT,
    metadata TEXT DEFAULT '{}',
    created_at REAL
);
CREATE INDEX IF NOT EXISTS idx_messages_conv ON messages(conversation_id);
CREATE TABLE IF NOT EXISTS feedback (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    message_id INTEGER NOT NULL,
    rating TEXT,
    comment TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS timing (
    message_id INTEGER PRIMARY KEY,
    stamps TEXT DEFAULT '{}',
    msg_duration REAL
);
CREATE TABLE IF NOT EXISTS agent_traces (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    conversation_id INTEGER,
    message_id INTEGER,
    status TEXT DEFAULT 'running',
    events TEXT DEFAULT '[]',
    total_tokens INTEGER DEFAULT 0,
    total_tool_calls INTEGER DEFAULT 0,
    cancelled INTEGER DEFAULT 0,
    created_at REAL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS agent_tool_calls (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    message_id INTEGER,
    tool_name TEXT,
    tool_input TEXT,
    result TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS ab_comparisons (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    conversation_id INTEGER,
    question TEXT,
    answer_a TEXT, answer_b TEXT,
    model_a TEXT, model_b TEXT,
    preference TEXT,
    created_at REAL
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
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    changed_by TEXT,
    changes TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS prompts (
    name TEXT PRIMARY KEY,
    content TEXT NOT NULL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS rbac_audit (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_email TEXT,
    action TEXT,
    resource TEXT,
    allowed INTEGER,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS grader_submissions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_email TEXT,
    problem INTEGER,
    submission TEXT,
    grade TEXT,
    analysis TEXT,
    summary TEXT,
    status TEXT DEFAULT 'pending',
    final_grade TEXT,
    decided_by TEXT,
    created_at REAL,
    updated_at REAL
);
"""


class AppDatabase:
    """Shared connection + schema; services hold a reference to this."""

    def __init__(self, db_path: str = ":memory:"):
        self.conn = sqlite3.connect(db_path, check_same_thread=False)
        self.conn.row_factory = sqlite3.Row
        self.lock = threading.RLock()
        with self.lock:
            self.conn.executescript(_SCHEMA)
            self.conn.commit()
            self._migrate()

    def _migrate(self) -> None:
        """Additive column migrations for databases created by older
        schemas (the reference's migration_state analog for the app DB)."""
        for ddl in (
            "ALTER TABLE users ADD COLUMN password_hash TEXT",
            # r4: grader web UI keys attempts on (user, problem)
            "ALTER TABLE grader_submissions ADD COLUMN problem INTEGER",
        ):
            try:
                self.conn.execute(ddl)
                self.conn.commit()
            except Exception:
                pass  # column already exists

    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        with self.lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
            return cur

    def query(self, sql: str, params=()) -> list[sqlite3.Row]:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self.lock:
            self.conn.close()
