"""The port's Postgres backends on the CPU, held against the JAX package's.

- ``PostgresCatalogService`` and ``PostgresAppDatabase`` of both packages,
  each over its own recording fake DBAPI connection (the fake of
  ``tests/unit/test_catalog_postgres.py``), take the same calls and issue
  the same SQL with the same parameters.
- The ``ConnectionPool`` cases of ``tests/unit/test_connection_pool.py`` on
  the port's pool, and both pooled backends end to end over a real SQLite
  database behind the ``%s`` paramstyle, against the JAX package's.
- A ``postgres://`` / ``postgresql://`` ``app_db`` opens
  ``PostgresAppDatabase`` through ``build_context`` (an injected connection
  factory: no test waits out ``connect_with_retry``'s backoff), writes no
  SQLite file, and keeps the password out of the log and the errors.
"""

import logging
import threading
import time

import pytest

from archi_tpu.data.catalog_postgres import \
    PostgresCatalogService as JaxCatalog
from archi_tpu.utils.app_db_postgres import \
    PostgresAppDatabase as JaxAppDatabase
from archi_tpu.utils.connection_pool import ConnectionPool as JaxPool
from archi_tpu.utils.conversation_service import \
    ConversationService as JaxConversations
from archi_tpu_torch.data.catalog_postgres import (
    PostgresCatalogService, connect_with_retry,
)
from archi_tpu_torch.utils.app_db_postgres import PostgresAppDatabase
from archi_tpu_torch.utils.connection_pool import (
    ConnectionPool, PoolExhaustedError,
)
from archi_tpu_torch.utils.conversation_service import ConversationService


# ------------------------------------------------------ recording fake DBAPI
class FakeCursor:
    """Records (statement, parameters); ``lastval()`` answers 77."""

    def __init__(self, log):
        self.log = log
        self.rowcount = 1
        self._last = ""

    def execute(self, sql, params=()):
        assert "?" not in sql, f"untranslated placeholder in: {sql}"
        self.log.append((sql.strip(), tuple(params) if params else ()))
        self._last = sql

    def fetchone(self):
        return (77,) if "lastval" in self._last else None

    def fetchall(self):
        return []


class FakeConnection:
    def __init__(self):
        self.log = []
        self.commits = 0

    def cursor(self):
        return FakeCursor(self.log)

    def commit(self):
        self.commits += 1

    def close(self):
        pass


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages stamp rows with ``time.time()``: one clock for both."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _catalog_calls(svc):
    svc.upsert_resource("h1", display_name="guide.md", source_type="local",
                        metadata={"k": "v"}, size_bytes=10)
    svc.upsert_resource("h2", display_name="notes.md", source_type="git",
                        metadata={"url": "https://x"}, size_bytes=20)
    svc.update_ingestion_status("h1", "embedded")
    svc.update_ingestion_status("h2", "failed", error="boom")
    svc.set_document_enabled("conv", "h1", False)
    return [svc.get_document("nope"), svc.all_hashes(),
            svc.list_documents(), svc.enabled_hashes("conv"),
            svc.delete_resource("h2"), svc.retry_failed(),
            svc.search_documents("guide")]


def test_catalog_issues_the_jax_packages_sql(frozen_clock):
    """Schema, upserts, statuses, selection, reads, a delete and a retry:
    the same statements with the same parameters, and the same answers."""
    logs, answers = [], []
    for cls in (JaxCatalog, PostgresCatalogService):
        conn = FakeConnection()
        svc = cls(connection=conn)
        answers.append(_catalog_calls(svc))
        logs.append((conn.log, conn.commits))
    assert logs[0] == logs[1]
    assert "BIGSERIAL" in " ".join(sql for sql, _ in logs[1][0])
    assert answers[0] == answers[1]


def test_app_db_issues_the_jax_packages_sql(frozen_clock):
    """Schema, then a conversation created and titled, a message and its
    feedback: the same statements, and ``lastrowid`` from ``lastval()``."""
    logs, ids = [], []
    for db_cls, conv_cls in ((JaxAppDatabase, JaxConversations),
                             (PostgresAppDatabase, ConversationService)):
        conn = FakeConnection()
        db = db_cls(connection=conn)
        convs = conv_cls(db)
        cid = convs.create_conversation(5, title="t")
        convs.rename_conversation(cid, "renamed")
        mid = convs.add_message(cid, "User", "hello")
        ids.append((cid, mid))
        logs.append(conn.log)
    assert ids[0] == ids[1] == (77, 77)
    assert logs[0] == logs[1]
    assert all("?" not in sql for sql, _ in logs[1])


def test_connect_with_retry_backoff():
    calls = []

    def failing_connect(dsn):
        calls.append(dsn)
        raise OSError("refused")

    with pytest.raises(ConnectionError, match="after 3 tries"):
        connect_with_retry("dsn", attempts=3, backoff=0.001,
                           connect=failing_connect)
    assert len(calls) == 3
    assert isinstance(connect_with_retry("dsn", connect=lambda d:
                                         FakeConnection()), FakeConnection)


# ------------------------------------------------ the port's ConnectionPool
class PoolConn:
    def __init__(self):
        self.alive = True
        self.closed = False
        self.health_probes = 0

    def cursor(self):
        conn = self

        class Cur:
            def execute(self, sql, params=()):
                if sql == "SELECT 1":
                    conn.health_probes += 1
                if not conn.alive:
                    raise ConnectionError("dead")

            def fetchone(self):
                return (1,)

        return Cur()

    def rollback(self):
        if not self.alive:
            raise ConnectionError("dead")

    def close(self):
        self.closed = True


def make_factory(created):
    def connect(dsn):
        c = PoolConn()
        created.append(c)
        return c
    return connect


def test_pool_reuse_and_stats():
    created = []
    p = ConnectionPool("dsn", min_conns=1, max_conns=4,
                       connect=make_factory(created))
    for _ in range(5):
        with p.acquire() as c:
            assert isinstance(c, PoolConn)
    s = p.snapshot()
    assert s["created"] == 1 and s["acquired"] == 5 and s["released"] == 5
    assert s["open"] == 1 and s["idle"] == 1 and s["in_use"] == 0


def test_pool_grows_to_max_then_blocks():
    created = []
    p = ConnectionPool("dsn", min_conns=0, max_conns=2, timeout=0.1,
                       connect=make_factory(created))
    c1 = p.acquire()
    c2 = p.acquire()
    c1.__enter__()
    c2.__enter__()
    assert len(created) == 2
    with pytest.raises(PoolExhaustedError):
        with p.acquire(timeout=0.05):
            pass
    c1.__exit__(None, None, None)
    with p.acquire(timeout=1):  # freed slot is reusable
        pass
    c2.__exit__(None, None, None)


def test_pool_waiter_wakes_on_release():
    created = []
    p = ConnectionPool("dsn", min_conns=0, max_conns=1, timeout=5,
                       connect=make_factory(created))
    got = []
    co = p.acquire()
    co.__enter__()

    def waiter():
        with p.acquire() as c:
            got.append(c)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    co.__exit__(None, None, None)
    t.join(timeout=2)
    assert got and len(created) == 1


def test_pool_stale_connection_health_checked_and_reconnected():
    created = []
    p = ConnectionPool("dsn", min_conns=1, max_conns=2,
                       health_check_interval=0.0,   # every reuse is stale
                       connect=make_factory(created))
    created[0].alive = False
    with p.acquire() as c:
        assert c is created[1]          # replaced
    s = p.snapshot()
    assert s["health_failures"] == 1 and s["reconnects"] == 1
    assert created[0].closed


def test_pool_fresh_connection_skips_health_check():
    created = []
    p = ConnectionPool("dsn", min_conns=1, max_conns=2,
                       health_check_interval=60.0,
                       connect=make_factory(created))
    with p.acquire():
        pass
    assert created[0].health_probes == 0


def test_pool_exception_with_dead_connection_discards_it():
    created = []
    p = ConnectionPool("dsn", min_conns=1, max_conns=2,
                       connect=make_factory(created))
    with pytest.raises(ValueError):
        with p.acquire() as c:
            c.alive = False
            raise ValueError("query failed")
    assert created[0].closed
    assert p.snapshot()["open"] == 0
    with p.acquire() as c2:           # pool recovers with a new conn
        assert c2 is created[1]


def test_pool_exception_with_healthy_connection_keeps_it():
    created = []
    p = ConnectionPool("dsn", min_conns=1, max_conns=2,
                       connect=make_factory(created))
    with pytest.raises(ValueError):
        with p.acquire():
            raise ValueError("app-level error, connection fine")
    assert not created[0].closed
    with p.acquire() as c2:
        assert c2 is created[0]


def test_pool_close_all():
    created = []
    p = ConnectionPool("dsn", min_conns=2, max_conns=4,
                       connect=make_factory(created))
    p.close_all()
    assert all(c.closed for c in created)
    with pytest.raises(RuntimeError):
        with p.acquire():
            pass


# ----------------------------------- pooled backends over a real database
class SqliteShimConn:
    """Real sqlite3 behind the %s paramstyle, posing as a PG connection
    (``tests/unit/test_connection_pool.py``'s shim)."""

    def __init__(self, shared):
        import sqlite3

        self._c = sqlite3.connect(shared, uri=True,
                                  check_same_thread=False)
        self._c.row_factory = sqlite3.Row

    def cursor(self):
        inner = self._c

        class Cur:
            rowcount = -1

            def execute(self, sql, params=()):
                if sql == "SELECT 1":
                    self._rows = [(1,)]
                    return
                if sql.strip() == "SELECT lastval()":
                    sql = "SELECT last_insert_rowid()"
                sql = (sql.replace("%s", "?")
                       .replace("BIGSERIAL PRIMARY KEY",
                                "INTEGER PRIMARY KEY AUTOINCREMENT")
                       .replace("DOUBLE PRECISION", "REAL")
                       .replace("BIGINT", "INTEGER"))
                cur = inner.execute(sql, tuple(params))
                self._rows = cur.fetchall()
                self.rowcount = cur.rowcount

            def fetchone(self):
                return self._rows[0] if self._rows else None

            def fetchall(self):
                return list(self._rows)

        return Cur()

    def commit(self):
        self._c.commit()

    def rollback(self):
        self._c.rollback()

    def close(self):
        self._c.close()


def _rows(rows):
    return [dict(r) for r in rows]


def test_pooled_catalogs_end_to_end(tmp_path, frozen_clock):
    """The same calls on both packages' pooled catalogs, each over its own
    SQLite file: the same documents, statuses and counts."""
    out = []
    for name, cat_cls, pool_cls in (("jax", JaxCatalog, JaxPool),
                                    ("port", PostgresCatalogService,
                                     ConnectionPool)):
        uri = f"file:{tmp_path}/{name}-cat.db"
        pool = pool_cls("dsn", min_conns=1, max_conns=3,
                        connect=lambda d, uri=uri: SqliteShimConn(uri))
        svc = cat_cls(pool=pool)
        for i in range(4):
            svc.upsert_resource(f"h{i}", display_name=f"doc-{i}",
                                source_type="git", metadata={"i": i},
                                size_bytes=10 * i)
        svc.update_ingestion_status("h1", "embedded")
        svc.update_ingestion_status("h2", "failed", error="boom")
        svc.delete_resource("h3")
        out.append((_rows(svc.list_documents()), sorted(svc.all_hashes()),
                    svc.stats(), svc.retry_failed(),
                    _rows(svc.search_documents("doc-1"))))
        assert svc.pool_stats()["created"] >= 1
    assert out[0] == out[1]
    docs = out[1][0]
    assert {d["resource_hash"] for d in docs} == {"h0", "h1", "h2"}


def test_pooled_app_dbs_end_to_end(tmp_path, frozen_clock):
    """Users and a conversation through both packages' pooled app
    databases: the same rows and the same inserted ids."""
    from archi_tpu.utils.user_service import UserService as JaxUsers
    from archi_tpu_torch.utils.user_service import UserService

    out = []
    for name, db_cls, pool_cls, users_cls, conv_cls in (
            ("jax", JaxAppDatabase, JaxPool, JaxUsers, JaxConversations),
            ("port", PostgresAppDatabase, ConnectionPool, UserService,
             ConversationService)):
        uri = f"file:{tmp_path}/{name}-app.db"
        pool = pool_cls("dsn", min_conns=1, max_conns=3,
                        connect=lambda d, uri=uri: SqliteShimConn(uri))
        db = db_cls(pool=pool)
        users_cls(db).create_user("a@b.c", roles=["user"])
        convs = conv_cls(db)
        cid = convs.create_conversation(1, title="t")
        mid = convs.add_message(cid, "User", "hello")
        out.append((cid, mid, _rows(db.query(
            "SELECT email, roles FROM users")),
            _rows(db.query("SELECT id, title FROM conversations"))))
        db.close()
        assert pool.snapshot()["open"] == 0
    assert out[0] == out[1]
    assert out[1][2] == [{"email": "a@b.c", "roles": '["user"]'}]


# --------------------------------------- a Postgres app_db in the context
@pytest.mark.parametrize("dsn", ["postgresql://u:pw@db.x/archi",
                                 "postgres://db.x/archi"])
def test_postgres_app_db_opens_through_the_context(dsn, tmp_path,
                                                   monkeypatch, caplog):
    """``build_context`` opens a Postgres ``app_db`` as the JAX package
    does (``utils/app_db_postgres.open_app_database``): the DSN reaches the
    connection factory, the services run on it, and no ``app.db`` file is
    written.  A server that refuses raises ``ConnectionError``; neither
    the error nor the log carries the password."""
    from archi_tpu_torch.bin.bootstrap import build_context
    from archi_tpu_torch.utils import app_db_postgres

    seen = []

    def factory(d):
        seen.append(d)
        return SqliteShimConn(f"file:{tmp_path}/pg.db")

    monkeypatch.setattr(
        app_db_postgres, "connect_with_retry",
        lambda d: connect_with_retry(d, attempts=1, backoff=0.0,
                                     connect=factory))
    overrides = {"app_db": dsn, "data_manager": {
        "embedding_name": "hash", "data_path": str(tmp_path / "data"),
        "db_path": str(tmp_path / "catalog.db")}}
    with caplog.at_level(logging.DEBUG):
        ctx = build_context(overrides=overrides, device="cpu")
        assert isinstance(ctx.app_db, PostgresAppDatabase)
        assert seen == [dsn]
        ctx.users.create_user("a@b.c")
        ctx.users.set_password("a@b.c", "secret")
        assert ctx.users.verify_password("a@b.c", "secret")
        assert ctx.config_service.get("data_manager.db_path") == \
            str(tmp_path / "catalog.db")
        ctx.app_db.close()

        def refuse(d):
            raise OSError("connection refused")

        monkeypatch.setattr(
            app_db_postgres, "connect_with_retry",
            lambda d: connect_with_retry(d, attempts=2, backoff=0.0,
                                         connect=refuse))
        with pytest.raises(ConnectionError, match="unreachable") as err:
            build_context(overrides=overrides, device="cpu")
    assert "pw" not in str(err.value)
    assert ":pw@" not in caplog.text
    assert not (tmp_path / "data" / "app.db").exists()
