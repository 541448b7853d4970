"""Thread-safe Postgres connection pool with health-check + reconnect.

Copy of ``archi_tpu/utils/connection_pool.py``.

The analog of the reference's ``ThreadedConnectionPool`` wrapper
(``src/utils/connection_pool.py:34``; health-check/reconnect ``:145-204``):
bounded pool, idle connections probed with ``SELECT 1`` before reuse,
broken connections discarded and replaced, usage stats for observability.

Differences from the reference, deliberate:
- the connect factory is injectable (``connect=``) so the pool is fully
  unit-testable without a server (the live tier stays DSN-gated);
- acquisition is a context manager — no leaked checkouts on exceptions;
- no psycopg2 import at module level: the default factory is
  ``catalog_postgres.connect_with_retry`` which gates it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class PoolExhaustedError(RuntimeError):
    pass


class _Slot:
    __slots__ = ("conn", "last_used")

    def __init__(self, conn):
        self.conn = conn
        self.last_used = time.monotonic()


class ConnectionPool:
    """min_conns opened eagerly, up to max_conns on demand.

    acquire() blocks up to ``timeout`` for a free slot, health-checks
    idle connections older than ``health_check_interval`` seconds, and
    transparently reconnects when the probe fails.
    """

    def __init__(self, dsn: str = "", *, min_conns: int = 1,
                 max_conns: int = 8, timeout: float = 30.0,
                 health_check_interval: float = 30.0,
                 connect: Optional[Callable] = None):
        if connect is None:
            from archi_tpu_torch.data.catalog_postgres import connect_with_retry

            connect = connect_with_retry
        self._dsn = dsn
        self._connect = connect
        self.max_conns = max(1, int(max_conns))
        self.min_conns = max(0, min(int(min_conns), self.max_conns))
        self.timeout = float(timeout)
        self.health_check_interval = float(health_check_interval)
        self._lock = threading.Condition()
        self._idle: list[_Slot] = []
        self._n_open = 0          # idle + checked out
        self._closed = False
        self.stats = {
            "created": 0, "acquired": 0, "released": 0,
            "health_checks": 0, "health_failures": 0, "reconnects": 0,
            "discarded": 0,
        }
        for _ in range(self.min_conns):
            self._idle.append(_Slot(self._new_conn()))

    # ------------------------------------------------------------- internal
    def _new_conn(self):
        conn = self._connect(self._dsn)   # contract: connect(dsn) -> conn
        self.stats["created"] += 1
        self._n_open += 1
        return conn

    def _healthy(self, conn) -> bool:
        self.stats["health_checks"] += 1
        try:
            cur = conn.cursor()
            cur.execute("SELECT 1")
            cur.fetchone()
            return True
        except Exception:
            self.stats["health_failures"] += 1
            return False

    def _discard(self, conn) -> None:
        self.stats["discarded"] += 1
        self._n_open -= 1
        try:
            conn.close()
        except Exception:
            pass

    # ------------------------------------------------------------------ API
    def acquire(self, timeout: float | None = None):
        """Context manager yielding a healthy connection."""
        return _Checkout(self, timeout)

    def _take(self, timeout: float | None):
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        with self._lock:
            while True:
                if self._closed:
                    raise RuntimeError("pool closed")
                if self._idle:
                    slot = self._idle.pop()
                    stale = (time.monotonic() - slot.last_used
                             > self.health_check_interval)
                    if stale and not self._healthy(slot.conn):
                        self._discard(slot.conn)
                        logger.warning("pool: stale connection failed "
                                       "health check; reconnecting")
                        self.stats["reconnects"] += 1
                        conn = self._new_conn()
                    else:
                        conn = slot.conn
                    self.stats["acquired"] += 1
                    return conn
                if self._n_open < self.max_conns:
                    conn = self._new_conn()
                    self.stats["acquired"] += 1
                    return conn
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PoolExhaustedError(
                        f"no connection free within "
                        f"{self.timeout if timeout is None else timeout}s "
                        f"({self.max_conns} in use)")
                self._lock.wait(remaining)

    def _put_back(self, conn, *, broken: bool = False) -> None:
        with self._lock:
            self.stats["released"] += 1
            if broken or self._closed:
                self._discard(conn)
            else:
                self._idle.append(_Slot(conn))
            self._lock.notify()

    def snapshot(self) -> dict:
        """Point-in-time stats (reference ``connection_pool`` stats)."""
        with self._lock:
            return {
                **self.stats,
                "open": self._n_open,
                "idle": len(self._idle),
                "in_use": self._n_open - len(self._idle),
                "max_conns": self.max_conns,
            }

    def close_all(self) -> None:
        with self._lock:
            self._closed = True
            for slot in self._idle:
                self._discard(slot.conn)
            self._idle.clear()
            self._lock.notify_all()


class _Checkout:
    """``with pool.acquire() as conn:`` — returns the connection on exit;
    an exception inside the block marks it broken (discard + replace on
    the pool side), matching the reference's reconnect-on-error path."""

    def __init__(self, pool: ConnectionPool, timeout: float | None):
        self._pool = pool
        self._timeout = timeout
        self._conn = None

    def __enter__(self):
        self._conn = self._pool._take(self._timeout)
        return self._conn

    def __exit__(self, exc_type, exc, tb):
        broken = exc_type is not None
        if broken:
            try:
                self._conn.rollback()
                broken = self._pool._healthy(self._conn) is False
            except Exception:
                broken = True
        self._pool._put_back(self._conn, broken=broken)
        return False
