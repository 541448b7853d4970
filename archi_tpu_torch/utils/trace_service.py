"""TraceService: agent execution traces with live events + cancellation.

Copy of ``archi_tpu/utils/trace_service.py``.

Mirrors the reference's agent-trace machinery (``agent_traces`` table
``init.sql:440-466``; written during streaming ``chat_app/app.py:855-1040``;
read back via ``/api/trace/<id>`` ``app.py:4102``; cancellation
``/api/cancel_stream`` ``app.py:4150,1012``; per-message tool calls in
``agent_tool_calls`` ``init.sql:468-483``, ``app.py:1219``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

from archi_tpu_torch.utils.app_db import AppDatabase


class TraceService:
    def __init__(self, db: AppDatabase):
        self.db = db

    def create_trace(self, conversation_id: Optional[int] = None) -> int:
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO agent_traces (conversation_id, status, events, "
            "created_at, updated_at) VALUES (?, 'running', '[]', ?, ?)",
            (conversation_id, now, now),
        )
        return int(cur.lastrowid)

    def append_event(self, trace_id: int, event: dict[str, Any]) -> None:
        rows = self.db.query("SELECT events FROM agent_traces WHERE id=?",
                             (trace_id,))
        if not rows:
            return
        events = json.loads(rows[0]["events"] or "[]")
        events.append({**event, "ts": time.time()})
        self.db.execute(
            "UPDATE agent_traces SET events=?, updated_at=? WHERE id=?",
            (json.dumps(events), time.time(), trace_id),
        )

    def finish_trace(self, trace_id: int, *, status: str = "completed",
                     message_id: Optional[int] = None,
                     total_tokens: int = 0, total_tool_calls: int = 0) -> None:
        self.db.execute(
            "UPDATE agent_traces SET status=?, message_id=?, total_tokens=?, "
            "total_tool_calls=?, updated_at=? WHERE id=?",
            (status, message_id, total_tokens, total_tool_calls,
             time.time(), trace_id),
        )

    def cancel(self, trace_id: int) -> bool:
        cur = self.db.execute(
            "UPDATE agent_traces SET cancelled=1, status='cancelled', "
            "updated_at=? WHERE id=? AND status='running'",
            (time.time(), trace_id),
        )
        return cur.rowcount > 0

    def is_cancelled(self, trace_id: int) -> bool:
        rows = self.db.query("SELECT cancelled FROM agent_traces WHERE id=?",
                             (trace_id,))
        return bool(rows and rows[0]["cancelled"])

    def get_trace(self, trace_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM agent_traces WHERE id=?",
                             (trace_id,))
        if not rows:
            return None
        d = dict(rows[0])
        d["events"] = json.loads(d["events"] or "[]")
        d["cancelled"] = bool(d["cancelled"])
        return d

    def get_trace_by_message(self, message_id: int) -> Optional[dict]:
        """Reference /api/trace/message/<id> (app.py:2200)."""
        rows = self.db.query(
            "SELECT id FROM agent_traces WHERE message_id=? "
            "ORDER BY id DESC", (message_id,))
        return self.get_trace(int(rows[0]["id"])) if rows else None

    # ------------------------------------------------------------ tool calls
    def insert_tool_calls(self, message_id: int,
                          tool_calls: list[dict]) -> None:
        """Persist normalized tool calls for a message (reference
        insert_tool_calls_from_output, app.py:1219)."""
        for c in tool_calls:
            self.db.execute(
                "INSERT INTO agent_tool_calls (message_id, tool_name, "
                "tool_input, result, created_at) VALUES (?, ?, ?, ?, ?)",
                (message_id, c.get("name") or c.get("tool_name"),
                 json.dumps(c.get("args") or c.get("tool_input")),
                 str(c.get("result", ""))[:4000], time.time()),
            )

    def get_tool_calls(self, message_id: int) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM agent_tool_calls WHERE message_id=? ORDER BY id",
            (message_id,))
        out = []
        for r in rows:
            d = dict(r)
            d["tool_input"] = json.loads(d["tool_input"] or "null")
            out.append(d)
        return out
