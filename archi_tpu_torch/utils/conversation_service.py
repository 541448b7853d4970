"""ConversationService: conversations, messages, feedback, timing, A/B,
model-usage analytics.

Copy of ``archi_tpu/utils/conversation_service.py``.

Mirrors the reference's ``ConversationService``
(``src/utils/conversation_service.py:59``): message persistence + history
readback (the chat hot path, ``chat_app/app.py:1460``), per-message timing
rows (``init.sql:421-434``), A/B comparisons + stats
(``conversation_service.py:490,564``), and model usage analytics
(``api.py:713``).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from archi_tpu_torch.utils.app_db import AppDatabase
from archi_tpu_torch.utils.timing import TimingRecorder


class ConversationService:
    def __init__(self, db: AppDatabase):
        self.db = db

    # ---------------------------------------------------------- conversations
    def create_conversation(self, user_id: Optional[int] = None,
                            title: str = "") -> int:
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO conversations (user_id, title, created_at, "
            "updated_at) VALUES (?, ?, ?, ?)",
            (user_id, title, now, now),
        )
        return int(cur.lastrowid)

    def get_conversation(self, conversation_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM conversations WHERE id=?",
                             (conversation_id,))
        return dict(rows[0]) if rows else None

    def list_conversations(self, user_id: Optional[int] = None) -> list[dict]:
        if user_id is None:
            rows = self.db.query(
                "SELECT * FROM conversations ORDER BY updated_at DESC")
        else:
            rows = self.db.query(
                "SELECT * FROM conversations WHERE user_id=? "
                "ORDER BY updated_at DESC", (user_id,))
        return [dict(r) for r in rows]

    def rename_conversation(self, conversation_id: int, title: str) -> None:
        self.db.execute("UPDATE conversations SET title=?, updated_at=? "
                        "WHERE id=?", (title, time.time(), conversation_id))

    def delete_conversation(self, conversation_id: int) -> None:
        self.db.execute("DELETE FROM messages WHERE conversation_id=?",
                        (conversation_id,))
        self.db.execute("DELETE FROM conversations WHERE id=?",
                        (conversation_id,))

    def user_owns(self, conversation_id: int, user_id: int) -> bool:
        conv = self.get_conversation(conversation_id)
        return bool(conv) and conv.get("user_id") == user_id

    # --------------------------------------------------------------- messages
    def add_message(self, conversation_id: int, sender: str, content: str,
                    *, model_used: Optional[str] = None,
                    metadata: Optional[dict] = None) -> int:
        cur = self.db.execute(
            "INSERT INTO messages (conversation_id, sender, content, "
            "model_used, metadata, created_at) VALUES (?, ?, ?, ?, ?, ?)",
            (conversation_id, sender, content, model_used,
             json.dumps(metadata or {}), time.time()),
        )
        self.db.execute("UPDATE conversations SET updated_at=? WHERE id=?",
                        (time.time(), conversation_id))
        return int(cur.lastrowid)

    def get_history(self, conversation_id: int,
                    limit: Optional[int] = None) -> list[tuple[str, str]]:
        q = ("SELECT sender, content FROM messages WHERE conversation_id=? "
             "ORDER BY id")
        rows = self.db.query(q, (conversation_id,))
        hist = [(r["sender"], r["content"]) for r in rows]
        return hist[-limit:] if limit else hist

    def get_message(self, message_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM messages WHERE id=?",
                             (message_id,))
        return dict(rows[0]) if rows else None

    def get_messages(self, conversation_id: int) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM messages WHERE conversation_id=? ORDER BY id",
            (conversation_id,))
        out = []
        for r in rows:
            d = dict(r)
            d["metadata"] = json.loads(d["metadata"] or "{}")
            out.append(d)
        return out

    # --------------------------------------------------------------- feedback
    def add_feedback(self, message_id: int, rating: str,
                     comment: str = "") -> int:
        cur = self.db.execute(
            "INSERT INTO feedback (message_id, rating, comment, created_at) "
            "VALUES (?, ?, ?, ?)",
            (message_id, rating, comment, time.time()),
        )
        return int(cur.lastrowid)

    def feedback_stats(self) -> dict:
        rows = self.db.query(
            "SELECT rating, COUNT(*) c FROM feedback GROUP BY rating")
        return {r["rating"]: r["c"] for r in rows}

    # ----------------------------------------------------------------- timing
    def record_timing(self, message_id: int, recorder: TimingRecorder) -> None:
        d = recorder.durations()
        self.db.execute(
            "INSERT INTO timing (message_id, stamps, msg_duration) "
            "VALUES (?, ?, ?) ON CONFLICT(message_id) DO UPDATE SET "
            "stamps=excluded.stamps, msg_duration=excluded.msg_duration",
            (message_id, json.dumps(recorder.stamps),
             d.get("msg_duration")),
        )

    def get_timing(self, message_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM timing WHERE message_id=?",
                             (message_id,))
        if not rows:
            return None
        d = dict(rows[0])
        d["stamps"] = json.loads(d["stamps"] or "{}")
        return d

    def timing_stats(self) -> dict:
        rows = self.db.query(
            "SELECT COUNT(*) n, AVG(msg_duration) avg_s, "
            "MAX(msg_duration) max_s FROM timing")
        return dict(rows[0]) if rows else {}

    # --------------------------------------------------------------------- AB
    def create_ab_comparison(self, conversation_id: int, question: str,
                             answer_a: str, answer_b: str,
                             model_a: str, model_b: str) -> int:
        cur = self.db.execute(
            "INSERT INTO ab_comparisons (conversation_id, question, "
            "answer_a, answer_b, model_a, model_b, created_at) "
            "VALUES (?, ?, ?, ?, ?, ?, ?)",
            (conversation_id, question, answer_a, answer_b, model_a,
             model_b, time.time()),
        )
        return int(cur.lastrowid)

    def list_pending_ab(self, user_id: Optional[int] = None) -> list[dict]:
        """Comparisons awaiting a preference (reference /api/ab/pending,
        app.py:2195), scoped to the user's conversations when known."""
        if user_id is None:
            rows = self.db.query(
                "SELECT * FROM ab_comparisons WHERE preference IS NULL "
                "ORDER BY id DESC")
        else:
            rows = self.db.query(
                "SELECT ab.* FROM ab_comparisons ab JOIN conversations c "
                "ON ab.conversation_id = c.id WHERE ab.preference IS NULL "
                "AND (c.user_id = ? OR c.user_id IS NULL) ORDER BY ab.id "
                "DESC", (user_id,))
        return [dict(r) for r in rows]

    def get_ab_comparison(self, comparison_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM ab_comparisons WHERE id=?",
                             (comparison_id,))
        return dict(rows[0]) if rows else None

    def record_ab_preference(self, comparison_id: int,
                             preference: str) -> None:
        assert preference in ("a", "b", "tie")
        self.db.execute("UPDATE ab_comparisons SET preference=? WHERE id=?",
                        (preference, comparison_id))

    def ab_stats(self) -> dict:
        """Win rates per model pair (reference conversation_service.py:564)."""
        rows = self.db.query(
            "SELECT model_a, model_b, preference, COUNT(*) c FROM "
            "ab_comparisons WHERE preference IS NOT NULL "
            "GROUP BY model_a, model_b, preference")
        stats: dict[str, dict] = {}
        for r in rows:
            key = f"{r['model_a']} vs {r['model_b']}"
            s = stats.setdefault(key, {"a": 0, "b": 0, "tie": 0})
            s[r["preference"]] += r["c"]
        return stats

    # -------------------------------------------------------------- analytics
    def model_usage_stats(self) -> list[dict]:
        rows = self.db.query(
            "SELECT model_used, COUNT(*) messages FROM messages "
            "WHERE model_used IS NOT NULL GROUP BY model_used "
            "ORDER BY messages DESC")
        return [dict(r) for r in rows]
