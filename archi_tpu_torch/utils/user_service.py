"""UserService: users, roles, preferences.

Copy of ``archi_tpu/utils/user_service.py``.

Mirrors the reference's ``UserService`` (``src/utils/user_service.py:54``):
user CRUD keyed by email, JSON preferences with layered defaults, role
lists.  BYOK API keys live in ``archi_tpu_torch.providers.byok`` (the pgcrypto
``set_api_key:307`` analog).
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

from archi_tpu_torch.utils.app_db import AppDatabase


class UserService:
    def __init__(self, db: AppDatabase):
        self.db = db

    def create_user(self, email: str, *, name: str = "",
                    roles: Optional[list[str]] = None) -> int:
        cur = self.db.execute(
            "INSERT INTO users (email, name, roles, created_at) "
            "VALUES (?, ?, ?, ?) "
            "ON CONFLICT(email) DO UPDATE SET name=excluded.name",
            (email, name, json.dumps(roles or ["user"]), time.time()),
        )
        row = self.db.query("SELECT id FROM users WHERE email=?", (email,))
        return int(row[0]["id"])

    def get_user(self, email: str) -> Optional[dict]:
        rows = self.db.query("SELECT * FROM users WHERE email=?", (email,))
        if not rows:
            return None
        d = dict(rows[0])
        d.pop("password_hash", None)  # never serve the hash
        d["roles"] = json.loads(d["roles"] or "[]")
        d["preferences"] = json.loads(d["preferences"] or "{}")
        return d

    def get_user_by_id(self, user_id: int) -> Optional[dict]:
        rows = self.db.query("SELECT email FROM users WHERE id=?", (user_id,))
        return self.get_user(rows[0]["email"]) if rows else None

    def list_users(self) -> list[dict]:
        return [self.get_user(r["email"])
                for r in self.db.query("SELECT email FROM users")]

    # -------------------------------------------------------------- passwords
    def set_password(self, email: str, password: str) -> None:
        from archi_tpu_torch.utils.sessions import hash_password

        self.create_user(email)
        self.db.execute("UPDATE users SET password_hash=? WHERE email=?",
                        (hash_password(password), email))

    def verify_password(self, email: str, password: str) -> bool:
        from archi_tpu_torch.utils.sessions import verify_password

        rows = self.db.query(
            "SELECT password_hash FROM users WHERE email=?", (email,))
        if not rows or not rows[0]["password_hash"]:
            return False
        return verify_password(password, rows[0]["password_hash"])

    # ------------------------------------------------------------------ roles
    def set_roles(self, email: str, roles: list[str]) -> None:
        self.db.execute("UPDATE users SET roles=? WHERE email=?",
                        (json.dumps(roles), email))

    def get_roles(self, email: str) -> list[str]:
        u = self.get_user(email)
        return u["roles"] if u else []

    # ------------------------------------------------------------ preferences
    def set_preference(self, email: str, key: str, value: Any) -> None:
        u = self.get_user(email)
        prefs = (u or {}).get("preferences", {})
        prefs[key] = value
        self.db.execute("UPDATE users SET preferences=? WHERE email=?",
                        (json.dumps(prefs), email))

    def get_preferences(self, email: str) -> dict:
        u = self.get_user(email)
        return u["preferences"] if u else {}

    def delete_user(self, email: str) -> bool:
        cur = self.db.execute("DELETE FROM users WHERE email=?", (email,))
        return cur.rowcount > 0
