"""Copy of ``archi_tpu/utils/rbac/audit.py``.

RBAC audit log (reference ``src/utils/rbac/audit.py:18``)."""

from __future__ import annotations

import time
from typing import Optional

from archi_tpu_torch.utils.app_db import AppDatabase


class RBACAudit:
    def __init__(self, db: AppDatabase):
        self.db = db

    def record(self, user_email: Optional[str], action: str, resource: str,
               allowed: bool) -> None:
        self.db.execute(
            "INSERT INTO rbac_audit (user_email, action, resource, allowed, "
            "created_at) VALUES (?, ?, ?, ?, ?)",
            (user_email, action, resource, int(allowed), time.time()),
        )

    def recent(self, limit: int = 100) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM rbac_audit ORDER BY id DESC LIMIT ?", (limit,))
        return [dict(r) for r in rows]

    def denials(self, limit: int = 100) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM rbac_audit WHERE allowed=0 ORDER BY id DESC "
            "LIMIT ?", (limit,))
        return [dict(r) for r in rows]
