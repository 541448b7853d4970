"""ConfigService: runtime config over the app database.

Copy of ``archi_tpu/config/service.py``.

Mirrors the reference's three-stage config system (SURVEY.md §5.6):
- ``seed()`` writes the merged deploy config into the single-row
  ``static_config`` and initializes ``dynamic_config``
  (reference ``src/cli/tools/config_seed.py``; ``init.sql:95-176``),
- runtime reads go through this service (``src/utils/config_service.py:111``;
  ``get_full_config`` ``src/utils/config_access.py:67``),
- dynamic updates are validated (static paths rejected), audited
  (``config_audit``, ``config_service.py:1246``), and user preferences
  layer into an "effective config" (``config_service.py:1170-1244``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

from archi_tpu_torch.config.defaults import STATIC_PATHS, default_config
from archi_tpu_torch.config.manager import deep_merge, get_path, set_path
from archi_tpu_torch.utils.app_db import AppDatabase


class StaticConfigError(ValueError):
    pass


class ConfigService:
    def __init__(self, db: AppDatabase):
        self.db = db

    # ------------------------------------------------------------------ seed
    def seed(self, config: dict, *, force: bool = False) -> None:
        existing = self.db.query("SELECT config FROM static_config WHERE id=1")
        if existing and not force:
            return
        merged = deep_merge(default_config(), config)
        static, dynamic = self._split(merged)
        self.db.execute(
            "INSERT INTO static_config (id, config) VALUES (1, ?) "
            "ON CONFLICT(id) DO UPDATE SET config=excluded.config",
            (json.dumps(static),),
        )
        self.db.execute(
            "INSERT INTO dynamic_config (id, config) VALUES (1, ?) "
            "ON CONFLICT(id) DO UPDATE SET config=excluded.config",
            (json.dumps(dynamic),),
        )

    @staticmethod
    def _split(config: dict) -> tuple[dict, dict]:
        static: dict = {}
        for p in STATIC_PATHS:
            v = get_path(config, p)
            if v is not None:
                set_path(static, p, v)
        return static, config

    # ----------------------------------------------------------------- reads
    def get_static(self) -> dict:
        rows = self.db.query("SELECT config FROM static_config WHERE id=1")
        return json.loads(rows[0]["config"]) if rows else {}

    def get_dynamic(self) -> dict:
        rows = self.db.query("SELECT config FROM dynamic_config WHERE id=1")
        return json.loads(rows[0]["config"]) if rows else {}

    def get_full_config(self) -> dict:
        """dynamic overlaid by static (static always wins; reference
        get_full_config)."""
        return deep_merge(self.get_dynamic(), self.get_static())

    def get(self, dotted: str, default=None):
        return get_path(self.get_full_config(), dotted, default)

    # ---------------------------------------------------------------- updates
    def update_dynamic(self, changes: dict[str, Any], *,
                       changed_by: str = "system") -> dict:
        """Apply {dotted_path: value} updates; static paths are rejected and
        every change is audited."""
        for path in changes:
            for sp in STATIC_PATHS:
                if path == sp or path.startswith(sp + "."):
                    raise StaticConfigError(
                        f"{path!r} is static configuration and cannot be "
                        "changed at runtime"
                    )
        dynamic = self.get_dynamic()
        audit_entry = {}
        for path, value in changes.items():
            audit_entry[path] = {"old": get_path(dynamic, path),
                                 "new": value}
            set_path(dynamic, path, value)
        self.db.execute(
            "UPDATE dynamic_config SET config=? WHERE id=1",
            (json.dumps(dynamic),),
        )
        self.db.execute(
            "INSERT INTO config_audit (changed_by, changes, created_at) "
            "VALUES (?, ?, ?)",
            (changed_by, json.dumps(audit_entry), time.time()),
        )
        return dynamic

    def audit_log(self, limit: int = 50) -> list[dict]:
        rows = self.db.query(
            "SELECT * FROM config_audit ORDER BY id DESC LIMIT ?", (limit,))
        out = []
        for r in rows:
            d = dict(r)
            d["changes"] = json.loads(d["changes"] or "{}")
            out.append(d)
        return out

    # ------------------------------------------------------------- effective
    def effective_config(self, user_preferences: Optional[dict] = None) -> dict:
        """full config overlaid with a user's preference paths (reference
        effective-config resolution, config_service.py:1170-1244).  User
        preferences may not override static paths."""
        cfg = self.get_full_config()
        for path, value in (user_preferences or {}).items():
            if any(path == sp or path.startswith(sp + ".")
                   for sp in STATIC_PATHS):
                continue
            set_path(cfg, path, value)
        return cfg
