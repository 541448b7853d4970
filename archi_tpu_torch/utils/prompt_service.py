"""PromptService: named prompt registry with file seeding.

Copy of ``archi_tpu/utils/prompt_service.py``.

Mirrors the reference's ``PromptService`` (``src/utils/prompt_service.py:34``):
prompts are seeded from files at deploy time and read/updated at runtime via
the database, so operators can edit prompts without redeploys.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from archi_tpu_torch.utils.app_db import AppDatabase


class PromptService:
    def __init__(self, db: AppDatabase):
        self.db = db

    def set_prompt(self, name: str, content: str) -> None:
        self.db.execute(
            "INSERT INTO prompts (name, content, updated_at) VALUES (?, ?, ?) "
            "ON CONFLICT(name) DO UPDATE SET content=excluded.content, "
            "updated_at=excluded.updated_at",
            (name, content, time.time()),
        )

    def get_prompt(self, name: str) -> Optional[str]:
        rows = self.db.query("SELECT content FROM prompts WHERE name=?",
                             (name,))
        return rows[0]["content"] if rows else None

    def list_prompts(self) -> list[str]:
        return [r["name"] for r in self.db.query(
            "SELECT name FROM prompts ORDER BY name")]

    def seed_from_directory(self, directory: str, *,
                            overwrite: bool = False) -> int:
        """Load ``*.prompt``/``*.txt``/``*.md`` files as named prompts."""
        n = 0
        if not os.path.isdir(directory):
            return 0
        for f in sorted(os.listdir(directory)):
            base, ext = os.path.splitext(f)
            if ext not in (".prompt", ".txt", ".md"):
                continue
            if not overwrite and self.get_prompt(base) is not None:
                continue
            with open(os.path.join(directory, f), encoding="utf-8") as fh:
                self.set_prompt(base, fh.read())
            n += 1
        return n
