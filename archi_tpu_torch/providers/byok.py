"""BYOK (bring-your-own-key): per-user encrypted API keys → provider models.

Copy of ``archi_tpu/providers/byok.py``.

Mirrors the reference's ``BYOKResolver``
(``src/archi/providers/byok_resolver.py:20,64,148``) and the pgcrypto
``pgp_sym_encrypt`` storage in ``UserService.set_api_key``
(``src/utils/user_service.py:307``).  Keys are Fernet-encrypted at rest with
a deployment secret and stored in the catalog's SQLite (or any dict-like
store); resolution yields a fresh provider instance carrying the user's key.
"""

from __future__ import annotations

import base64
import hashlib
import sqlite3
import threading
from typing import Optional

from archi_tpu_torch.providers.base import BaseProvider, ProviderType
from archi_tpu_torch.providers.registry import get_provider


def _fernet(secret: str):
    from cryptography.fernet import Fernet

    key = base64.urlsafe_b64encode(
        hashlib.sha256(secret.encode()).digest()
    )
    return Fernet(key)


class BYOKStore:
    """Encrypted (user_id, provider) → api_key storage."""

    def __init__(self, db_path: str = ":memory:", *, secret: str):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.RLock()
        self._f = _fernet(secret)
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS user_api_keys ("
                "user_id TEXT, provider TEXT, key_cipher BLOB, "
                "PRIMARY KEY (user_id, provider))"
            )
            self._conn.commit()

    def set_key(self, user_id: str, provider: str, api_key: str) -> None:
        cipher = self._f.encrypt(api_key.encode())
        with self._lock:
            self._conn.execute(
                "INSERT INTO user_api_keys (user_id, provider, key_cipher) "
                "VALUES (?, ?, ?) ON CONFLICT(user_id, provider) "
                "DO UPDATE SET key_cipher=excluded.key_cipher",
                (user_id, provider, cipher),
            )
            self._conn.commit()

    def get_key(self, user_id: str, provider: str) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT key_cipher FROM user_api_keys "
                "WHERE user_id=? AND provider=?",
                (user_id, provider),
            ).fetchone()
        if not row:
            return None
        return self._f.decrypt(row[0]).decode()

    def delete_key(self, user_id: str, provider: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM user_api_keys WHERE user_id=? AND provider=?",
                (user_id, provider),
            )
            self._conn.commit()
            return cur.rowcount > 0

    def list_providers(self, user_id: str) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT provider FROM user_api_keys WHERE user_id=?",
                (user_id,),
            ).fetchall()
        return [r[0] for r in rows]


class BYOKResolver:
    def __init__(self, store: BYOKStore):
        self.store = store

    def resolve_provider(self, user_id: str,
                         provider: str | ProviderType) -> Optional[BaseProvider]:
        """Fresh provider instance carrying the user's key, or None."""
        name = provider.value if isinstance(provider, ProviderType) else provider
        key = self.store.get_key(user_id, name)
        if key is None:
            return None
        inst = get_provider(name, fresh=True)
        inst.set_api_key(key)
        return inst

    def get_model(self, user_id: str, ref: str, **kw):
        from archi_tpu_torch.providers.registry import parse_model_ref

        provider_name, model_name = parse_model_ref(ref)
        provider = self.resolve_provider(user_id, provider_name)
        if provider is None:
            return None
        return provider.get_chat_model(model_name, **kw)
