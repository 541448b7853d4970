"""Cookie-session service: the auth/SSO session-establishment analog.

Copy of ``archi_tpu/utils/sessions.py``.

The reference establishes login sessions via an OAuth/SSO flow
(``src/interfaces/chat_app/app.py:2293-2459`` login/callback,
``:2486-2572`` session handling); this image has no browser or IdP, so the
session layer is IdP-agnostic: ``SessionService`` issues and verifies
HMAC-signed, expiring session tokens carried in an HttpOnly cookie, and the
chat app exposes (a) a password login (PBKDF2 hashes in the user table) and
(b) an OAuth-shaped ``/api/auth/callback`` that accepts an injectable
code→identity exchanger, so a real IdP drops in without touching routes.

Tokens are stateless (email|expiry|nonce|HMAC) — like the reference's
signed Flask session cookie, logout clears the cookie client-side and
short expiries bound exposure.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from typing import Optional

COOKIE_NAME = "archi_session"


class SessionService:
    def __init__(self, secret: Optional[str] = None, *,
                 ttl_seconds: float = 12 * 3600):
        # ephemeral per-process secret when none configured (dev mode):
        # sessions survive within the process, die with it.
        self.secret = (secret or os.urandom(32).hex()).encode()
        self.ttl = ttl_seconds

    def _sign(self, payload: str) -> str:
        return hmac.new(self.secret, payload.encode(),
                        hashlib.sha256).hexdigest()

    def create(self, email: str) -> str:
        if "|" in email:  # delimiter — would make the token unparseable
            raise ValueError("invalid email for session")
        exp = int(time.time() + self.ttl)
        nonce = os.urandom(8).hex()
        payload = f"{email}|{exp}|{nonce}"
        return f"{payload}|{self._sign(payload)}"

    def verify(self, token: str) -> Optional[str]:
        """→ email when valid and unexpired, else None."""
        parts = (token or "").rsplit("|", 1)
        if len(parts) != 2:
            return None
        payload, sig = parts
        if not hmac.compare_digest(sig, self._sign(payload)):
            return None
        try:
            email, exp, _nonce = payload.split("|")
            if time.time() > int(exp):
                return None
            return email
        except ValueError:
            return None

    # ------------------------------------------------------------- cookies
    def cookie_header(self, token: str) -> str:
        return (f"{COOKIE_NAME}={token}; Path=/; HttpOnly; "
                f"SameSite=Lax; Max-Age={int(self.ttl)}")

    @staticmethod
    def clear_cookie_header() -> str:
        return f"{COOKIE_NAME}=; Path=/; HttpOnly; Max-Age=0"

    @staticmethod
    def token_from_cookie_header(cookie_header: str) -> Optional[str]:
        for part in (cookie_header or "").split(";"):
            k, _, v = part.strip().partition("=")
            if k == COOKIE_NAME and v:
                return v
        return None


# ------------------------------------------------------------ passwords
def hash_password(password: str, *, salt: Optional[bytes] = None,
                  iterations: int = 200_000) -> str:
    salt = salt if salt is not None else os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2${iterations}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, dk_hex = stored.split("$")
        if scheme != "pbkdf2":
            return False
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), int(iters))
        return hmac.compare_digest(dk.hex(), dk_hex)
    except (ValueError, AttributeError):
        return False
