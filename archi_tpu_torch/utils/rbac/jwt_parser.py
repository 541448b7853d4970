"""JWT role extraction (reference ``src/utils/rbac/jwt_parser.py:18``).

Copy of ``archi_tpu/utils/rbac/jwt_parser.py``.

Parses a JWT's payload to extract identity + roles without external deps.
Signature verification is HMAC-SHA256 when a secret is provided (the
reference's deployments sit behind an SSO proxy and treat the token as
pre-verified; we verify when we can).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional


def _b64url_decode(part: str) -> bytes:
    pad = "=" * (-len(part) % 4)
    return base64.urlsafe_b64decode(part + pad)


def _b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def encode_jwt(payload: dict, secret: str) -> str:
    header = _b64url_encode(json.dumps(
        {"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url_encode(json.dumps(payload).encode())
    signing_input = f"{header}.{body}".encode()
    sig = _b64url_encode(
        hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    )
    return f"{header}.{body}.{sig}"


def decode_jwt(token: str, secret: Optional[str] = None,
               *, verify_exp: bool = True) -> dict:
    """→ payload dict; raises ValueError on malformed/invalid tokens."""
    parts = token.split(".")
    if len(parts) != 3:
        raise ValueError("malformed JWT")
    header_b64, body_b64, sig_b64 = parts
    payload = json.loads(_b64url_decode(body_b64))
    if secret is not None:
        signing_input = f"{header_b64}.{body_b64}".encode()
        expect = hmac.new(secret.encode(), signing_input,
                          hashlib.sha256).digest()
        if not hmac.compare_digest(expect, _b64url_decode(sig_b64)):
            raise ValueError("bad JWT signature")
    if verify_exp and "exp" in payload and payload["exp"] < time.time():
        raise ValueError("JWT expired")
    return payload


def extract_identity(token: str, secret: Optional[str] = None) -> dict:
    """→ {email, name, roles} from common claim layouts (reference
    jwt_parser supports resource_access/realm_access/groups claims)."""
    p = decode_jwt(token, secret)
    roles: list[str] = []
    roles += p.get("roles", []) or []
    roles += (p.get("realm_access") or {}).get("roles", [])
    for client in (p.get("resource_access") or {}).values():
        roles += client.get("roles", [])
    roles += [g.strip("/") for g in p.get("groups", [])]
    return {
        "email": p.get("email") or p.get("preferred_username") or p.get("sub"),
        "name": p.get("name", ""),
        "roles": sorted(set(roles)) or ["user"],
    }
