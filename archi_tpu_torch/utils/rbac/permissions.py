"""RBAC: permissions, roles, and checks.

Copy of ``archi_tpu/utils/rbac/permissions.py``.

Mirrors the reference's RBAC layer (``src/utils/rbac/``): the ``Permission``
enum (``permission_enum.py:21-62``), a role → permission registry (485 LoC
role registry), and check helpers used by route decorators and tool gating.
"""

from __future__ import annotations

import enum


class Permission(str, enum.Enum):
    # chat
    CHAT_USE = "chat:use"
    CHAT_STREAM = "chat:stream"
    CHAT_HISTORY_READ = "chat:history:read"
    CHAT_HISTORY_DELETE = "chat:history:delete"
    # data
    DATA_READ = "data:read"
    DATA_UPLOAD = "data:upload"
    DATA_DELETE = "data:delete"
    DATA_INGEST = "data:ingest"
    # config
    CONFIG_READ = "config:read"
    CONFIG_WRITE = "config:write"
    # providers / keys
    PROVIDERS_READ = "providers:read"
    BYOK_MANAGE = "byok:manage"
    # agents
    AGENTS_USE = "agents:use"
    AGENTS_MANAGE = "agents:manage"
    TOOLS_RESTRICTED = "tools:restricted"
    # admin
    ADMIN_DB = "admin:db"
    ADMIN_USERS = "admin:users"
    ANALYTICS_READ = "analytics:read"


#: Role → permissions registry (reference role registry).
ROLE_PERMISSIONS: dict[str, set[Permission]] = {
    "anonymous": {Permission.CHAT_USE},
    "user": {
        Permission.CHAT_USE, Permission.CHAT_STREAM,
        Permission.CHAT_HISTORY_READ, Permission.CHAT_HISTORY_DELETE,
        Permission.DATA_READ, Permission.PROVIDERS_READ,
        Permission.BYOK_MANAGE, Permission.AGENTS_USE,
    },
    "uploader": {
        Permission.DATA_READ, Permission.DATA_UPLOAD, Permission.DATA_DELETE,
        Permission.DATA_INGEST,
    },
    "operator": {
        Permission.CHAT_USE, Permission.CHAT_STREAM,
        Permission.CHAT_HISTORY_READ, Permission.DATA_READ,
        Permission.DATA_INGEST, Permission.AGENTS_USE,
        Permission.TOOLS_RESTRICTED, Permission.ANALYTICS_READ,
        Permission.CONFIG_READ,
    },
    "admin": set(Permission),
}


def permissions_for_roles(roles: list[str]) -> set[Permission]:
    perms: set[Permission] = set()
    for r in roles or []:
        perms |= ROLE_PERMISSIONS.get(r, set())
    return perms


def has_permission(roles: list[str], permission: Permission) -> bool:
    return permission in permissions_for_roles(roles)


def register_role(name: str, permissions: set[Permission]) -> None:
    """Deployment-specific role additions."""
    ROLE_PERMISSIONS[name] = set(permissions)
