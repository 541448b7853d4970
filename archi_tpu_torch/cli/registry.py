"""Service + source registries: declarative definitions for deployments.

Copy of ``archi_tpu/cli/registry.py``.

Mirrors the reference's ``ServiceRegistry``/``SourceRegistry``
(``src/cli/service_registry.py:55,66-161``; ``source_registry.py:16``): each
service declares its module entrypoint, default port, config requirements,
and dependencies; sources declare their collector type + config shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ServiceDef:
    name: str
    module: str                      # python -m <module> entrypoint
    default_port: Optional[int]
    description: str
    depends_on: tuple[str, ...] = ()
    required_secrets: tuple[str, ...] = ()


SERVICES: dict[str, ServiceDef] = {
    s.name: s for s in [
        ServiceDef("data_manager", "archi_tpu_torch.bin.service_data_manager",
                   7862, "ingest + TPU index + catalog API"),
        ServiceDef("chat", "archi_tpu_torch.bin.service_chat", 7861,
                   "chat web app + REST API", depends_on=("data_manager",)),
        ServiceDef("grader", "archi_tpu_torch.bin.service_grader", 7863,
                   "grading web app", depends_on=("data_manager",)),
        ServiceDef("benchmarking", "archi_tpu_torch.bin.service_benchmark", None,
                   "quality/retrieval benchmark run",
                   depends_on=("data_manager",)),
        ServiceDef("piazza", "archi_tpu_torch.bin.service_piazza", None,
                   "Piazza answer-draft bot", depends_on=("chat",),
                   required_secrets=("PIAZZA_EMAIL", "PIAZZA_PASSWORD")),
        ServiceDef("mattermost", "archi_tpu_torch.bin.service_mattermost", None,
                   "Mattermost channel bot", depends_on=("chat",),
                   required_secrets=("MATTERMOST_TOKEN",)),
        ServiceDef("redmine_mailer", "archi_tpu_torch.bin.service_mailbox", None,
                   "IMAP -> Redmine ticket mailer",
                   required_secrets=("IMAP_USER", "IMAP_PW",
                                     "REDMINE_API_KEY")),
    ]
}

SOURCES: dict[str, dict] = {
    "local_files": {"collector": "LocalFileManager",
                    "config": {"paths": "list[str]"}},
    "links": {"collector": "ScraperManager",
              "config": {"links": "list[url]", "max_depth": "int",
                         "max_pages": "int"}},
    "git": {"collector": "GitScraper",
            "config": {"repos": "list[{url, branch}]"}},
    "jira": {"collector": "TicketManager.collect_jira",
             "config": {"url": "str", "token": "secret",
                        "projects": "list[str]"}},
    "redmine": {"collector": "TicketManager.collect_redmine",
                "config": {"url": "str", "api_key": "secret",
                           "projects": "list[str]"}},
    "sso": {"collector": "SSOScraper",
            "config": {"links": "list[url]", "login": "callable"}},
}


def resolve_dependencies(enabled: list[str]) -> list[str]:
    """Topological start order (reference resolve_dependencies:194)."""
    order: list[str] = []
    seen: set[str] = set()

    def visit(name: str):
        if name in seen:
            return
        seen.add(name)
        svc = SERVICES.get(name)
        if svc:
            for dep in svc.depends_on:
                if dep in enabled:
                    visit(dep)
            order.append(name)

    for n in enabled:
        visit(n)
    return order
