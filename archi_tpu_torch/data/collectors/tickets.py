"""Ticket ingestion: Jira + Redmine clients and the TicketManager.

Copy of ``archi_tpu/data/collectors/tickets.py``.

Mirrors the reference's ticket stack
(``src/data_manager/collectors/tickets/ticket_manager.py:14``,
``jira.py:16`` JQL project fetch ``:127``, ``redmine_tickets.py:13`` with
closed-issue Q/A extraction ``:81-177``): tickets are fetched over each
tracker's REST API, optionally anonymized, and persisted as Q/A-structured
text resources.  HTTP calls go through an injectable ``http_get`` so tests
(and zero-egress environments) can run against fixtures.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from archi_tpu_torch.data.collectors.anonymizer import Anonymizer
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.data.resource import Resource, ResourceMetadata

logger = logging.getLogger(__name__)


def _default_http_get(url: str, *, headers=None, auth=None, params=None):
    import requests

    r = requests.get(url, headers=headers, auth=auth, params=params, timeout=30)
    r.raise_for_status()
    return r.json()


class JiraClient:
    """Fetch issues for a project via JQL (reference jira.py:127)."""

    def __init__(self, base_url: str, *, token: Optional[str] = None,
                 http_get: Callable = _default_http_get):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.http_get = http_get

    def fetch_project_issues(self, project: str, *, max_results: int = 200,
                             updated_since: Optional[str] = None) -> list[dict]:
        jql = f"project = {project}"
        if updated_since:
            jql += f" AND updated >= '{updated_since}'"
        headers = {"Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        issues, start = [], 0
        while len(issues) < max_results:
            data = self.http_get(
                f"{self.base_url}/rest/api/2/search",
                headers=headers,
                params={"jql": jql, "startAt": start, "maxResults": 50,
                        "fields": "summary,description,comment,status,"
                                  "updated,assignee,reporter,creator"},
            )
            batch = data.get("issues", [])
            issues.extend(batch)
            if len(batch) < 50:
                break
            start += 50
        return issues[:max_results]

    @staticmethod
    def issue_to_text(issue: dict) -> str:
        f = issue.get("fields", {})
        parts = [f"Ticket {issue.get('key')}: {f.get('summary', '')}"]
        if f.get("description"):
            parts.append(f["description"])
        for c in (f.get("comment") or {}).get("comments", []):
            parts.append(f"Comment: {c.get('body', '')}")
        return "\n\n".join(parts)

    @staticmethod
    def issue_known_persons(issue: dict) -> list[str]:
        """Author-class names from the structured issue — seeds the
        anonymizer's NER pass (the tracker already tells us who the
        humans are)."""
        f = issue.get("fields", {})
        names = []
        for field in ("assignee", "reporter", "creator"):
            v = f.get(field) or {}
            if isinstance(v, dict) and v.get("displayName"):
                names.append(v["displayName"])
        for c in (f.get("comment") or {}).get("comments", []):
            a = c.get("author") or {}
            if isinstance(a, dict) and a.get("displayName"):
                names.append(a["displayName"])
        return names


class RedmineClient:
    """Fetch closed issues and extract Q/A pairs (reference
    redmine_tickets.py:81-177: question = subject+description, answer =
    journal notes on closed issues)."""

    def __init__(self, base_url: str, *, api_key: Optional[str] = None,
                 http_get: Callable = _default_http_get):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.http_get = http_get

    def fetch_closed_issues(self, project_id: str, *, limit: int = 200) -> list[dict]:
        headers = {}
        if self.api_key:
            headers["X-Redmine-API-Key"] = self.api_key
        out, offset = [], 0
        while len(out) < limit:
            data = self.http_get(
                f"{self.base_url}/issues.json",
                headers=headers,
                params={"project_id": project_id, "status_id": "closed",
                        "include": "journals", "offset": offset, "limit": 50},
            )
            batch = data.get("issues", [])
            out.extend(batch)
            if len(batch) < 50:
                break
            offset += 50
        return out[:limit]

    @staticmethod
    def issue_to_qa(issue: dict) -> Optional[str]:
        question = f"{issue.get('subject', '')}\n\n{issue.get('description', '')}".strip()
        answers = [
            j.get("notes", "")
            for j in issue.get("journals", [])
            if j.get("notes")
        ]
        if not question or not answers:
            return None
        return (
            f"Question (issue #{issue.get('id')}):\n{question}\n\n"
            + "\n\n".join(f"Answer:\n{a}" for a in answers)
        )

    @staticmethod
    def issue_known_persons(issue: dict) -> list[str]:
        """Author-class names from the structured issue (anonymizer
        seed)."""
        names = []
        for field in ("author", "assigned_to"):
            v = issue.get(field) or {}
            if isinstance(v, dict) and v.get("name"):
                names.append(v["name"])
        for j in issue.get("journals", []):
            u = j.get("user") or {}
            if isinstance(u, dict) and u.get("name"):
                names.append(u["name"])
        return names


class TicketManager:
    """Collect tickets from configured trackers into the catalog (reference
    ticket_manager.py:14)."""

    def __init__(self, persistence: PersistenceService, *,
                 anonymize: bool = False):
        self.persistence = persistence
        self.anonymizer = Anonymizer() if anonymize else None

    def _persist(self, text: str, name: str, source: str, url=None,
                 extra=None, known_persons=()) -> str:
        if self.anonymizer:
            text = self.anonymizer.anonymize(
                text, known_persons=known_persons)
        meta = ResourceMetadata(
            display_name=name, source_type=source, url=url,
            extension=".txt", extra=extra or {},
        )
        return self.persistence.persist_resource(Resource(text, meta))

    def collect_jira(self, client: JiraClient, project: str, **fetch_kw) -> list[str]:
        hashes = []
        for issue in client.fetch_project_issues(project, **fetch_kw):
            text = JiraClient.issue_to_text(issue)
            key = issue.get("key", "JIRA")
            hashes.append(self._persist(
                text, key, "jira",
                url=f"{client.base_url}/browse/{key}",
                extra={"project": project},
                known_persons=JiraClient.issue_known_persons(issue),
            ))
        return hashes

    def collect_redmine(self, client: RedmineClient, project_id: str,
                        **fetch_kw) -> list[str]:
        hashes = []
        for issue in client.fetch_closed_issues(project_id, **fetch_kw):
            qa = RedmineClient.issue_to_qa(issue)
            if qa is None:
                continue
            iid = issue.get("id")
            hashes.append(self._persist(
                qa, f"redmine-{iid}", "redmine",
                url=f"{client.base_url}/issues/{iid}",
                extra={"project": project_id},
                known_persons=RedmineClient.issue_known_persons(issue),
            ))
        return hashes

    def collect_all_from_config(self, config: dict) -> list[str]:
        hashes = []
        for j in config.get("jira", []) or []:
            client = JiraClient(j["url"], token=j.get("token"))
            for p in j.get("projects", []):
                try:
                    hashes.extend(self.collect_jira(client, p))
                except Exception as e:
                    logger.warning("jira collect failed %s: %s", p, e)
        for r in config.get("redmine", []) or []:
            client = RedmineClient(r["url"], api_key=r.get("api_key"))
            for p in r.get("projects", []):
                try:
                    hashes.extend(self.collect_redmine(client, p))
                except Exception as e:
                    logger.warning("redmine collect failed %s: %s", p, e)
        return hashes
