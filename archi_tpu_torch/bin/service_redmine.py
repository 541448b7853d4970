"""Redmine-side ticket-processing entry point: poll the tracker, draft
agent replies on new issues, notify reporters on resolved issues, over the
port's store.

Counterpart of ``archi_tpu/bin/service_redmine.py`` (reference
``src/bin/service_redmine.py``), over the port's ``build_context``, on the
card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_redmine config.yaml

The IMAP-side companion is ``service_mailbox``.  Env: REDMINE_URL,
REDMINE_API_KEY, REDMINE_PROJECT, SMTP_* (optional), POLL_SECONDS.
``build_processor`` returns the processor and its context without polling,
so a caller can hand it its own transports and drive ``step()``; ``main``
only polls.
"""

from __future__ import annotations

import os
import sys
import time

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.redmine_mailer import (
    MailSender, RedmineIssueProcessor, RedmineWriteClient,
)


def make_list_issues(base_url: str, api_key: str, project_id: str):
    def list_issues(status: str) -> list[dict]:
        import requests

        status_id = {"open": "open", "resolved": "3"}.get(status, status)
        r = requests.get(
            f"{base_url.rstrip('/')}/issues.json",
            headers={"X-Redmine-API-Key": api_key},
            params={"project_id": project_id, "status_id": status_id,
                    "include": "journals", "limit": 50},
            timeout=30,
        )
        r.raise_for_status()
        return r.json().get("issues", [])

    return list_issues


def build_processor(config_paths=(), overrides=None, ctx=None, *,
                    device=None, devices=None, **transport):
    """→ (processor, ctx).  ``transport``: any of
    ``RedmineIssueProcessor``'s arguments (``list_issues``,
    ``redmine_client``, ``agent_archi``, ``sender``, ``project_id``) in
    place of the ones made from the environment."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    base_url = os.environ.get("REDMINE_URL", "")
    api_key = os.environ.get("REDMINE_API_KEY", "")
    project = os.environ.get("REDMINE_PROJECT", "support")
    agent = Archi("CMSCompOpsAgent", config=ctx.config,
                  vectorstore=ctx.vectorstore)
    sender = None
    if os.environ.get("SMTP_HOST"):
        sender = MailSender(os.environ["SMTP_HOST"],
                            user=os.environ.get("SMTP_USER", ""),
                            password=os.environ.get("SMTP_PW", ""))
    kw = dict(
        list_issues=make_list_issues(base_url, api_key, project),
        redmine_client=RedmineWriteClient(base_url, api_key=api_key),
        agent_archi=agent,
        sender=sender,
        project_id=project,
    )
    kw.update(transport)
    return RedmineIssueProcessor(**kw), ctx


def main() -> None:
    proc, _ctx = build_processor(sys.argv[1:])
    poll = float(os.environ.get("POLL_SECONDS", "120"))
    print("redmine issue processor polling")
    while True:
        proc.step()
        time.sleep(poll)


if __name__ == "__main__":
    main()
