"""Redmine mailer entry point: an IMAP inbox turned into Redmine tickets
with drafted replies, over the port's store.

Counterpart of ``archi_tpu/bin/service_mailbox.py`` (reference
``src/bin/service_mailbox.py`` + ``service_redmine.py``), over the port's
``build_context``, on the card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_mailbox config.yaml

Env: IMAP_HOST, IMAP_USER, IMAP_PW, SMTP_HOST, SMTP_USER, SMTP_PW,
REDMINE_URL, REDMINE_API_KEY, REDMINE_PROJECT, POLL_SECONDS.
``build_mailer`` returns the mailer and its context without polling, so a
caller can hand it its own transports and drive ``step()``; ``main`` only
polls.
"""

from __future__ import annotations

import os
import sys
import time

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.redmine_mailer import (
    Mailbox, MailSender, RedmineMailer, RedmineWriteClient,
)


def build_mailer(config_paths=(), overrides=None, ctx=None, *, device=None,
                 devices=None, **transport):
    """→ (mailer, ctx).  ``transport``: any of ``RedmineMailer``'s
    arguments (``mailbox``, ``sender``, ``redmine_client``,
    ``agent_archi``, ``project_id``) in place of the ones made from the
    environment."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    agent = Archi("CMSCompOpsAgent", config=ctx.config,
                  vectorstore=ctx.vectorstore)
    kw = dict(
        mailbox=Mailbox(os.environ.get("IMAP_HOST", ""),
                        os.environ.get("IMAP_USER", ""),
                        os.environ.get("IMAP_PW", "")),
        sender=MailSender(os.environ.get("SMTP_HOST", ""),
                          user=os.environ.get("SMTP_USER", ""),
                          password=os.environ.get("SMTP_PW", "")),
        redmine_client=RedmineWriteClient(
            os.environ.get("REDMINE_URL", ""),
            api_key=os.environ.get("REDMINE_API_KEY", "")),
        agent_archi=agent,
        project_id=os.environ.get("REDMINE_PROJECT", "support"),
    )
    kw.update(transport)
    return RedmineMailer(**kw), ctx


def main() -> None:
    mailer, _ctx = build_mailer(sys.argv[1:])
    poll = float(os.environ.get("POLL_SECONDS", "120"))
    print("redmine mailer polling")
    while True:
        mailer.step()
        time.sleep(poll)


if __name__ == "__main__":
    main()
