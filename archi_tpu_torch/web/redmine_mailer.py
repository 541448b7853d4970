"""Redmine mailer: IMAP inbox → Redmine tickets → agent-drafted replies.

Copy of ``archi_tpu/web/redmine_mailer.py``.

Mirrors the reference's Redmine mailer integration
(``src/interfaces/redmine_mailer_integration/redmine.py:27,171``,
``mailbox.py``, ``utils/imap.py``, ``utils/sender.py``): poll an IMAP inbox,
open a Redmine ticket per new mail, run the CompOps agent to draft a reply,
append the draft as a private ticket note, and send acknowledgment mail.
All transports are injectable for tests.
"""

from __future__ import annotations

import email
import email.message
import logging
import smtplib
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class Mailbox:
    """IMAP inbox poller (reference utils/imap.py)."""

    def __init__(self, host: str, user: str, password: str, *,
                 folder: str = "INBOX", fetch_fn: Optional[Callable] = None):
        self.host = host
        self.user = user
        self.password = password
        self.folder = folder
        self._fetch_fn = fetch_fn

    def fetch_unseen(self) -> list[dict]:
        """→ [{uid, from, subject, body}]"""
        if self._fetch_fn:
            return self._fetch_fn()
        import imaplib

        conn = imaplib.IMAP4_SSL(self.host)
        try:
            conn.login(self.user, self.password)
            conn.select(self.folder)
            _typ, data = conn.search(None, "UNSEEN")
            out = []
            for uid in (data[0] or b"").split():
                _typ, msg_data = conn.fetch(uid, "(RFC822)")
                msg = email.message_from_bytes(msg_data[0][1])
                body = ""
                if msg.is_multipart():
                    for part in msg.walk():
                        if part.get_content_type() == "text/plain":
                            body = part.get_payload(decode=True).decode(
                                "utf-8", "replace")
                            break
                else:
                    body = msg.get_payload(decode=True).decode(
                        "utf-8", "replace")
                out.append({"uid": uid.decode(), "from": msg.get("From"),
                            "subject": msg.get("Subject", ""), "body": body})
            return out
        finally:
            conn.logout()


class MailSender:
    """SMTP sender (reference utils/sender.py)."""

    def __init__(self, host: str, *, port: int = 587, user: str = "",
                 password: str = "", from_addr: str = "",
                 send_fn: Optional[Callable] = None):
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.from_addr = from_addr or user
        self._send_fn = send_fn

    def send(self, to: str, subject: str, body: str) -> None:
        if self._send_fn:
            return self._send_fn(to, subject, body)
        msg = email.message.EmailMessage()
        msg["From"] = self.from_addr
        msg["To"] = to
        msg["Subject"] = subject
        msg.set_content(body)
        with smtplib.SMTP(self.host, self.port) as s:
            s.starttls()
            if self.user:
                s.login(self.user, self.password)
            s.send_message(msg)


class RedmineMailer:
    """The composition: inbox → ticket → agent draft note → ack mail
    (reference redmine.py:171)."""

    def __init__(self, *, mailbox: Mailbox, sender: MailSender,
                 redmine_client, agent_archi=None,
                 project_id: str = "support"):
        self.mailbox = mailbox
        self.sender = sender
        self.redmine = redmine_client
        self.agent = agent_archi
        self.project_id = project_id
        self.processed: set[str] = set()

    def step(self) -> int:
        n = 0
        for mail in self.mailbox.fetch_unseen():
            if mail["uid"] in self.processed:
                continue
            try:
                ticket = self.redmine.create_issue(
                    self.project_id, mail["subject"],
                    f"From: {mail['from']}\n\n{mail['body']}",
                )
                if self.agent is not None:
                    draft = self.agent.invoke(
                        history=[("User",
                                  f"{mail['subject']}\n\n{mail['body']}")]
                    ).answer
                    self.redmine.add_note(ticket["id"], f"[AI draft]\n{draft}",
                                          private=True)
                if mail["from"]:
                    self.sender.send(
                        mail["from"],
                        f"Re: {mail['subject']} [#{ticket['id']}]",
                        "Your request has been received and a ticket was "
                        f"opened (#{ticket['id']}). We'll get back to you.",
                    )
                self.processed.add(mail["uid"])
                n += 1
            except Exception as e:
                logger.warning("mailer failed for %s: %s", mail["uid"], e)
        return n


class RedmineIssueProcessor:
    """Redmine-side polling loop (the ``service_redmine`` companion to the
    IMAP-side mailer — reference ``src/bin/service_redmine.py``:
    ``process_new_issues`` / ``process_resolved_issues``).

    - NEW issues: run the agent over subject+description, append the draft
      as a private note (once per issue).
    - RESOLVED issues: mail the reporter the resolution (once per issue).
    Transports (issue listing, write client, sender) are injectable.
    """

    def __init__(self, *, list_issues: Callable, redmine_client,
                 agent_archi=None, sender: Optional[MailSender] = None,
                 project_id: str = "support"):
        self.list_issues = list_issues  # (status: str) -> [issue dicts]
        self.redmine = redmine_client
        self.agent = agent_archi
        self.sender = sender
        self.project_id = project_id
        self.drafted: set[int] = set()
        self.notified: set[int] = set()

    def process_new_issues(self) -> int:
        n = 0
        for issue in self.list_issues("open"):
            iid = int(issue["id"])
            if iid in self.drafted or self.agent is None:
                continue
            try:
                q = f"{issue.get('subject', '')}\n\n" \
                    f"{issue.get('description', '')}".strip()
                draft = self.agent.invoke(history=[("User", q)]).answer
                self.redmine.add_note(iid, f"[AI draft]\n{draft}",
                                      private=True)
                self.drafted.add(iid)
                n += 1
            except Exception as e:
                logger.warning("redmine draft failed for #%s: %s", iid, e)
        return n

    def process_resolved_issues(self) -> int:
        n = 0
        for issue in self.list_issues("resolved"):
            iid = int(issue["id"])
            if iid in self.notified:
                continue
            reporter = (issue.get("author") or {}).get("mail") or \
                issue.get("reporter_email")
            try:
                if reporter and self.sender is not None:
                    notes = [j.get("notes", "") for j in
                             issue.get("journals", []) if j.get("notes")]
                    body = notes[-1] if notes else "Your issue was resolved."
                    self.sender.send(
                        reporter,
                        f"Re: {issue.get('subject', '')} [#{iid}] resolved",
                        body,
                    )
                self.notified.add(iid)
                n += 1
            except Exception as e:
                logger.warning("redmine notify failed for #%s: %s", iid, e)
        return n

    def step(self) -> int:
        return self.process_new_issues() + self.process_resolved_issues()


class RedmineWriteClient:
    """Ticket creation/notes (the write half; reads live in
    data/collectors/tickets.py RedmineClient)."""

    def __init__(self, base_url: str, *, api_key: str = "",
                 http_post: Optional[Callable] = None,
                 http_put: Optional[Callable] = None):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self._post = http_post
        self._put = http_put

    def _headers(self):
        return {"X-Redmine-API-Key": self.api_key,
                "Content-Type": "application/json"}

    def create_issue(self, project_id: str, subject: str,
                     description: str) -> dict:
        if self._post:
            return self._post("issues", {
                "project_id": project_id, "subject": subject,
                "description": description})
        import requests

        r = requests.post(
            f"{self.base_url}/issues.json", headers=self._headers(),
            json={"issue": {"project_id": project_id, "subject": subject,
                            "description": description}},
            timeout=30,
        )
        r.raise_for_status()
        return r.json()["issue"]

    def add_note(self, issue_id: int, note: str, *,
                 private: bool = False) -> None:
        if self._put:
            return self._put(f"issues/{issue_id}", {"notes": note,
                                                    "private": private})
        import requests

        r = requests.put(
            f"{self.base_url}/issues/{issue_id}.json",
            headers=self._headers(),
            json={"issue": {"notes": note, "private_notes": private}},
            timeout=30,
        )
        r.raise_for_status()
