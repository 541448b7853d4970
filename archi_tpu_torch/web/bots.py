"""Forum/chat bots: Piazza and Mattermost integrations.

Copy of ``archi_tpu/web/bots.py``.

Mirrors the reference's bots (``src/interfaces/piazza.py:20,60``,
``mattermost.py:17,39``): poll the platform's feed for unanswered posts,
answer via the Archi QA pipeline, post the draft back (to a Slack webhook
for review in the Piazza case, to the channel for Mattermost).  Platform
HTTP calls are injectable for tests/zero-egress runs.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class BaseBot:
    def __init__(self, archi, *, poll_seconds: float = 60.0):
        self.archi = archi
        self.poll_seconds = poll_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.answered: set[str] = set()

    # -- platform interface (override / inject) -----------------------------
    def fetch_unanswered(self) -> list[dict]:  # [{id, question}]
        raise NotImplementedError

    def post_answer(self, item: dict, answer: str) -> None:
        raise NotImplementedError

    # -- loop ---------------------------------------------------------------
    def step(self) -> int:
        n = 0
        for item in self.fetch_unanswered():
            if item["id"] in self.answered:
                continue
            try:
                out = self.archi.invoke(history=[("User", item["question"])])
                self.post_answer(item, out.answer)
                self.answered.add(item["id"])
                n += 1
            except Exception as e:
                logger.warning("bot failed to answer %s: %s", item["id"], e)
        return n

    def run_forever(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            self.step()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class PiazzaBot(BaseBot):
    """Polls a Piazza feed; drafts go to a Slack webhook for human review
    (reference piazza.py posts drafts rather than auto-answering)."""

    def __init__(self, archi, *, network_id: str, session=None,
                 slack_webhook: Optional[str] = None,
                 fetch_fn: Optional[Callable] = None,
                 post_fn: Optional[Callable] = None, **kw):
        super().__init__(archi, **kw)
        self.network_id = network_id
        self.session = session
        self.slack_webhook = slack_webhook
        self._fetch_fn = fetch_fn
        self._post_fn = post_fn

    def fetch_unanswered(self) -> list[dict]:
        if self._fetch_fn:
            return self._fetch_fn()
        import requests

        r = requests.post(
            "https://piazza.com/logic/api?method=network.get_my_feed",
            json={"method": "network.get_my_feed",
                  "params": {"nid": self.network_id, "limit": 50}},
            timeout=30,
        )
        r.raise_for_status()
        feed = (r.json().get("result") or {}).get("feed", [])
        return [
            {"id": p["id"], "question": p.get("content_snipet", "")}
            for p in feed
            if p.get("no_answer") or not p.get("has_i_answer")
        ]

    def post_answer(self, item: dict, answer: str) -> None:
        if self._post_fn:
            return self._post_fn(item, answer)
        if self.slack_webhook:
            import requests

            requests.post(self.slack_webhook, json={
                "text": f"Draft answer for post {item['id']}:\n{answer}"
            }, timeout=30)


class MattermostBot(BaseBot):
    """Polls a Mattermost channel and replies in-thread (reference
    mattermost.py:39)."""

    def __init__(self, archi, *, base_url: str = "", token: str = "",
                 channel_id: str = "", fetch_fn: Optional[Callable] = None,
                 post_fn: Optional[Callable] = None, **kw):
        super().__init__(archi, **kw)
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.channel_id = channel_id
        self._fetch_fn = fetch_fn
        self._post_fn = post_fn

    def _headers(self):
        return {"Authorization": f"Bearer {self.token}"}

    def fetch_unanswered(self) -> list[dict]:
        if self._fetch_fn:
            return self._fetch_fn()
        import requests

        r = requests.get(
            f"{self.base_url}/api/v4/channels/{self.channel_id}/posts",
            headers=self._headers(), timeout=30,
        )
        r.raise_for_status()
        posts = r.json().get("posts", {})
        return [
            {"id": pid, "question": p.get("message", ""), "root_id": pid}
            for pid, p in posts.items()
            if not p.get("root_id")  # top-level posts only
        ]

    def post_answer(self, item: dict, answer: str) -> None:
        if self._post_fn:
            return self._post_fn(item, answer)
        import requests

        requests.post(
            f"{self.base_url}/api/v4/posts", headers=self._headers(),
            json={"channel_id": self.channel_id, "message": answer,
                  "root_id": item.get("root_id", "")},
            timeout=30,
        )
