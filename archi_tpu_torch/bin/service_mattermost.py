"""Mattermost bot entry point: answer a channel's posts over the port's
store.

Counterpart of ``archi_tpu/bin/service_mattermost.py`` (reference
``src/bin/service_mattermost.py``), over the port's ``build_context``, on
the card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_mattermost config.yaml

Env: MATTERMOST_URL, MATTERMOST_TOKEN, MATTERMOST_CHANNEL, POLL_SECONDS.
``build_bot`` returns the bot and its context without polling, so a caller
can hand it its own transports (``fetch_fn``, ``post_fn``) and drive
``step()``; ``main`` only polls.
"""

from __future__ import annotations

import os
import sys

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.bots import MattermostBot


def build_bot(config_paths=(), overrides=None, ctx=None, *, device=None,
              devices=None, **transport):
    """→ (bot, ctx).  ``transport``: ``MattermostBot``'s ``fetch_fn`` and
    ``post_fn`` (default: the Mattermost API over ``requests``)."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    archi = Archi(ctx.config.get("active_pipeline", "QAPipeline"),
                  config=ctx.config, vectorstore=ctx.vectorstore)
    bot = MattermostBot(
        archi,
        base_url=os.environ.get("MATTERMOST_URL", ""),
        token=os.environ.get("MATTERMOST_TOKEN", ""),
        channel_id=os.environ.get("MATTERMOST_CHANNEL", ""),
        poll_seconds=float(os.environ.get("POLL_SECONDS", "60")),
        **transport,
    )
    return bot, ctx


def main() -> None:
    bot, _ctx = build_bot(sys.argv[1:])
    print("mattermost bot polling")
    bot.run_forever()


if __name__ == "__main__":
    main()
