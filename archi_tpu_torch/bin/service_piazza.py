"""Piazza bot entry point: draft answers to a class's posts over the port's
store.

Counterpart of ``archi_tpu/bin/service_piazza.py`` (reference
``src/bin/service_piazza.py``), over the port's ``build_context``, on the
card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_piazza config.yaml

Env: PIAZZA_NETWORK_ID, SLACK_WEBHOOK (where the drafts go), POLL_SECONDS.
``build_bot`` returns the bot and its context without polling, so a caller
can hand it its own transports (``fetch_fn``, ``post_fn``) and drive
``step()``; ``main`` only polls.
"""

from __future__ import annotations

import os
import sys

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.bots import PiazzaBot


def build_bot(config_paths=(), overrides=None, ctx=None, *, device=None,
              devices=None, **transport):
    """→ (bot, ctx).  ``transport``: ``PiazzaBot``'s ``fetch_fn`` and
    ``post_fn`` (default: Piazza's API and the Slack webhook over
    ``requests``)."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    archi = Archi(ctx.config.get("active_pipeline", "QAPipeline"),
                  config=ctx.config, vectorstore=ctx.vectorstore)
    bot = PiazzaBot(
        archi,
        network_id=os.environ.get("PIAZZA_NETWORK_ID", ""),
        slack_webhook=os.environ.get("SLACK_WEBHOOK"),
        poll_seconds=float(os.environ.get("POLL_SECONDS", "60")),
        **transport,
    )
    return bot, ctx


def main() -> None:
    bot, _ctx = build_bot(sys.argv[1:])
    print("piazza bot polling")
    bot.run_forever()


if __name__ == "__main__":
    main()
