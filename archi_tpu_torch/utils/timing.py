"""Per-message latency decomposition.

Copy of ``archi_tpu/utils/timing.py``.

Mirrors the reference's 10-timestamp ``timing`` rows
(``src/cli/templates/init.sql:421-434``, written by ``ChatWrapper``
``app.py:1187,1283``): client_sent → server_received → lock_acquisition →
vectorstore_update → query_convo_history → chain_finished → ... →
msg_duration.  ``TimingRecorder`` stamps named stages and computes the
stage/total durations for storage and dashboards.
"""

from __future__ import annotations

import time
from typing import Optional

STAGES = (
    "client_sent",
    "server_received",
    "lock_acquisition",
    "vectorstore_update",
    "query_convo_history",
    "chain_started",
    "chain_finished",
    "response_sent",
    "inserts_finished",
)


class TimingRecorder:
    def __init__(self, client_sent: Optional[float] = None):
        self.stamps: dict[str, float] = {}
        if client_sent is not None:
            self.stamps["client_sent"] = client_sent

    def stamp(self, stage: str, t: Optional[float] = None) -> None:
        self.stamps[stage] = t if t is not None else time.time()

    def durations(self) -> dict[str, float]:
        """Consecutive stage deltas + msg_duration total."""
        out: dict[str, float] = {}
        ordered = [(s, self.stamps[s]) for s in STAGES if s in self.stamps]
        for (a, ta), (b, tb) in zip(ordered, ordered[1:]):
            out[f"{a}_to_{b}"] = round(tb - ta, 6)
        if len(ordered) >= 2:
            out["msg_duration"] = round(ordered[-1][1] - ordered[0][1], 6)
        return out

    def to_dict(self) -> dict:
        return {"stamps": dict(self.stamps), **self.durations()}
