"""CronScheduler: per-source periodic re-ingestion with live config reload.

Copy of ``archi_tpu/data/scheduler.py``.

Mirrors the reference's ``CronScheduler``
(``src/data_manager/scheduler.py:29``; ``_run_loop:190``,
``set_config_loader:49``): a background thread evaluates standard 5-field
cron expressions once per minute; a config-loader callback is polled and a
schedule-set hash (md5 in the reference) detects changes and reloads jobs.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    vals: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/")
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-")
            start, end = int(a), int(b)
        else:
            start = end = int(part)
            if step > 1:  # "5/15" means every 15 starting at 5
                end = hi
        vals.update(range(start, end + 1, step))
    return {v for v in vals if lo <= v <= hi}


@dataclass
class CronExpr:
    minute: set[int]
    hour: set[int]
    dom: set[int]
    month: set[int]
    dow: set[int]

    @classmethod
    def parse(cls, expr: str) -> "CronExpr":
        parts = expr.split()
        if len(parts) != 5:
            raise ValueError(f"bad cron expression: {expr!r}")
        dow = _parse_field(parts[4], 0, 7)
        if 7 in dow:  # cron allows 0 or 7 for Sunday
            dow = (dow - {7}) | {0}
        return cls(
            _parse_field(parts[0], 0, 59),
            _parse_field(parts[1], 0, 23),
            _parse_field(parts[2], 1, 31),
            _parse_field(parts[3], 1, 12),
            dow,
        )

    def matches(self, t: time.struct_time) -> bool:
        # cron dow: Sunday=0; struct_time tm_wday: Monday=0
        cron_dow = (t.tm_wday + 1) % 7
        return (
            t.tm_min in self.minute
            and t.tm_hour in self.hour
            and t.tm_mday in self.dom
            and t.tm_mon in self.month
            and cron_dow in self.dow
        )


@dataclass
class Job:
    name: str
    expr: CronExpr
    fn: Callable[..., None]
    last_run: Optional[float] = None


class CronScheduler:
    def __init__(self, *, tick_seconds: float = 30.0):
        self.tick_seconds = tick_seconds
        self._jobs: dict[str, Job] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._config_loader: Optional[Callable[[], dict]] = None
        self._config_hash: Optional[str] = None
        self._job_factory: Optional[Callable[[str, dict], Callable]] = None

    # ------------------------------------------------------------------ jobs
    def add_job(self, name: str, cron: str, fn: Callable[..., None]) -> None:
        with self._lock:
            self._jobs[name] = Job(name, CronExpr.parse(cron), fn)

    def remove_job(self, name: str) -> None:
        with self._lock:
            self._jobs.pop(name, None)

    def jobs(self) -> list[str]:
        with self._lock:
            return list(self._jobs)

    # ------------------------------------------------------- config reload
    def set_config_loader(
        self,
        loader: Callable[[], dict],
        job_factory: Callable[[str, dict], Callable],
    ) -> None:
        """loader() → {name: {"cron": expr, ...}}; factory(name, cfg) → fn.
        A schedule-set hash detects changes (reference md5 detection,
        scheduler.py / service_data_manager.py:125-131)."""
        self._config_loader = loader
        self._job_factory = job_factory
        self._reload_config()

    def _reload_config(self) -> None:
        if not self._config_loader:
            return
        try:
            cfg = self._config_loader() or {}
        except Exception as e:
            logger.warning("schedule config load failed: %s", e)
            return
        digest = hashlib.md5(
            json.dumps(cfg, sort_keys=True, default=str).encode()
        ).hexdigest()
        if digest == self._config_hash:
            return
        self._config_hash = digest
        with self._lock:
            self._jobs.clear()
        for name, spec in cfg.items():
            cron = spec.get("cron") if isinstance(spec, dict) else str(spec)
            if not cron:
                continue
            try:
                self.add_job(name, cron, self._job_factory(name, spec))
            except ValueError as e:
                logger.warning("bad schedule for %s: %s", name, e)
        logger.info("schedules reloaded: %s", self.jobs())

    # ------------------------------------------------------------------ loop
    def _tick(self, now: Optional[float] = None) -> list[str]:
        """Run due jobs; returns names run (factored out for tests)."""
        now = now if now is not None else time.time()
        t = time.localtime(now)
        ran = []
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            # fire at most once per minute slot
            if job.last_run is not None and now - job.last_run < 60:
                continue
            if job.expr.matches(t):
                job.last_run = now
                ran.append(job.name)
                # decide by signature, not by catching TypeError — a job
                # body raising TypeError must not trigger a second run
                import inspect

                try:
                    params = inspect.signature(job.fn).parameters
                    accepts_last_run = "last_run" in params or any(
                        p.kind == inspect.Parameter.VAR_KEYWORD
                        for p in params.values()
                    )
                except (TypeError, ValueError):
                    accepts_last_run = False
                try:
                    if accepts_last_run:
                        job.fn(last_run=job.last_run)
                    else:
                        job.fn()
                except Exception as e:
                    logger.exception("job %s failed: %s", job.name, e)
        return ran

    def _run_loop(self) -> None:
        while not self._stop.wait(self.tick_seconds):
            self._reload_config()
            self._tick()

    def start(self) -> None:
        if self._thread and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="cron-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
