"""Metrics registry + Prometheus text exposition.

Copy of ``archi_tpu/utils/metrics.py``.

The reference's observability is a Grafana service reading Postgres tables
directly (SURVEY.md §5.5: ``init.sql:534-559``, provisioned dashboard).
Here services additionally expose a ``/metrics`` endpoint in Prometheus
text format, fed by this in-process registry (counters, gauges, simple
histograms), so the same Grafana can scrape either plane.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hist: dict[tuple, list] = {}  # key -> [count, sum, bucket_counts]

    @staticmethod
    def _key(name: str, labels: Optional[dict]) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[dict] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def counter_value(self, name: str,
                      labels: Optional[dict] = None) -> float:
        """Current counter value (0.0 if never incremented) — tests and
        internal consumers; the exposition path is /metrics."""
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            if k not in self._hist:
                self._hist[k] = [0, 0.0, [0] * len(_BUCKETS)]
            h = self._hist[k]
            h[0] += 1
            h[1] += value
            for i, b in enumerate(_BUCKETS):
                if value <= b:
                    h[2][i] += 1

    class _Timer:
        def __init__(self, registry, name, labels):
            self.registry, self.name, self.labels = registry, name, labels

        def __enter__(self):
            self.t0 = time.time()
            return self

        def __exit__(self, *exc):
            self.registry.observe(self.name, time.time() - self.t0,
                                  self.labels)

    def timer(self, name: str, labels: Optional[dict] = None) -> "_Timer":
        return self._Timer(self, name, labels)

    # ------------------------------------------------------------ exposition
    @staticmethod
    def _fmt_labels(label_items) -> str:
        if not label_items:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in label_items)
        return "{" + inner + "}"

    def render(self) -> str:
        lines = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{name}_total{self._fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), (count, total, buckets) in sorted(
                    self._hist.items()):
                for i, b in enumerate(_BUCKETS):
                    lab = dict(labels)
                    lab["le"] = str(b)
                    lines.append(
                        f"{name}_bucket{self._fmt_labels(sorted(lab.items()))}"
                        f" {buckets[i]}")
                lab = dict(labels)
                lab["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{self._fmt_labels(sorted(lab.items()))}"
                    f" {count}")
                lines.append(f"{name}_sum{self._fmt_labels(labels)} {total}")
                lines.append(f"{name}_count{self._fmt_labels(labels)} {count}")
        return "\n".join(lines) + "\n"


#: process-wide default registry
METRICS = MetricsRegistry()
