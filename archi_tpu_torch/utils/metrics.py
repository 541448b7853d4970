"""Metrics registry + Prometheus text exposition.

Copy of ``archi_tpu/utils/metrics.py``, plus ``use_registry``: a service
that renders another registry on its ``/metrics`` (the JAX package's
data-manager app renders ``archi_tpu.utils.metrics.METRICS``) hands it to
the port, and every counter the port writes lands there::

    from archi_tpu.utils.metrics import METRICS as service_metrics
    archi_tpu_torch.utils.metrics.use_registry(service_metrics)

``METRICS`` forwards to the registry in use, so modules that bound it at
import time follow the switch.

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
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.registry.observe(self.name, time.perf_counter() - self.t0,
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
                # a counter is exposed as <name>_total, once
                total = name if name.endswith("_total") else name + "_total"
                lines.append(f"{total}{self._fmt_labels(labels)} {v}")
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


class _Forward:
    """Forwards every attribute to the registry in use."""

    def __init__(self, registry):
        self.target = registry

    def __getattr__(self, name):
        return getattr(self.target, name)


_OWN = MetricsRegistry()

#: the process-wide registry the port writes to (its own unless a caller
#: handed it another through ``use_registry``)
METRICS = _Forward(_OWN)


def use_registry(registry=None):
    """Write the port's metrics to ``registry`` (any object with the
    ``MetricsRegistry`` methods); ``None`` returns to the port's own.
    Returns the registry in use before."""
    previous = METRICS.target
    METRICS.target = _OWN if registry is None else registry
    return previous
