"""The port's ``/metrics`` text (``archi_tpu_torch/utils/metrics.py``)
against the dashboard it ships (``assets/grafana_dashboard.json``).

Every metric the port writes (found in its source: ``METRICS.inc``,
``set_gauge``, ``observe`` and ``timer`` with a literal name) is written
once into a fresh registry; each series the dashboard queries is then in
the rendered text, and a counter is exposed as ``<name>_total`` once,
whether or not the port's name already ends in ``_total``.
"""

import ast
import json
import pathlib
import re
import time

import pytest

from archi_tpu_torch.utils.metrics import MetricsRegistry

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "archi_tpu_torch"
#: the counters the benchmark reads by these names
BENCHMARK_COUNTERS = ("archi_micro_batches_total",
                      "archi_micro_batched_requests_total",
                      "archi_fused_topk_fallbacks_total")


def _written():
    """(method, metric name, label keys) of every literal write to
    ``METRICS`` in the port."""
    out = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "METRICS" \
                    and node.args and isinstance(node.args[0], ast.Constant):
                labels = ()
                for kw in node.keywords:
                    if kw.arg == "labels" and isinstance(kw.value, ast.Dict):
                        labels = tuple(k.value for k in kw.value.keys)
                out.add((node.func.attr, node.args[0].value, labels))
    return out


def _rendered_names(text: str) -> list:
    return [re.match(r"[A-Za-z_:][A-Za-z0-9_:]*", line).group(0)
            for line in text.splitlines() if line]


def _dashboard_series() -> set:
    dash = json.loads((PORT / "assets" / "grafana_dashboard.json").read_text())
    exprs = re.findall(r'"expr":\s*"((?:[^"\\]|\\.)*)"', json.dumps(dash))
    return {name for e in exprs for name in re.findall(r"archi_[a-z_]+", e)}


def _registry_of_the_port() -> MetricsRegistry:
    reg = MetricsRegistry()
    for method, name, labels in sorted(_written()):
        lab = {k: "x" for k in labels} or None
        if method == "inc":
            reg.inc(name, labels=lab)
        elif method == "set_gauge":
            reg.set_gauge(name, 1.0, labels=lab)
        elif method in ("observe", "timer"):
            reg.observe(name, 0.1, labels=lab)
    return reg


def test_the_port_writes_what_the_dashboard_reads():
    written = {name for _, name, _ in _written()}
    assert set(BENCHMARK_COUNTERS) <= written
    names = set(_rendered_names(_registry_of_the_port().render()))
    missing = _dashboard_series() - names
    assert not missing, f"the dashboard queries series /metrics lacks: {missing}"


@pytest.mark.parametrize("name", BENCHMARK_COUNTERS + ("archi_chat_messages",))
def test_a_counter_renders_total_once(name):
    reg = MetricsRegistry()
    reg.inc(name, value=3)
    reg.inc(name, labels={"kind": "hybrid"})
    names = _rendered_names(reg.render())
    total = name if name.endswith("_total") else name + "_total"
    assert names == [total, total]
    assert not any(n.endswith("_total_total") for n in names)
    assert reg.counter_value(name) == 3       # read under the port's name


def test_timer_runs_on_the_monotonic_clock(monkeypatch):
    def stepped(*a):
        raise AssertionError("time.time read by the timer")

    monkeypatch.setattr(time, "time", stepped)
    reg = MetricsRegistry()
    with reg.timer("archi_chat_duration_seconds"):
        time.sleep(0.01)
    text = reg.render()
    (total,) = re.findall(r"archi_chat_duration_seconds_sum (\S+)", text)
    assert 0.005 <= float(total) < 5.0
