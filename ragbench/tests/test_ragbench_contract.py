"""BENCHMARK.json keeps to the benchmark's contract: keys, names, units,
bounds, and every metric and file it names found by the harness."""

import json
import os
import re

from ragbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = json.load(open(path))
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["ragbench"] and all(_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("ragbench/")
        assert json.load(open(os.path.join(spec.ROOT, c["file"])))[
            "reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        cell = spec.cell(w["name"], b)
        assert cell.traffic_module() is not None
    names = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert os.path.exists(os.path.join(
            spec.HERE, "layer_metrics", m["name"] + ".py"))
        names.add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len(names) == len(b["end_to_end"]) + len(b["per_layer"])
    for c in cells:
        cell = spec.cell(c, b)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
