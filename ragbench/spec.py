"""What a run measures, found by name from ``BENCHMARK.json`` and files.

- ``cells/<cell>.json``: the cell's configuration and traffic mix (they must
  agree with the cell's entry in ``BENCHMARK.json``);
- ``configs/<config>.json``: the deployment;
- ``traffic/<mix>.json``: the mix, whose ``kind`` names the generator
  module ``traffic/<kind>.py``;
- ``layer_metrics/<metric>.py``: one reader a per-layer metric.

The end-to-end and per-layer metrics a cell reports are the entries of
``BENCHMARK.json`` that list the cell under ``workloads``, or that have no
such key.  A new cell, mix, configuration or metric is new files and new
entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "ragbench._found." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    here: str = HERE

    def traffic_module(self):
        kind = self.traffic["kind"]
        return load_module(os.path.join(self.here, "traffic", f"{kind}.py"),
                           kind)

    def layer_reader(self, metric: str):
        return load_module(
            os.path.join(self.here, "layer_metrics", f"{metric}.py"), metric)


def cell(name: str, bench: dict | None = None, here: str = HERE) -> Cell:
    """The cell by name, with its configuration, mix and metrics."""
    bench = bench if bench is not None else benchmark(os.path.dirname(here))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    cell_file = _load_json(os.path.join(here, "cells", f"{name}.json"))
    for key in ("config", "traffic"):
        if cell_file[key] != w[key]:
            raise ValueError(f"cells/{name}.json says {key} "
                             f"{cell_file[key]!r}, BENCHMARK.json {w[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(os.path.dirname(here),
                                     configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=cell_file.get("limits", {}), here=here)
