"""Cells cut to a size a CPU test run holds: few documents and rows, two
encoder layers unless a test asks for the published depth, a low rate, a
short window.  Widths stay as published."""

from __future__ import annotations

import json
import os
import time

from ragbench import run as rb_run
from ragbench import spec

SEED = 2 ** 33 + 12345

#: entries of cells whose files are here but whose runs on the card are not
#: yet steady enough for a bound; a later PR moves them into BENCHMARK.json
#: with bounds from its own runs
HELD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "held_cells.json")


def with_held(bench: dict) -> dict:
    """``bench`` with the held cells' entries added."""
    with open(HELD) as f:
        held = json.load(f)
    return {**bench, **{k: bench[k] + held[k] for k in held}}


def small_cell(name: str, bench=None, here=spec.HERE, layers=2):
    c = spec.cell(name, with_held(bench or spec.benchmark()), here)
    cor = c.config["corpus"]
    cor["row_block"] = 1024
    cor["vocabulary_words"] = 5000
    if "documents" in cor:
        cor["documents"] = 1200
    if layers is not None:
        c.config["encoder"]["num_hidden_layers"] = layers
    c.traffic["check_sample"] = 24
    if c.traffic["kind"] == "open_loop":
        c.traffic["rate_per_s"] = 20
    return c


def run_small(cell, *, seed: int = SEED, seconds: float = 1.5,
              trace: bool = False, control: bool = False) -> dict:
    return rb_run.run_cell(cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), control=control)
