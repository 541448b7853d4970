"""The per-layer metrics that read the program's own spans
(``archi_tpu_torch/utils/tracing.py``): a traced small run of the hybrid
cell on the CPU reports them, and each reader gives None, without
raising, where there is nothing to read: an empty ring, a ring that let
spans go, or a program that has no span recorder."""

import json
import os
import sys
import types

import pytest

import archi_tpu_torch.utils
from archi_tpu_torch.utils import tracing
from ragbench import spec
from ragbench.tests._small import run_small, small_cell

#: the seven readers, by whether the CPU run has what they read (the
#: kernels' roofline needs a device trace of the card's kernels)
SPAN_METRICS = ["sched.queue_wait_ms.query", "lexical.scores_ms.query",
                "lexical.offcpu_ms.query", "embed.batch_ms.query",
                "store.device_wait_ms.query", "store.mfu.query"]
DEVICE_METRICS = ["topk.kernel_roofline.query"]
ALL = SPAN_METRICS + DEVICE_METRICS


def _layer_data(t0, t1, device=None):
    c = spec.cell("trec-covid.hybrid")
    cfg = c.config
    return types.SimpleNamespace(
        tracer=types.SimpleNamespace(slice=(t0, t1), device=device),
        kind="hybrid", k=cfg["archi"]["retrievers"]["hybrid"]["k"],
        dim=cfg["encoder"]["hidden_size"], index_dtype=cfg["index"]["dtype"],
        encoder=cfg["encoder"])


def _read(name, d):
    return spec.cell("trec-covid.hybrid").layer_reader(name).read(d)


def test_benchmark_lists_the_seven():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ALL:
        m = entries[name]
        assert m["workloads"] == ["trec-covid.hybrid"]
        assert m["moves"] == "queries_per_s"


def test_traced_hybrid_run_reports_them():
    tracing.clear()
    cell = small_cell("trec-covid.hybrid")
    # a slice long enough to hold whole micro-batches on a busy CPU
    cell.traffic["trace_start"] = 0.25
    res = run_small(cell, trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in SPAN_METRICS:
        assert name in m and m[name]["value"] >= 0, name
    assert 0 < m["store.mfu.query"]["value"] < 100
    assert m["lexical.offcpu_ms.query"]["value"] \
        <= m["lexical.scores_ms.query"]["value"]
    # the kernels' share reads a card's device trace: given one, it reads
    # the shapes of the run's own scans
    recs = tracing.spans()
    d = _layer_data(recs[0].start_ns / 1e9, recs[-1].end_ns / 1e9, device={
        "kernel_s": {"tc_topk_partial_kernel<bf16>": 0.010,
                     "topk_merge_kernel<bf16>": 0.002},
        "kernel_n": {"tc_topk_partial_kernel<bf16>": 10}})
    roof = _read("topk.kernel_roofline.query", d)
    assert roof is not None and roof > 0


@pytest.mark.parametrize("name", ALL)
def test_reader_gives_none_with_nothing_to_read(name, monkeypatch):
    device = {"kernel_s": {"topk_partial_kernel": 1.0},
              "kernel_n": {"topk_partial_kernel": 1}}
    tracing.clear()
    assert _read(name, _layer_data(0.0, 1e12, device)) is None   # empty

    # a ring that let spans go
    monkeypatch.setattr(tracing, "_RING", tracing._Ring(2))
    tracing.enable()
    try:
        for n in ("batcher.batch", "store.bm25", "bm25.scores"):
            with tracing.span(n):
                pass
    finally:
        tracing.enable(False)
    assert tracing.dropped() == 1
    assert _read(name, _layer_data(0.0, 1e12, device)) is None

    # a program without the span recorder (the parent of this benchmark)
    monkeypatch.delattr(archi_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "archi_tpu_torch.utils.tracing", None)
    assert _read(name, _layer_data(0.0, 1e12, device)) is None
