"""The port's span recorder (``archi_tpu_torch/utils/tracing.py``) and the
spans of its query path, on the CPU.

- Off, a span is one shared object: no clock read, no record, no
  ``record_function``.
- ``enable()``, ``ARCHI_TRACE=1`` and a recording ``torch.profiler`` (with
  the benchmark's schedule: on only once it steps into recording) switch
  it on.
- Records carry parent and thread, the thread's CPU time within the wall
  time; the scheduler's queue span runs from submit to the batch's start.
- A hybrid and a semantic micro-batch give the span tree of the query
  path, with its ``wait`` spans; under a profiler the spans are ``archi.*``
  annotations of the Chrome trace with the recorder's durations.
- A full ring counts what it drops.
- BM25's ingest spans: ``bm25.add`` a batch and ``bm25.build`` a full
  build, with their counts, totalled by ``torch_span_breakdown``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from archi_tpu_torch.engine.batcher import MicroBatcher
from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.models.bert import BertConfig
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer
from archi_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(vocab_size=600, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=128)
WORDS = ("tpu gpu kernel tensor matrix vector index search query lexical "
         "semantic hybrid ranking score embed encoder token batch").split()
QUERIES = ["hybrid ranking score", "gpu kernel", "zzz qqq unmatched"]

#: (span, its parent) on the query path, by search kind; the scheduler's
#: ``batcher.batch`` is the root of each micro-batch
TREE = {
    "semantic": {
        ("store.embed", "batcher.batch"),
        ("embed.tokenize", "store.embed"),
        ("embed.encode", "store.embed"),
        ("embed.upload", "embed.encode"),
        ("embed.readback", "store.embed"),
        ("store.filter", "batcher.batch"),
        ("store.scan", "batcher.batch"),
        ("index.dispatch", "store.scan"),
        ("index.upload", "index.dispatch"),
        ("index.readback", "store.scan"),
        ("store.results", "batcher.batch"),
    },
}
TREE["hybrid"] = TREE["semantic"] | {
    ("store.bm25", "batcher.batch"),
    ("bm25.scores", "store.bm25"),
    ("bm25.analyze", "bm25.scores"),
    ("bm25.worklist", "bm25.scores"),
    ("bm25.upload", "bm25.scores"),
    ("bm25.scatter", "bm25.scores"),
}
WAITS = {"embed.upload", "embed.readback", "index.upload", "index.readback"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts with recording off and an empty ring."""
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(WORDS, rng.integers(4, 12)))
             for _ in range(40)]
    tok = WordPieceTokenizer.build_vocab(texts, size=CFG["vocab_size"])
    emb = TorchEmbedder(config=BertConfig(**CFG), tokenizer=tok, device="cpu")
    st = TorchVectorStore(emb, dtype=torch.float32, device="cpu")
    st.add_texts(texts, ids=[f"doc-{i}" for i in range(len(texts))])
    # one micro-batch of all the queries: the scheduler takes them once
    # the batch is full, and lingers long enough for them to arrive
    st.enable_micro_batching(max_batch=len(QUERIES), max_wait_ms=2000.0,
                             workers=1)
    yield st
    st._batcher.close()


def _search(store, kind: str, queries=QUERIES):
    """One micro-batch of the queries through the scheduler."""
    fn = store.hybrid_search if kind == "hybrid" else \
        store.similarity_search_with_score
    out = [None] * len(queries)

    def one(i):
        out[i] = fn(queries[i], k=3)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out)
    return out


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while tracing is off")


def test_off_span_is_one_shared_object_and_records_nothing(monkeypatch):
    def no_annotation(*a, **kw):
        raise AssertionError("record_function entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", no_annotation)
    monkeypatch.setattr(tracing, "time", _NoClock())
    assert not tracing.enabled()
    first = tracing.span("store.bm25")
    for name in ("store.scan", "embed.readback"):
        with tracing.span(name, wait=True) as s:
            assert s is first and not s.recording
            s.set(batch=1)
    tracing.record("batcher.queue", 0, 1, request=1)
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_enable_switches_recording():
    with tracing.span("a"):
        pass
    tracing.enable()
    assert tracing.enabled()
    with tracing.span("b", wait=True) as s:
        assert s.recording
        s.set(size=3)
    tracing.enable(False)
    with tracing.span("c"):
        pass
    (rec,) = tracing.spans()
    assert rec.name == "b" and rec.wait and rec.attrs == {"wait": True,
                                                          "size": 3}


@pytest.mark.parametrize("value, on", [("1", True), ("0", False),
                                       (None, False)])
def test_archi_trace_environment(value, on):
    env = {k: v for k, v in os.environ.items() if k != "ARCHI_TRACE"}
    if value is not None:
        env["ARCHI_TRACE"] = value
    code = ("from archi_tpu_torch.utils import tracing\n"
            "with tracing.span('x'):\n    pass\n"
            "print(tracing.enabled(), len(tracing.spans()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(on), str(int(on))]


def test_profiler_switches_recording_once_it_records():
    """The benchmark arms its profiler in set-up (wait 0, warmup 1,
    active 1) and steps it into recording at the slice: spans record only
    from that step to the stop, read from torch's own flag."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1))
    prof.start()
    try:
        assert not tracing.enabled()
        with tracing.span("warmup"):
            pass
        prof.step()
        assert tracing.enabled()
        with tracing.span("slice"):
            pass
    finally:
        prof.stop()
    assert not tracing.enabled()
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.spans()] == ["slice"]


def test_parents_threads_and_cpu_time():
    tracing.enable()
    ids = {}

    def work(tag):
        with tracing.span("outer") as o:
            with tracing.span("inner") as i:
                sum(range(200_000))
                time.sleep(0.02)
            ids[tag] = (o.id, i.id, threading.get_ident())

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = {s.id: s for s in tracing.spans()}
    assert len(recs) == 4
    for outer, inner, thread in ids.values():
        assert recs[outer].parent is None and recs[inner].parent == outer
        assert recs[outer].thread == recs[inner].thread == thread
        for r in (recs[outer], recs[inner]):
            assert 0 < r.cpu_ns <= r.wall_ns
        assert recs[inner].wall_ns - recs[inner].cpu_ns >= 15_000_000
        assert recs[outer].start_ns <= recs[inner].start_ns \
            <= recs[inner].end_ns <= recs[outer].end_ns


def test_spans_filter_by_end():
    tracing.enable()
    with tracing.span("early"):
        pass
    t0 = time.perf_counter()
    with tracing.span("late"):
        pass
    t1 = time.perf_counter()
    assert [s.name for s in tracing.spans(t0, t1)] == ["late"]
    assert [s.name for s in tracing.spans(None, t0)] == ["early"]


def test_queue_span_runs_from_submit_to_batch_start():
    """A request queued before recording began still gets its whole queue
    span, which names its batch."""
    gate, started = threading.Event(), threading.Event()

    def run(sig, payloads):
        if payloads == ["first"]:
            started.set()
            gate.wait(30)
        return list(payloads)

    mb = MicroBatcher(run, max_batch=4, max_wait_s=0.001, workers=1)
    try:
        first = threading.Thread(target=mb.submit, args=("first",))
        first.start()
        assert started.wait(30)
        t_before = time.perf_counter_ns()
        second = threading.Thread(target=mb.submit, args=("second", ("hybrid",)))
        second.start()
        while not mb._queue:
            time.sleep(0.001)
        time.sleep(0.02)
        t_enable = time.perf_counter_ns()
        tracing.enable()
        gate.set()
        for t in (first, second):
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        mb.close()
    recs = tracing.spans()
    (queued,) = [s for s in recs if s.name == "batcher.queue"]
    (batch,) = [s for s in recs if s.name == "batcher.batch"]
    assert t_before <= queued.start_ns <= t_enable
    assert queued.end_ns == batch.start_ns
    assert queued.wall_ns >= 20_000_000
    assert queued.attrs["batch"] == batch.attrs["batch"] == batch.id
    assert queued.attrs["depth"] == 0 and queued.attrs["request"] > 0
    assert batch.attrs["size"] == 1 and batch.attrs["kind"] == "hybrid"


@pytest.mark.parametrize("kind", ["hybrid", "semantic"])
def test_batch_span_tree(store, kind):
    _search(store, kind)                          # warm
    tracing.enable()
    _search(store, kind)
    tracing.enable(False)
    recs = tracing.spans()
    by_id = {s.id: s for s in recs}
    (batch,) = [s for s in recs if s.name == "batcher.batch"]
    assert batch.attrs["kind"] == kind and batch.attrs["size"] == len(QUERIES)
    queued = [s for s in recs if s.name == "batcher.queue"]
    assert len(queued) == len(QUERIES)
    assert {s.attrs["batch"] for s in queued} == {batch.id}
    edges = {(s.name, by_id[s.parent].name) for s in recs
             if s.parent is not None}
    assert edges == TREE[kind]
    assert {s.name for s in recs if s.wait} == WAITS & {c for c, _ in edges}
    for s in recs:
        if s.wait:      # no wait span counts inside another
            p = s.parent
            while p is not None:
                assert not by_id[p].wait
                p = by_id[p].parent
    if kind == "hybrid":
        # one pass scores the micro-batch
        (scores,) = [s for s in recs if s.name == "bm25.scores"]
        assert scores.attrs["queries"] == len(QUERIES)
        assert 0 < scores.attrs["pieces"] <= scores.attrs["entries"]
    (dispatch,) = [s for s in recs if s.name == "index.dispatch"]
    assert dispatch.attrs == {"batch": 4, "live": 40,
                              "bias": "per_query" if kind == "hybrid"
                              else "none"}
    (encode,) = [s for s in recs if s.name == "embed.encode"]
    tok = store._embedding_function.tokenizer
    assert encode.attrs["lengths"] == [len(tok.encode(q, 128))
                                       for q in QUERIES]


def test_profiled_batch_annotations_match_the_recorder(store, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):    # warm
        store.hybrid_search_batch(QUERIES, k=3)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        store.hybrid_search_batch(QUERIES, k=3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith(
                  "archi.")]
    recs = tracing.spans()
    assert recs and len(events) == len(recs)
    by_name = {}
    for e in sorted(events, key=lambda e: float(e["ts"])):
        by_name.setdefault(e["name"][len("archi."):], []).append(
            float(e["dur"]) * 1e3)
    pairs = []
    for name, durs in by_name.items():
        mine = [s.wall_ns for s in recs if s.name == name]
        assert len(mine) == len(durs), name
        pairs += [(name, got, want) for got, want in zip(durs, mine)]
    # within 5% or 50 µs; a busy host may preempt a thread between a clock
    # read and the annotation's own, so a tenth of the spans may miss
    off = [p for p in pairs if abs(p[1] - p[2]) > max(0.05 * p[2], 50_000)]
    assert len(off) <= len(pairs) // 10, off
    got, want = sum(p[1] for p in pairs), sum(p[2] for p in pairs)
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_full_ring_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_RING", tracing._Ring(4))
    tracing.enable()
    for i in range(10):
        with tracing.span(f"s{i}"):
            pass
    assert tracing.dropped() == 6
    assert [s.name for s in tracing.spans()] == ["s6", "s7", "s8", "s9"]
    tracing.clear()
    assert tracing.dropped() == 0 and tracing.spans() == []


def test_bm25_ingest_spans():
    """An add is one ``bm25.add`` span with its texts, their terms
    (``tokens``) and the (term, row) entries it made; the first query's
    full build is one ``bm25.build`` span, inside ``bm25.scores``, with the
    entries it published; ``torch_span_breakdown`` totals both."""
    from archi_tpu_torch.engine.bm25 import BM25Index
    from scripts.torch_span_breakdown import setup_totals

    idx = BM25Index(device="cpu")
    tracing.enable()
    idx.add([0, 1], ["gpu kernel gpu", "tensor index and the"])
    idx.add_analyzed([2], [["gpu", "search"]])
    idx.scores("gpu", 8)
    tracing.enable(False)
    recs = tracing.spans()
    by_id = {s.id: s for s in recs}
    adds = [s for s in recs if s.name == "bm25.add"]
    assert [s.attrs for s in adds] == [
        {"texts": 2, "tokens": 5, "entries": 4},
        {"texts": 1, "tokens": 2, "entries": 2}]
    (build,) = [s for s in recs if s.name == "bm25.build"]
    assert build.attrs == {"entries": 6}
    assert by_id[build.parent].name == "bm25.scores"
    totals = setup_totals(recs)
    assert totals["bm25.add"]["count"] == 2
    assert totals["bm25.add"]["entries"] == 6
    assert totals["bm25.add"]["tokens"] == 7
    assert totals["bm25.build"]["entries"] == 6
    assert totals["bm25.build"]["wall_s"] > 0
