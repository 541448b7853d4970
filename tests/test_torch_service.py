"""End-to-end micro-batched serving on the port's store: the port's
counterpart of ``tests/integration/test_micro_batch_serving.py``.

``archi_tpu_torch.bin.bootstrap.build_vectorstore(dm_cfg, device="cpu")``
builds the store; the JAX package's framework-free upper layers take it
through ``build_context(vectorstore=...)``: a local directory is ingested
by the data manager and ``/api/query/hybrid`` is served by the
data-manager app.  For flat, hot_tail, ivf and ivfpq_xl, concurrent HTTP
queries coalesce (the port's METRICS: mean batch > 1), batched results
equal an unbatched port stack, and for flat and hot_tail they also equal
the JAX stack by score level (4 decimals, as the reference test compares).
"""

import threading

import pytest
import requests

from archi_tpu.bin.bootstrap import build_context
from archi_tpu.bin.service_data_manager import build_app as build_data
from archi_tpu_torch.bin.bootstrap import build_vectorstore
from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.engine.xl_index import XlPQIndex
from archi_tpu_torch.utils.metrics import METRICS

INDEX_CONFIGS = {
    "flat": {},
    # tiny thresholds so the 24-doc corpus builds and queries an IVF
    # snapshot (async off → the snapshot exists before serving)
    "ivf": {"type": "ivf", "nlist": 8, "nprobe": 8,
            "min_snapshot_rows": 16, "async_refresh": False},
    "hot_tail": {"hot_tail": True, "merge_rows": 64},
    # host plane + PQ snapshot + exact tail; the per-query [B, N] bias
    # flows through all three tiers
    "ivfpq_xl": {"type": "ivfpq_xl", "nlist": 4, "block": 128,
                 "pq_m": 8, "pq_refine_m": 8, "nprobe_blocks": 16,
                 "min_snapshot_rows": 16, "async_refresh": False},
}
INDEX_TYPES = {"flat": "FlatIndex", "ivf": AnnFlatIndex.__name__,
               "hot_tail": SegmentedFlatIndex.__name__,
               "ivfpq_xl": XlPQIndex.__name__}


@pytest.fixture(scope="module", params=list(INDEX_CONFIGS))
def stacks(request, tmp_path_factory):
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"svc_{kind}")
    corpus = tmp / "corpus"
    corpus.mkdir()
    for i in range(24):
        (corpus / f"doc{i}.md").write_text(
            f"document {i} about "
            f"{'batch schedulers' if i % 2 else 'storage quotas'} "
            f"cluster topic{i % 6} " * 8)
    apps = []

    def make(sub, *, port=True, batched=False):
        dm = {"embedding_name": "hash",
              "data_path": str(tmp / sub / "data"),
              "db_path": str(tmp / sub / "catalog.db"),
              "index": dict(INDEX_CONFIGS[kind]),
              "sources": {"local_files": {"paths": [str(corpus)]}},
              "serving": {"micro_batch": {
                  "enabled": batched, "max_wait_ms": 15, "workers": 2}}}
        store = build_vectorstore(dm, device="cpu") if port else None
        ctx = build_context(overrides={"data_manager": dm}, vectorstore=store)
        ctx.data_manager.run_ingestion()
        app, _ = build_data(ctx=ctx, initial_ingestion=False)
        apps.append(app)
        return ctx, f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"

    out = {"batched": make("batched", batched=True), "plain": make("plain")}
    if kind in ("flat", "hot_tail"):
        out["jax"] = make("jax", port=False)
    for ctx, _url in (out["batched"], out["plain"]):
        index = ctx.vectorstore.index
        assert type(index).__name__ == INDEX_TYPES[kind]
        assert ctx.vectorstore.count() == 24
        if kind == "ivf":
            # build the IVF snapshot now (normally kicked by the first
            # search); without it this config is the exact-tail scan
            index.refresh_ann()
            assert index._ivf is not None
        elif kind == "ivfpq_xl":
            index.refresh_snapshot()
            assert index._ivf is not None and index._n_snap == 24
    assert out["batched"][0].vectorstore._batcher is not None
    assert out["plain"][0].vectorstore._batcher is None
    yield out
    for app in apps:
        app.shutdown()
    out["batched"][0].vectorstore._batcher.close()


def _query(url, q):
    r = requests.post(f"{url}/api/query/hybrid",
                      json={"query": q, "k": 3}, timeout=30)
    r.raise_for_status()
    return r.json()   # list of {page_content, metadata, score}


def test_concurrent_http_queries_coalesce(stacks):
    _ctx, url = stacks["batched"]
    before_b = METRICS.counter_value("archi_micro_batches_total")
    before_r = METRICS.counter_value("archi_micro_batched_requests_total")
    queries = ["batch schedulers", "storage quotas", "topic3 cluster",
               "document about topic1"] * 3
    results = {}

    def client(i, q):
        results[i] = _query(url, q)

    threads = [threading.Thread(target=client, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == len(queries)
    for i, q in enumerate(queries):
        assert results[i], q
    # the scheduler coalesced: fewer batches than requests → mean batch > 1
    ran_b = METRICS.counter_value("archi_micro_batches_total") - before_b
    ran_r = METRICS.counter_value(
        "archi_micro_batched_requests_total") - before_r
    assert ran_r >= len(queries)
    assert ran_b < ran_r, "mean batch size was 1 — nothing fused"


def _by_level(rs):
    lv = {}
    for x in rs:
        lv.setdefault(round(x["score"], 4), set()).add(
            x["metadata"].get("display_name"))
    return lv


def _assert_same_levels(rb, rp, q):
    assert [round(x["score"], 4) for x in rb] == \
        [round(x["score"], 4) for x in rp], q
    # tie order may differ between the fused [B, N]-bias path and the
    # shared-bias path: identical docs per SCORE LEVEL, except a tie group
    # that k truncates (the lowest level kept)
    lb, lp = _by_level(rb), _by_level(rp)
    for s in set(lb) | set(lp):
        if lb.get(s) != lp.get(s):
            assert min(lb, default=0) == s or min(lp, default=0) == s, \
                (q, s, lb, lp)


def test_batched_results_match_unbatched_and_jax_stacks(stacks):
    _, url_b = stacks["batched"]
    _, url_p = stacks["plain"]
    for q in ("batch schedulers", "storage quotas", "topic2",
              "zzz unmatched words"):
        rb = _query(url_b, q)
        assert rb, q
        _assert_same_levels(rb, _query(url_p, q), q)
        if "jax" in stacks:
            _assert_same_levels(rb, _query(stacks["jax"][1], q), q)
