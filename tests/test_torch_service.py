"""End-to-end micro-batched serving on the port's store: the port's
counterpart of ``tests/integration/test_micro_batch_serving.py``.

``archi_tpu_torch.bin.bootstrap.build_vectorstore(dm_cfg, device="cpu")``
builds the store; the JAX package's framework-free upper layers take it
through ``build_context(vectorstore=...)``: a local directory is ingested
by the data manager and ``/api/query/hybrid`` is served by the
data-manager app.  For flat, hot_tail, ivf, ivfpq_xl, sharded and
ivfpq_xl_sharded (four CPU shards, ``devices=["cpu"] * 4``), concurrent
HTTP queries coalesce (the port's METRICS: mean batch > 1), batched results
equal an unbatched port stack, and for flat, hot_tail and sharded they also
equal the JAX stack by score level (4 decimals, as the reference test
compares).  The two sharded types also take uploads over HTTP, serve
``/api/query/hybrid`` and ``/semantic`` and drop a deleted document after a
resync, as ``tests/integration/test_sharded_serving.py`` does.

The two wirings a service over the port's store needs: with the service's
registry handed to the port (``use_registry``), ``GET /metrics`` shows the
engine's and the scheduler's counters; with ``rerank.enabled``, a pipeline
wrapped by ``attach_reranker`` returns the JAX stack's k reranked documents
(``build_vectorstore`` logs a warning that names it).
"""

import base64
import os
import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import requests

from archi_tpu.bin.bootstrap import build_context
from archi_tpu.bin.service_data_manager import build_app as build_data
from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.bert import init_params
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu.models.train_encoder import save_model_dir
from archi_tpu.pipelines.qa import QAPipeline
from archi_tpu.utils.metrics import METRICS as SERVICE_METRICS
from archi_tpu_torch.bin.bootstrap import attach_reranker, build_vectorstore
from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex
from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex
from archi_tpu_torch.engine.xl_index import XlPQIndex
from archi_tpu_torch.utils.metrics import METRICS, use_registry
from tests.test_torch_data_layer import jax_cache_in_tmp  # noqa: F401

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
    # corpus rows over four CPU shards; per-shard fused top-k + merge
    "sharded": {"type": "sharded", "tile_n": 256},
    # one XL index a shard; the 24-row ingest lands whole on one shard
    "ivfpq_xl_sharded": {"type": "ivfpq_xl_sharded", "nlist": 4,
                         "block": 128, "pq_m": 8, "pq_refine_m": 8,
                         "nprobe_blocks": 16, "min_snapshot_rows": 16},
}
INDEX_TYPES = {"flat": "FlatIndex", "ivf": AnnFlatIndex.__name__,
               "hot_tail": SegmentedFlatIndex.__name__,
               "ivfpq_xl": XlPQIndex.__name__,
               "sharded": ShardedFlatIndex.__name__,
               "ivfpq_xl_sharded": ShardedXlPQIndex.__name__}
#: the shard devices of the multi-device types (a device may repeat)
SHARDS = ["cpu"] * 4


def _port_store(dm):
    devices = SHARDS if "sharded" in dm["index"].get("type", "") else None
    return build_vectorstore(dm, device="cpu", devices=devices)


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
        store = _port_store(dm) if port else None
        ctx = build_context(overrides={"data_manager": dm}, vectorstore=store)
        ctx.data_manager.run_ingestion()
        app, _ = build_data(ctx=ctx, initial_ingestion=False)
        apps.append(app)
        return ctx, f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"

    out = {"batched": make("batched", batched=True), "plain": make("plain")}
    if kind in ("flat", "hot_tail", "sharded"):
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
        elif kind == "ivfpq_xl_sharded":
            index.refresh_snapshots()
            assert sum(s._n_snap for s in index.shards) == 24
        if "sharded" in kind:
            assert index.n_shards == 4
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


# ------------------------------------------ the sharded types over HTTP
SHARDED_INDEX = {
    "sharded": {"type": "sharded", "dtype": "float32", "tile_n": 256},
    "ivfpq_xl_sharded": {
        "type": "ivfpq_xl_sharded", "dtype": "float32", "tile_n": 64,
        "nlist": 8, "block": 32, "pq_m": 8, "pq_refine_m": 8,
        "nprobe_blocks": 1000000, "block_rank_sub": 1,
        "min_snapshot_rows": 4, "build_block_rows": 4}}
DOCS = (
    ("quota.md", "gpu quota allocation requests are reviewed weekly by "
                 "the resource board and granted per project"),
    ("slurm.md", "slurm array jobs are submitted with sbatch and "
                 "bounded by the task limit configuration"),
    ("storage.md", "eos storage namespaces enforce per user quotas on "
                   "the fuse mount"),
    ("mail.md", "the mailing list archive is searchable by thread"))


@pytest.mark.parametrize("kind", list(SHARDED_INDEX))
def test_sharded_ingest_query_delete_over_http(kind, tmp_path):
    index = dict(SHARDED_INDEX[kind])
    if kind == "ivfpq_xl_sharded":
        index["store_dir"] = str(tmp_path / "planes")
    dm = {"data_path": str(tmp_path / "data"),
          "db_path": str(tmp_path / "catalog.db"),
          "embedding_name": "hash", "embedding_kwargs": {"dim": 64},
          "embedding_dimensions": 64, "index": index}
    store = _port_store(dm)
    ctx = build_context(overrides={"data_manager": dm}, vectorstore=store)
    app, _ = build_data(ctx=ctx, initial_ingestion=False)
    url = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
    try:
        assert type(store.index).__name__ == INDEX_TYPES[kind]
        assert store.index.n_shards == 4
        for name, text in DOCS:
            r = requests.post(url + "/api/upload", json={
                "filename": name,
                "content_b64": base64.b64encode(text.encode()).decode(),
                "sync": False}, timeout=30)
            assert r.status_code == 200
        assert ctx.data_manager.index_manager.update_vectorstore()[
            "added"] == 4
        if kind == "sharded":
            assert [e.device.type for e in store.index._embs] == ["cpu"] * 4
        else:
            # per-shard host planes are memmaps on disk
            assert any(p.endswith(".bf16")
                       for p in os.listdir(store.index.store_dir))
        r = requests.post(url + "/api/query/hybrid", json={
            "query": "how do I submit slurm array jobs", "k": 2}, timeout=30)
        assert "sbatch" in r.json()[0]["page_content"]
        r2 = requests.post(url + "/api/query/semantic", json={
            "query": "gpu quota", "k": 1}, timeout=30)
        assert "quota" in r2.json()[0]["page_content"]
        # delete + resync drops the document from every shard
        h = [d for d in ctx.catalog.list_documents()
             if d["display_name"] == "slurm.md"][0]["resource_hash"]
        requests.delete(url + f"/api/documents/{h}", timeout=30)
        ctx.data_manager.index_manager.update_vectorstore()
        r3 = requests.post(url + "/api/query/hybrid", json={
            "query": "sbatch slurm array", "k": 4}, timeout=30)
        assert all("sbatch" not in d["page_content"] for d in r3.json())
    finally:
        app.shutdown()
        ctx.scheduler.stop()


# ------------------------------------------------ /metrics over the port
@pytest.fixture
def service_registry():
    """The data-manager app renders the JAX package's registry: hand it to
    the port for the test, then give the port its own back."""
    previous = use_registry(SERVICE_METRICS)
    yield SERVICE_METRICS
    use_registry(previous)


def _scrape(url) -> dict:
    r = requests.get(f"{url}/metrics", timeout=30)
    r.raise_for_status()
    out = {}
    for line in r.text.splitlines():
        m = re.match(r"^(\S+) (\S+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


# the names as the registry renders counters (a "_total" suffix on each)
SERIES = ("archi_micro_batches_total_total",
          "archi_micro_batched_requests_total_total",
          'archi_engine_queries_total{kind="hybrid"}')


def test_metrics_endpoint_shows_the_port_counters(stacks, service_registry):
    _ctx, url = stacks["batched"]
    before = _scrape(url)
    queries = ["batch schedulers", "storage quotas", "topic3 cluster",
               "document about topic1"] * 3
    threads = [threading.Thread(target=_query, args=(url, q))
               for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    after = _scrape(url)
    rose = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in SERIES}
    assert rose['archi_engine_queries_total{kind="hybrid"}'] >= len(queries)
    assert rose["archi_micro_batched_requests_total_total"] >= len(queries)
    assert 0 < rose["archi_micro_batches_total_total"] \
        < rose["archi_micro_batched_requests_total_total"]
    # the port's METRICS reads the registry in use
    assert METRICS.counter_value("archi_micro_batches_total") == \
        SERVICE_METRICS.counter_value("archi_micro_batches_total")


def test_use_registry_switches_modules_that_bound_metrics_at_import():
    from archi_tpu_torch.engine import batcher, vectorstore
    from archi_tpu_torch.utils.metrics import MetricsRegistry

    mine = MetricsRegistry()
    previous = use_registry(mine)
    try:
        vectorstore.METRICS.inc("archi_engine_queries",
                                labels={"kind": "hybrid"})
        batcher.METRICS.inc("archi_micro_batches_total")
    finally:
        assert use_registry(previous) is mine
    assert mine.counter_value("archi_engine_queries",
                              {"kind": "hybrid"}) == 1.0
    assert mine.counter_value("archi_micro_batches_total") == 1.0
    assert METRICS.target is previous


# ------------------------------------------- rerank over the port's store
RERANK_DOCS = [
    f"{topic} note {i}: {detail}"
    for i, (topic, detail) in enumerate(
        (t, d) for t in ("slurm batch jobs", "eos storage quota",
                         "grafana dashboards", "xrootd transfers")
        for d in ("failed with a timeout", "needs an admin approval",
                  "is documented in the wiki", "was fixed last week",
                  "returns an error code"))]
RERANK_QUERIES = ["slurm jobs timeout", "storage quota approval",
                  "grafana wiki", "xrootd error code", "batch admin"]


def _rerank_cfg(model_dir, tmp):
    return {"embedding_name": "minilm", "model_dir": str(model_dir),
            "data_path": str(tmp / "data"),
            "retrievers": {"hybrid_retriever": {
                "num_documents_to_retrieve": 3,
                "rerank": {"enabled": True, "overfetch": 12}}}}


@pytest.fixture(scope="module")
def rerank_stores(tmp_path_factory):
    """The same random weights (a local HF snapshot) under the JAX store
    (f32, XLA attention) and the port's store built by
    ``build_vectorstore`` on the CPU, the same documents in both."""
    tmp = tmp_path_factory.mktemp("rerank")
    cfg = JaxConfig(vocab_size=400, hidden_size=64, num_layers=2,
                    num_heads=2, intermediate_size=128,
                    max_position_embeddings=128)
    tok = JaxTokenizer.build_vocab(RERANK_DOCS + RERANK_QUERIES, size=400)
    save_model_dir(str(tmp / "model"), cfg, init_params(cfg, seed=4), tok)
    dm = _rerank_cfg(tmp / "model", tmp)
    jax_store = TpuVectorStore(JaxEmbedder(
        model_dir=str(tmp / "model"), compute_dtype=jnp.float32,
        attention_impl="xla"))
    port_store = build_vectorstore(dm, device="cpu")
    metas = [{"chunk_id": f"c{i}"} for i in range(len(RERANK_DOCS))]
    for store in (jax_store, port_store):
        store.add_texts(RERANK_DOCS, metadatas=metas)
    return dm, jax_store, port_store


def _ranked(retriever, q):
    return [(d.page_content, s) for d, s in retriever.invoke(q)]


def test_rerank_pipeline_over_the_port_matches_the_jax_stack(rerank_stores):
    dm, jax_store, port_store = rerank_stores
    config = {"data_manager": dm}
    jax_pipe = QAPipeline(config)
    jax_pipe.update_retriever(jax_store)
    plain = QAPipeline(config)
    plain.update_retriever(port_store)
    port_pipe = QAPipeline(config)
    assert attach_reranker(port_pipe)
    port_pipe.update_retriever(port_store)
    assert type(jax_pipe.retriever).__name__ == "RerankingRetriever"
    for q in RERANK_QUERIES:
        want = _ranked(jax_pipe.retriever, q)
        got = _ranked(port_pipe.retriever, q)
        assert len(want) == len(got) == 3, q
        assert [d for d, _ in got] == [d for d, _ in want], q
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=1e-4)
        # without the helper the JAX pipeline skips the rerank over the
        # port's store and returns the whole over-fetched pool
        assert len(_ranked(plain.retriever, q)) == 12
    # the orchestrator passes the store on every call: update_retriever
    # runs again and the rerank stays
    out = port_pipe.invoke(vectorstore=port_store,
                           history=[("user", RERANK_QUERIES[0])])
    want = jax_pipe.invoke(vectorstore=jax_store,
                           history=[("user", RERANK_QUERIES[0])])
    assert [d.page_content for d in out.source_documents] == \
        [d.page_content for d in want.source_documents]
    assert len(out.source_documents) == 3


def test_attach_reranker_wraps_a_built_retriever_once(rerank_stores):
    dm, _jax_store, port_store = rerank_stores
    pipe = QAPipeline({"data_manager": dm})
    pipe.update_retriever(port_store)
    assert attach_reranker(pipe)
    wrapped = pipe.retriever
    assert wrapped.k == 3 and wrapped.base.k == 12
    assert type(wrapped.reranker).__module__ == \
        "archi_tpu_torch.engine.reranker"
    pipe.update_retriever(port_store)
    assert pipe.retriever.base.k == 12        # one wrap, not two
    off = QAPipeline({"data_manager": {"retrievers": {}}})
    assert not attach_reranker(off)


def test_build_vectorstore_logs_when_rerank_is_enabled(caplog, tmp_path):
    dm = {"embedding_name": "hash", "data_path": str(tmp_path / "data"),
          "retrievers": {"hybrid_retriever": {"rerank": {"enabled": True}}}}
    with caplog.at_level("WARNING", logger="archi_tpu_torch.bin.bootstrap"):
        build_vectorstore(dm, device="cpu")
    assert any("attach_reranker" in r.getMessage()
               and r.levelname == "WARNING" for r in caplog.records)
    caplog.clear()
    dm["retrievers"]["hybrid_retriever"]["rerank"]["enabled"] = False
    with caplog.at_level("WARNING", logger="archi_tpu_torch.bin.bootstrap"):
        build_vectorstore(dm, device="cpu")
    assert not caplog.records
