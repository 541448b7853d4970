"""The port's micro-batching scheduler (``archi_tpu_torch/engine/batcher.py``)
and the store's batched serving path, against the JAX package.

Ports of ``tests/unit/test_batcher.py``'s scheduler and store tests.  The
stores hold the same corpus embedded by ``HashEmbeddings`` (each package's
copy; identical vectors): batched and sequential results of the port equal
the JAX ``TpuVectorStore`` within 1e-5 for an f32 index and 1e-4 for a
bf16 one, row sets tie-aware.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models.registry import HashEmbeddings as JaxHash
from archi_tpu_torch.engine import vectorstore as tvs
from archi_tpu_torch.engine.ann_index import AnnFlatIndex
from archi_tpu_torch.engine.batcher import (MicroBatcher, hybrid_batcher,
                                            hybrid_signature,
                                            semantic_signature)
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex
from archi_tpu_torch.models.registry import HashEmbeddings
from archi_tpu_torch.utils.metrics import METRICS

DIM = 64
TOLS = {"float32": 1e-5, "bfloat16": 1e-4}


def assert_same(got, want, tol):
    """Scores within tol position by position; a chunk in one list only
    must tie (within tol) with the lowest score kept."""
    assert len(got) == len(want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)
    g = {d.metadata["chunk_id"]: s for d, s in got}
    w = {d.metadata["chunk_id"]: s for d, s in want}
    cut = min(w.values()) if w else 0.0
    for cid in set(g) ^ set(w):
        assert abs(g.get(cid, w.get(cid)) - cut) <= tol, (cid, got, want)


def _texts(n=60):
    return [f"document {i} about "
            f"{'quantum chips' if i % 3 == 0 else 'web crawling spiders'} "
            f"topic{i % 7}" for i in range(n)]


def _metas(n=60):
    return [{"source": f"d{i}.txt", "parity": str(i % 2)} for i in range(n)]


def _port_store(dtype="float32", index=None):
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), index=index,
                             dtype=getattr(torch, dtype), device="cpu")
    s.add_texts(_texts(), _metas(), ids=[f"c{i}" for i in range(60)])
    return s


def _jax_store(dtype="float32"):
    s = TpuVectorStore(JaxHash(DIM), dtype=getattr(jnp, dtype))
    s.add_texts(_texts(), _metas(), ids=[f"c{i}" for i in range(60)])
    return s


@pytest.fixture(scope="module")
def jax_store():
    return _jax_store()


@pytest.fixture
def store():
    s = _port_store()
    yield s
    if s._batcher is not None:
        s._batcher.close()


QUERIES = ["quantum chips", "web crawling", "topic3 document",
           "nonexistent zebra watermelon", "topic5"]


def _concurrently(fns, timeout=30):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "client did not finish"


# ---------------------------------------------------------- MicroBatcher
def test_batcher_coalesces_concurrent_requests():
    batch_sizes = []

    def run(sig, payloads):
        batch_sizes.append(len(payloads))
        time.sleep(0.01)
        return [p * 2 for p in payloads]

    mb = MicroBatcher(run, max_batch=16, max_wait_s=0.05)
    results = {}

    def client(i):
        results[i] = mb.submit(i)

    _concurrently([lambda i=i: client(i) for i in range(12)])
    mb.close()
    assert results == {i: i * 2 for i in range(12)}
    assert max(batch_sizes) > 1          # actually coalesced
    assert sum(batch_sizes) == 12


def test_batcher_groups_by_signature():
    seen = []

    def run(sig, payloads):
        seen.append((sig, sorted(payloads)))
        return list(payloads)

    mb = MicroBatcher(run, max_batch=8, max_wait_s=0.05)
    out = {}

    def client(i):
        out[i] = mb.submit(i, signature=("k", i % 2))

    _concurrently([lambda i=i: client(i) for i in range(8)])
    mb.close()
    assert out == {i: i for i in range(8)}
    for sig, payloads in seen:
        assert {p % 2 for p in payloads} == {sig[1]}   # never mixed


def test_batcher_error_fans_out_and_survives():
    def run(sig, payloads):
        if sig == "bad":
            raise ValueError("boom")
        return list(payloads)

    mb = MicroBatcher(run, max_batch=4, max_wait_s=0.01)
    with pytest.raises(ValueError):
        mb.submit(1, signature="bad")
    # the worker still serves afterwards
    assert mb.submit(7, signature="good") == 7
    mb.close()


def test_batcher_submit_timeout_and_close():
    release = threading.Event()

    def run(sig, payloads):
        release.wait(10)
        return list(payloads)

    mb = MicroBatcher(run, max_batch=4, max_wait_s=0.0, workers=1,
                      submit_timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mb.submit(1)
    assert time.monotonic() - t0 < 5
    release.set()
    assert mb.submit(2, timeout=10) == 2
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(3)


def test_batch_counters_reach_the_port_metrics():
    mb = MicroBatcher(lambda sig, p: list(p), max_batch=8, max_wait_s=0.05)
    b0 = METRICS.counter_value("archi_micro_batches_total")
    r0 = METRICS.counter_value("archi_micro_batched_requests_total")
    _concurrently([lambda i=i: mb.submit(i) for i in range(6)])
    mb.close()
    batches = METRICS.counter_value("archi_micro_batches_total") - b0
    assert METRICS.counter_value(
        "archi_micro_batched_requests_total") - r0 == 6
    assert 1 <= batches < 6


def test_signatures_match_jax():
    from archi_tpu.engine import batcher as jb

    for args in [(4, 0.7, 0.3, None, None),
                 (3, 0.5, 0.5, {"b": 1, "a": "x"}, {"h1", 42, "c3"})]:
        assert hybrid_signature(*args) == jb.hybrid_signature(*args)
        assert semantic_signature(args[0], *args[3:]) == \
            jb.semantic_signature(args[0], *args[3:])


# ------------------------------------------------------ batched store path
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_and_semantic_batches_match_jax(dtype):
    s, jax_store = _port_store(dtype), _jax_store(dtype)
    tol = TOLS[dtype]
    for q, got in zip(QUERIES, s.hybrid_search_batch(QUERIES, k=4)):
        assert_same(got, jax_store.hybrid_search(q, k=4), tol)
        assert_same(got, s.hybrid_search(q, k=4), tol)
    for q, got in zip(QUERIES, s.similarity_search_batch(QUERIES, k=4)):
        assert_same(got, jax_store.similarity_search_with_score(q, k=4), tol)
    out = s.hybrid_search_batch(["quantum chips"] * 2, k=4,
                                filter={"parity": "0"})
    for res in out:
        assert res and all(d.metadata["parity"] == "0" for d, _ in res)


def test_hybrid_batcher_end_to_end(store, jax_store):
    mb = hybrid_batcher(store, max_wait_s=0.05)
    sig = hybrid_signature(4, 0.7, 0.3, None, None)
    results = {}

    def client(q):
        results[q] = mb.submit(q, signature=sig)

    queries = ["quantum chips", "web crawling", "topic2", "topic5"]
    _concurrently([lambda q=q: client(q) for q in queries])
    mb.close()
    for q in queries:
        assert_same(results[q], jax_store.hybrid_search(q, k=4), 1e-5)


def test_store_level_micro_batching_transparent(store, jax_store):
    """enable_micro_batching routes hybrid_search through the scheduler
    with identical results, including concurrent callers."""
    want = {q: store.hybrid_search(q, k=3) for q in QUERIES}
    store.enable_micro_batching(max_wait_ms=30)
    b0 = METRICS.counter_value("archi_micro_batches_total")
    r0 = METRICS.counter_value("archi_micro_batched_requests_total")
    got = {}

    def client(q):
        got[q] = store.hybrid_search(q, k=3)

    _concurrently([lambda q=q: client(q) for q in QUERIES])
    for q in QUERIES:
        assert_same(got[q], want[q], 1e-5)
        assert_same(got[q], jax_store.hybrid_search(q, k=3), 1e-5)
    assert METRICS.counter_value(
        "archi_micro_batched_requests_total") - r0 == len(QUERIES)
    assert METRICS.counter_value("archi_micro_batches_total") - b0 \
        < len(QUERIES)


def test_semantic_routes_through_batcher(store):
    """Concurrent semantic calls coalesce (and hybrid + semantic requests
    never mix in one group: different signature kinds)."""
    want_s = store.similarity_search_with_score("quantum chips", k=3)
    want_h = store.hybrid_search("web crawling", k=3)
    store.enable_micro_batching(max_wait_ms=30)
    before = METRICS.counter_value("archi_micro_batches_total")
    got = {}

    def sem():
        got["s"] = store.similarity_search_with_score("quantum chips", k=3)

    def hyb():
        got["h"] = store.hybrid_search("web crawling", k=3)

    _concurrently([sem, sem, hyb, hyb])
    assert_same(got["s"], want_s, 1e-5)
    assert_same(got["h"], want_h, 1e-5)
    ran = METRICS.counter_value("archi_micro_batches_total") - before
    assert 2 <= ran <= 4   # at least one group per kind, never mixed


def test_enable_micro_batching_twice_closes_old_batcher(store):
    store.enable_micro_batching(max_wait_ms=1)
    first = store._batcher
    store.enable_micro_batching(max_wait_ms=1)
    assert store._batcher is not first
    assert all(not w.is_alive() for w in first._workers)


def test_mixed_type_enabled_ids_through_batcher(store):
    """int + str enabled_ids must not break signature construction."""
    store.enable_micro_batching(max_wait_ms=1)
    res = store.hybrid_search("quantum chips", k=3,
                              enabled_ids={"d3.txt", 42})
    assert isinstance(res, list)


class _RowBiasOnly(FlatIndex):
    """An index whose search takes no [B, N] bias: the batched store path
    runs one direct call per query."""

    supports_batched_bias = False


@pytest.mark.parametrize("index_kind", ["row_bias_only", "ivf"])
def test_bm25_miss_inside_worker_does_not_deadlock(index_kind):
    """workers=1 + a BM25-miss query: the semantic fallback (and, for an
    index without batched bias, the per-query branch) must not re-enter
    the batcher from its own worker."""
    if index_kind == "ivf":
        idx = AnnFlatIndex(DIM, dtype=torch.float32, tile_n=256, nlist=4,
                           min_snapshot_rows=16, async_refresh=False,
                           device="cpu")
    else:
        idx = _RowBiasOnly(DIM, dtype=torch.float32, tile_n=256,
                           device="cpu")
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), index=idx)
    s.add_texts([f"doc {i} about area{i % 4}" for i in range(64)])
    if index_kind == "ivf":
        idx.refresh_ann()
        assert idx._ivf is not None
    want = s._hybrid_search_impl("zzzqqq nonexistent", k=2)
    assert_same(want, s.similarity_search_with_score("zzzqqq nonexistent",
                                                     k=2), 1e-5)
    s.enable_micro_batching(max_wait_ms=1, workers=1)
    done = {}

    def client():
        done["r"] = s.hybrid_search("zzzqqq nonexistent", k=2)

    t = threading.Thread(target=client)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "deadlocked in batcher re-entry"
    s._batcher.close()
    assert_same(done["r"], want, 1e-5)


def test_batch_falls_back_on_non_batched_bias_index(jax_store):
    idx = _RowBiasOnly(DIM, dtype=torch.float32, tile_n=256, device="cpu")
    s = _port_store(index=idx)
    for q, got in zip(QUERIES, s.hybrid_search_batch(QUERIES, k=3)):
        assert_same(got, jax_store.hybrid_search(q, k=3), 1e-5)


def test_semantic_batch_on_ann_index():
    """Semantic batching keeps a SHARED bias: one fused pass on the ANN
    snapshot path, equal to per-query calls."""
    idx = AnnFlatIndex(DIM, dtype=torch.float32, tile_n=256, nlist=4,
                       min_snapshot_rows=16, device="cpu")
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), index=idx)
    s.add_texts([f"doc {i} about area{i % 4}" for i in range(64)],
                [{"source": f"a{i}"} for i in range(64)])
    idx.refresh_ann()
    out = s.similarity_search_batch(["area2 doc", "area1"], k=3)
    for q, got in zip(("area2 doc", "area1"), out):
        assert_same(got, s.similarity_search_with_score(q, k=3), 1e-5)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_hybrid_batch_fused_on_ann_index(kind):
    """Per-query bias rides the block-layout permute: batched hybrid is
    fused on the ANN snapshot path too, and odd batch sizes pad with their
    bias through the grouped search."""
    kw = {} if kind == "ivf" else {"pq_m": 8, "pq_refine_m": 8}
    idx = AnnFlatIndex(DIM, dtype=torch.float32, tile_n=256, nlist=4,
                       min_snapshot_rows=16, snapshot_kind=kind,
                       async_refresh=False, device="cpu", **kw)
    assert idx.supports_batched_bias
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), index=idx)
    s.add_texts([f"doc {i} about field{i % 4}" for i in range(64)],
                [{"source": f"a{i}"} for i in range(64)])
    idx.refresh_ann()
    assert idx._ivf is not None
    queries = ["field2 doc", "field1", "doc 17"]
    for q, got in zip(queries, s.hybrid_search_batch(queries, k=3)):
        assert_same(got, s._hybrid_search_impl(q, k=3), 1e-5)
    for nb in (1, 3, 5, 7):
        out = s.hybrid_search_batch([f"field{j % 4} doc" for j in range(nb)],
                                    k=3)
        assert len(out) == nb and all(out)


def test_hybrid_batch_on_hot_tail_index():
    """Per-query bias slices per segment: batched hybrid is fused on the
    streaming hot-tail configuration too."""
    idx = SegmentedFlatIndex(DIM, dtype=torch.float32, tile_n=256,
                             merge_rows=64, device="cpu")
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), index=idx)
    s.add_texts([f"cold doc {i} about zone{i % 5}" for i in range(96)],
                [{"source": f"c{i}"} for i in range(96)])
    idx.merge()
    s.add_texts([f"hot doc {i} about zone{i % 5}" for i in range(24)],
                [{"source": f"h{i}"} for i in range(24)])
    assert idx.n_merged == 96 and len(idx.tail) == 24
    queries = ["zone3 doc", "hot doc 5", "cold doc 11"]
    for q, got in zip(queries, s.hybrid_search_batch(queries, k=4)):
        assert_same(got, s._hybrid_search_impl(q, k=4), 1e-5)


def test_batched_queries_under_concurrent_ingest():
    """Micro-batched searches racing a live ingest stream never crash or
    return rows the metadata plane doesn't know (snapshot isolation holds
    through the batch path)."""
    s = tvs.TorchVectorStore(HashEmbeddings(DIM), dtype=torch.float32,
                             device="cpu")
    s.add_texts([f"seed doc {i} about theme{i % 4}" for i in range(64)],
                [{"source": f"seed{i}"} for i in range(64)])
    s.enable_micro_batching(max_wait_ms=5, workers=2)
    stop = threading.Event()
    errors = []

    def ingester():
        i = 0
        while not stop.is_set():
            s.add_texts([f"live doc {i} about theme{i % 4} extra words"],
                        [{"source": f"live{i}"}])
            i += 1

    def querier():
        try:
            for j in range(15):
                for d, v in s.hybrid_search(f"theme{j % 4} doc", k=3):
                    assert d.metadata["source"], "empty metadata"
                    assert v > -1e29
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    ing = threading.Thread(target=ingester)
    ing.start()
    try:
        _concurrently([querier] * 4, timeout=60)
    finally:
        stop.set()
        ing.join(timeout=30)
        s._batcher.close()
    assert not ing.is_alive()
    assert not errors, errors


def test_hybrid_batch_splits_oversized_bias(store, jax_store, monkeypatch):
    """The [B, capacity] bias is budget-bounded: oversized batches split
    into sub-batches with unchanged results."""
    queries = ["quantum chips", "web crawling", "topic1", "topic5"]
    want = store.hybrid_search_batch(queries, k=3)
    # a budget of 2 bias rows → the 4-query batch splits (and recurses)
    monkeypatch.setattr(tvs, "BIAS_BUDGET_BYTES",
                        2 * store.index.capacity * 4)
    got = store.hybrid_search_batch(queries, k=3)
    for q, g, w in zip(queries, got, want):
        assert_same(g, w, 1e-5)
        assert_same(g, jax_store.hybrid_search(q, k=3), 1e-5)


def test_warmup_covers_all_buckets(store, monkeypatch):
    """warmup() with micro-batching enabled runs every power-of-two bucket
    at the configured k."""
    seen = []
    orig = store.hybrid_search_batch

    def spy(queries, k=4, **kw):
        seen.append((len(queries), k))
        return orig(queries, k, **kw)

    monkeypatch.setattr(store, "hybrid_search_batch", spy)
    store.enable_micro_batching(max_batch=8, max_wait_ms=1)
    store.warmup(k=3)
    assert {(1, 3), (2, 3), (4, 3), (8, 3)} <= set(seen), seen
