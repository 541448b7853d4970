"""The slice as a whole: one seeded corpus through the JAX package's
``TpuVectorStore(JaxEmbedder)`` and the port's
``TorchVectorStore(TorchEmbedder(device="cpu"))`` with the same weights
(both draw ``init_params(seed=0)``) and the same vocabulary.

Every search form returns identical chunk ids and scores within 1e-4
(ids may differ only between scores equal within 1e-4).  Both stores keep
f32 rows, so the comparison holds the encoder, BM25 and ranking to the
tolerance rather than bf16 storage rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import vectorstore as jvs
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch.engine import vectorstore as tvs
from archi_tpu_torch.models.bert import BertConfig
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

TOL = 1e-4
CFG = dict(vocab_size=600, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=128)

_WORDS = ("tpu gpu kernel tensor matrix vector index search query lexical "
          "semantic hybrid ranking score embed encoder token batch device "
          "memory cache latency throughput shard replica cluster").split()


def _corpus(n=40, seed=0):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(_WORDS, rng.integers(4, 12)))
             for _ in range(n)]
    metas = [{"source": "a" if i % 3 else "b",
              "resource_hash": f"h{i % 5}"} for i in range(n)]
    ids = [f"doc-{i}" for i in range(n)]
    return texts, metas, ids


@pytest.fixture(scope="module")
def stores():
    texts, metas, ids = _corpus()
    jtok = JaxTokenizer.build_vocab(texts, size=CFG["vocab_size"])
    ttok = WordPieceTokenizer(dict(jtok.vocab))
    jemb = JaxEmbedder(config=JaxConfig(**CFG), tokenizer=jtok,
                       compute_dtype=jnp.float32, attention_impl="xla")
    temb = TorchEmbedder(config=BertConfig(**CFG), tokenizer=ttok,
                         device="cpu")
    js = jvs.TpuVectorStore(jemb, dtype=jnp.float32)
    ts = tvs.TorchVectorStore(temb, dtype=torch.float32, device="cpu")
    for s in (js, ts):
        s.add_texts(texts[:30], metadatas=metas[:30], ids=ids[:30])
        s.add_texts(texts[30:], metadatas=metas[30:], ids=ids[30:])
    return js, ts


def assert_same(got, want, tol=TOL):
    assert len(got) == len(want)
    gs = [s for _, s in got]
    ws = [s for _, s in want]
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    for (gd, s), (wd, _) in zip(got, want):
        assert gd.page_content is not None
        if gd.metadata["chunk_id"] != wd.metadata["chunk_id"]:
            assert sum(abs(x - s) <= tol for x in ws) > 1  # a tie
        else:
            assert gd.page_content == wd.page_content
            assert gd.metadata == wd.metadata


QUERIES = ["hybrid ranking score", "gpu kernel", "lexical search query",
           "throughput", "unmatched words zzz qqq"]


@pytest.mark.parametrize("query", QUERIES)
def test_semantic_and_hybrid(stores, query):
    js, ts = stores
    assert_same(ts.similarity_search_with_score(query, k=5),
                js.similarity_search_with_score(query, k=5))
    assert_same(ts.hybrid_search(query, k=5), js.hybrid_search(query, k=5))
    assert_same(ts.hybrid_search(query, k=5, semantic_weight=0.5,
                                 bm25_weight=0.5),
                js.hybrid_search(query, k=5, semantic_weight=0.5,
                                 bm25_weight=0.5))


def test_bm25_empty_query_falls_back_to_semantic(stores):
    js, ts = stores
    q = "unmatched words zzz qqq"
    assert float(ts.bm25.scores(q, ts.index.capacity).max()) == 0.0
    assert_same(ts.hybrid_search(q, k=4), ts.similarity_search_with_score(q, k=4))


@pytest.mark.parametrize("kw", [{}, {"filter": {"source": "b"}},
                                {"enabled_ids": {"doc-1", "doc-7", "h2"}}])
def test_batch_forms_with_filters(stores, kw):
    """B=5 pads to 8 with zero queries whose rows never reach callers; the
    BM25-empty query takes the per-query semantic fallback."""
    js, ts = stores
    got = ts.hybrid_search_batch(QUERIES, k=4, **kw)
    want = js.hybrid_search_batch(QUERIES, k=4, **kw)
    assert len(got) == len(QUERIES)
    for g, w in zip(got, want):
        assert_same(g, w)
    for g, q in zip(got, QUERIES):
        assert_same(g, ts.hybrid_search(q, k=4, **kw))
    got = ts.similarity_search_batch(QUERIES, k=4, **kw)
    want = js.similarity_search_batch(QUERIES, k=4, **kw)
    for g, w in zip(got, want):
        assert_same(g, w)
    if "filter" in kw:
        assert all(d.metadata["source"] == "b" for r in got for d, _ in r)
    if "enabled_ids" in kw:
        for r in got:
            for d, _ in r:
                assert d.metadata["chunk_id"] in {"doc-1", "doc-7"} or \
                    d.metadata["resource_hash"] == "h2"


#: micro-batches of queries BM25 matches and queries it does not (B = 1;
#: 3 padded to 4; 5 padded to 8)
MIXES = {"one_matched": ["gpu kernel"], "one_unmatched": ["zzz qqq"],
         "mixed": ["zzz qqq", "gpu kernel", "unknown words qqq"],
         "mostly_matched": QUERIES}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_hybrid_batch_equals_the_single_path(stores, mix):
    """One batched BM25 pass gives each query what the direct single-query
    path gives it; a query BM25 does not match reports the unscaled cosine
    of the semantic search."""
    _js, ts = stores
    queries = MIXES[mix]
    got = ts.hybrid_search_batch(queries, k=4)
    assert len(got) == len(queries)
    for g, q in zip(got, queries):
        assert_same(g, ts._hybrid_search_impl(q, k=4))
        if float(ts.bm25.scores(q, ts.index.capacity).max()) <= 0.0:
            assert_same(g, ts._similarity_search_impl(q, k=4))


def test_bm25_path_counter(stores):
    """``archi_bm25_scored_queries_total`` counts a micro-batch's queries
    under ``batch`` and a direct hybrid search's under ``single``."""
    from archi_tpu_torch.utils.metrics import METRICS

    _js, ts = stores

    def count(path):
        return METRICS.counter_value("archi_bm25_scored_queries_total",
                                     {"path": path})

    batch, single = count("batch"), count("single")
    ts.hybrid_search_batch(QUERIES, k=3)
    assert (count("batch"), count("single")) == (batch + len(QUERIES), single)
    assert ts._batcher is None     # micro-batching off: the direct path
    ts.hybrid_search(QUERIES[0], k=3)
    assert (count("batch"), count("single")) == \
        (batch + len(QUERIES), single + 1)


@pytest.mark.parametrize("kw", [{}, {"filter": {"source": "a"}},
                                {"enabled_ids": {"h1"}}])
def test_lexical_only(stores, kw):
    js, ts = stores
    for q in ("gpu kernel", "lexical search query"):
        got = ts.hybrid_search(q, k=6, semantic_weight=0.0, **kw)
        assert_same(got, js.hybrid_search(q, k=6, semantic_weight=0.0, **kw))
        assert_same(ts.hybrid_search_batch([q], k=6, semantic_weight=0.0,
                                           **kw)[0], got)


def test_bias_budget_splits_batches(stores, monkeypatch):
    js, ts = stores
    cap = ts.index.capacity
    monkeypatch.setattr(tvs, "BIAS_BUDGET_BYTES", 2 * cap * 4)
    got = ts.hybrid_search_batch(QUERIES, k=3)
    for g, q in zip(got, QUERIES):
        assert_same(g, js.hybrid_search(q, k=3))


def test_upsert_delete_and_access():
    texts, metas, ids = _corpus(12, seed=1)
    jtok = JaxTokenizer.build_vocab(texts, size=CFG["vocab_size"])
    jemb = JaxEmbedder(config=JaxConfig(**CFG), tokenizer=jtok,
                       compute_dtype=jnp.float32, attention_impl="xla")
    temb = TorchEmbedder(config=BertConfig(**CFG),
                         tokenizer=WordPieceTokenizer(dict(jtok.vocab)),
                         device="cpu")
    js = jvs.TpuVectorStore(jemb, dtype=jnp.float32)
    ts = tvs.TorchVectorStore(temb, dtype=torch.float32, device="cpu")
    for s in (js, ts):
        s.add_texts(texts, metadatas=metas, ids=ids)
        s.add_texts(["replacement text about gpu kernel"], ids=["doc-3"])
        s.delete(["doc-5", "doc-9"])
        auto = s.add_texts(["an auto id chunk about tensor memory"])
        assert auto == ["default:0"]
    assert ts.count() == js.count() == 11
    assert sorted(ts.ids()) == sorted(js.ids())
    assert [(d.page_content, d.metadata) for d in ts.get_by_ids(["doc-3"])] \
        == [(d.page_content, d.metadata) for d in js.get_by_ids(["doc-3"])]
    for q in ("gpu kernel", "tensor memory", texts[5]):
        assert_same(ts.hybrid_search(q, k=11), js.hybrid_search(q, k=11))
        found = {d.metadata["chunk_id"] for d, _ in ts.hybrid_search(q, k=11)}
        assert not found & {"doc-5", "doc-9"}
    assert ts.delete([]) is False


def test_save_load_cross_package(stores, tmp_path):
    js, ts = stores
    js.save(str(tmp_path / "jax"))
    ts.save(str(tmp_path / "torch"))
    t2 = tvs.TorchVectorStore.load(str(tmp_path / "jax"),
                                   ts._embedding_function, device="cpu")
    j2 = jvs.TpuVectorStore.load(str(tmp_path / "torch"),
                                 js._embedding_function)
    assert t2.count() == j2.count() == 40
    for q in QUERIES[:3]:
        assert_same(t2.hybrid_search(q, k=5), js.hybrid_search(q, k=5))
        assert_same(t2.hybrid_search(q, k=5), j2.hybrid_search(q, k=5))
    assert t2.add_texts(["fresh chunk"]) == ["default:0"]


def test_warmup_and_micro_batching(stores):
    """Micro-batched search through the scheduler equals the direct path
    and the JAX store; warmup runs with the scheduler on."""
    js, ts = stores
    ts.warmup(k=3)
    ts.enable_micro_batching(max_batch=4, max_wait_ms=1)
    try:
        ts.warmup(k=3)
        for q in QUERIES[:3]:
            assert_same(ts.hybrid_search(q, k=5), js.hybrid_search(q, k=5))
            assert_same(ts.similarity_search_with_score(q, k=5),
                        ts._similarity_search_impl(q, k=5))
    finally:
        ts._batcher.close()
        ts._batcher = None
