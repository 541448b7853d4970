"""The port's ``AnnFlatIndex`` (IVF / IVF-PQ snapshot + exact fresh tail)
and ``TorchVectorStore`` over it, against the JAX package's
``archi_tpu/engine/ann_index.py`` and ``TpuVectorStore``.

A snapshot built by one package travels to the other through the
``.ann.npz`` / ``.ann.json`` sidecars (or ``adopt_snapshot``); both then
take the same fresh rows, tombstones, filters and biases and must return
the same rows (tie-aware) with scores within 1e-5.  Both indexes keep f32
rows.  Also: compaction drops the snapshot, and the store's two repairs
(``load`` with ``index_loader`` / ``index_cls``; per-query calls for an
index without batched bias).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import vectorstore as jvs
from archi_tpu.engine.ann_index import AnnFlatIndex as JAnn
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch.engine import vectorstore as tvs
from archi_tpu_torch.engine.ann_index import AnnFlatIndex as TAnn
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.models.bert import BertConfig
from archi_tpu_torch.models.embedder import TorchEmbedder
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

ATOL = 1e-5
D = 32
KW = {"nlist": 8, "nprobe": 3, "min_snapshot_rows": 256, "pq_m": 8,
      "pq_refine_m": 8, "async_refresh": False}


def _clustered(rng, n, n_clusters=12, d=D, noise=0.2):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same(got, want, atol=ATOL):
    """(ids, vals, rows) of two searches: scores within atol; a row in one
    list only must tie with the last score kept; ids follow rows."""
    _gi, gv, gr = got
    _wi, wv, wr = want
    gv, wv, gr, wr = (np.asarray(a) for a in (gv, wv, gr, wr))
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    for b in range(gv.shape[0]):
        g = dict(zip(gr[b].tolist(), gv[b].tolist()))
        w = dict(zip(wr[b].tolist(), wv[b].tolist()))
        for r in set(g) ^ set(w):
            s = g.get(r, w.get(r))
            assert abs(s - wv[b, -1]) <= atol, (b, r, s, wv[b, -1])
        for i, r, v in zip(got[0][b], gr[b], gv[b]):
            assert (i is None) == (v <= -1e29)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return _clustered(rng, 600), _clustered(rng, 40), _clustered(rng, 5)


def _searches(index, q, rng_seed=0):
    """Semantic, filtered, shared-bias and per-query-bias searches."""
    rng = np.random.default_rng(rng_seed)
    cap = index.capacity
    fm = (rng.random(cap) > 0.3).astype(np.float32)
    shared = (0.2 * rng.random(cap)).astype(np.float32)
    per_q = (0.3 * rng.random((len(q), cap))).astype(np.float32)
    conv = (lambda a: torch.from_numpy(a)) if isinstance(index, TAnn) \
        else (lambda a: a)
    qq = conv(q)
    return [index.search(qq, k=7),
            index.search(qq, k=5, filter_mask=conv(fm)),
            index.search(qq, k=6, bias=conv(shared)),
            index.search(qq, k=6, bias=conv(per_q), filter_mask=conv(fm))]


@pytest.mark.parametrize("kind", ["ivfpq", "ivf"])
def test_snapshot_plus_fresh_tail_on_carried_snapshot(data, tmp_path, kind):
    x, fresh, q = data
    ids = [f"r{i}" for i in range(600)]
    j = JAnn(D, snapshot_kind=kind, dtype=jnp.float32, **KW)
    j.add(x, ids)
    j.refresh_ann()
    j.save(str(tmp_path / "j.npz"))
    # both packages from the saved state (a loaded ``ivf`` sidecar holds
    # bf16 blocks in both, whatever the rows' type)
    j = JAnn.load(str(tmp_path / "j.npz"), snapshot_kind=kind, **KW)
    t = TAnn.load(str(tmp_path / "j.npz"), device="cpu", snapshot_kind=kind,
                  **KW)
    assert t._ivf is not None and t._n_snap == 600
    assert t.dtype == torch.float32 and t.n_rows == 600
    fresh_ids = [f"f{i}" for i in range(40)]
    j.add(fresh, fresh_ids)
    t.add(torch.from_numpy(fresh), fresh_ids)
    assert not t._needs_refresh()
    for dead in ([], ["r3", "r77", "f5", "r599"]):
        j.delete(dead)
        t.delete(dead)
        for got, want in zip(_searches(t, q), _searches(j, q)):
            assert_same(got, want)
    # fresh rows are found through the exact tail
    _ids, _v, rows = t.search(torch.from_numpy(fresh[:4]), k=1)
    assert [r[0] for r in rows] == [600, 601, 602, 603]


@pytest.mark.parametrize("kind", ["ivfpq", "ivf"])
def test_port_sidecars_load_in_jax(data, tmp_path, kind):
    x, _fresh, q = data
    t = TAnn(D, snapshot_kind=kind, dtype=torch.float32, device="cpu", **KW)
    t.add(torch.from_numpy(x), list(range(600)))
    assert t._ivf is None
    t.search(torch.from_numpy(q), k=3)          # builds the snapshot inline
    assert t._ivf is not None and t._n_snap == 600
    t.save(str(tmp_path / "t.npz"))
    j = JAnn.load(str(tmp_path / "t.npz"), snapshot_kind=kind, **KW)
    t = TAnn.load(str(tmp_path / "t.npz"), device="cpu", snapshot_kind=kind,
                  **KW)
    assert j._ivf is not None and j._n_snap == 600
    for got, want in zip(_searches(t, q, 1), _searches(j, q, 1)):
        assert_same(got, want)


def test_compact_drops_the_snapshot_and_tombstoned_saves_write_no_sidecar(
        data, tmp_path):
    x, _fresh, q = data
    t = TAnn(D, snapshot_kind="ivf", dtype=torch.float32, device="cpu",
             **dict(KW, nprobe=8))
    t.add(torch.from_numpy(x), list(range(600)))
    t.refresh_ann()
    t.delete([0, 1, 2])
    t.save(str(tmp_path / "a.npz"))
    assert not (tmp_path / "a.npz.ann.npz").exists()
    t.compact()
    assert t._ivf is None and t._n_snap == 0 and t._compact_epoch == 1
    # the next search rebuilds over the compacted rows; nprobe == nlist is
    # exact, so it equals the flat scan
    got = t.search(torch.from_numpy(q), k=8)
    assert t._ivf is not None and t._n_snap == 597
    want = FlatIndex.search(t, torch.from_numpy(q), k=8)
    assert_same(got, want)


def test_int8_rows_rescore_on_the_cosine_scale(data):
    """Departure from the reference (ROADMAP queue C): the exact rescore of
    an int8 index dequantises the stored rows (1/127), so snapshot hits and
    fresh-tail hits share the cosine scale of the fused top-k; the JAX
    package multiplies the raw codes in, 127 times larger."""
    x, fresh, _q = data
    t = TAnn(D, snapshot_kind="ivfpq", dtype=torch.int8, device="cpu", **KW)
    t.add(torch.from_numpy(x), list(range(600)))
    t.refresh_ann()
    t.add(torch.from_numpy(fresh), [f"f{i}" for i in range(40)])
    probe = np.concatenate([x[:4], fresh[:4]])
    _ids, vals, rows = t.search(torch.from_numpy(probe), k=3)
    assert t._n_snap == 600
    assert rows[:, 0].tolist() == [0, 1, 2, 3, 600, 601, 602, 603]
    np.testing.assert_allclose(vals[:, 0], 1.0, rtol=0, atol=2e-2)


def test_export_and_adopt_refuse_stale_snapshots(data, tmp_path):
    x, _fresh, _q = data
    t = TAnn(D, snapshot_kind="ivfpq", dtype=torch.float32, device="cpu",
             **KW)
    t.add(torch.from_numpy(x), list(range(600)))
    path = str(tmp_path / "e.npz")
    t.export_corpus(path)
    assert not t.adopt_snapshot(path)                    # no sidecar yet
    j = JAnn.load(path, snapshot_kind="ivfpq", **KW)
    j.refresh_ann()
    j.save(path)
    assert t.adopt_snapshot(path) and t._n_snap == 600
    t.delete([5])
    t.compact()                                          # renumbers rows
    assert not t.adopt_snapshot(path)


# ------------------------------------------------------------------ store
CFG = dict(vocab_size=600, hidden_size=D, num_layers=1, num_heads=2,
           intermediate_size=64, max_position_embeddings=128)
_WORDS = ("tpu gpu kernel tensor matrix vector index search query lexical "
          "semantic hybrid ranking score embed encoder token batch device "
          "memory cache latency throughput shard replica cluster").split()
QUERIES = ["hybrid ranking score", "gpu kernel", "lexical search query",
           "throughput", "unmatched words zzz qqq"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """TpuVectorStore over the JAX AnnFlatIndex and TorchVectorStore over
    the port's, same documents and weights; the port adopts the snapshot
    the JAX package built."""
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(_WORDS, rng.integers(4, 12)))
             for _ in range(320)]
    metas = [{"source": "a" if i % 3 else "b"} for i in range(320)]
    ids = [f"doc-{i}" for i in range(320)]
    jtok = JaxTokenizer.build_vocab(texts, size=CFG["vocab_size"])
    jemb = JaxEmbedder(config=JaxConfig(**CFG), tokenizer=jtok,
                       compute_dtype=jnp.float32, attention_impl="xla")
    temb = TorchEmbedder(config=BertConfig(**CFG),
                         tokenizer=WordPieceTokenizer(dict(jtok.vocab)),
                         device="cpu")
    jidx = JAnn(D, snapshot_kind="ivfpq", dtype=jnp.float32, **KW)
    tidx = TAnn(D, snapshot_kind="ivfpq", dtype=torch.float32, device="cpu",
                **KW)
    js = jvs.TpuVectorStore(jemb, index=jidx)
    ts = tvs.TorchVectorStore(temb, index=tidx)
    for s in (js, ts):
        s.add_texts(texts, metadatas=metas, ids=ids)
    path = str(tmp_path_factory.mktemp("store") / "snap.npz")
    jidx.refresh_ann()
    jidx.save(path)
    assert tidx.adopt_snapshot(path)
    return js, ts


def assert_same_results(got, want, tol=1e-4):
    assert len(got) == len(want)
    gs, ws = [s for _, s in got], [s for _, s in want]
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    for (gd, s), (wd, _) in zip(got, want):
        if gd.metadata["chunk_id"] != wd.metadata["chunk_id"]:
            assert sum(abs(x - s) <= tol for x in ws) > 1  # a tie


@pytest.mark.parametrize("kw", [{}, {"filter": {"source": "b"}}])
def test_store_batches_over_the_adopted_snapshot(stores, kw):
    js, ts = stores
    got = ts.hybrid_search_batch(QUERIES, k=4, **kw)
    want = js.hybrid_search_batch(QUERIES, k=4, **kw)
    for g, w in zip(got, want):
        assert_same_results(g, w)
    for g, w in zip(ts.similarity_search_batch(QUERIES, k=4, **kw),
                    js.similarity_search_batch(QUERIES, k=4, **kw)):
        assert_same_results(g, w)
    if kw:
        assert all(d.metadata["source"] == "b" for r in got for d, _ in r)


def test_store_load_takes_an_index_loader(stores, tmp_path):
    """Repair: ``load`` restores an AnnFlatIndex (rows + snapshot sidecar)
    through ``index_loader``, or its class through ``index_cls``."""
    js, ts = stores
    ts.save(str(tmp_path / "s"))
    t2 = tvs.TorchVectorStore.load(
        str(tmp_path / "s"), ts._embedding_function,
        index_loader=lambda p: TAnn.load(p, device="cpu",
                                         snapshot_kind="ivfpq", **KW))
    assert isinstance(t2.index, TAnn) and t2.index._n_snap == 320
    for g, w in zip(t2.hybrid_search_batch(QUERIES, k=4),
                    js.hybrid_search_batch(QUERIES, k=4)):
        assert_same_results(g, w)
    t3 = tvs.TorchVectorStore.load(str(tmp_path / "s"),
                                   ts._embedding_function, device="cpu",
                                   index_cls=TAnn)
    assert type(t3.index) is TAnn and t3.count() == 320


def test_store_calls_per_query_for_an_index_without_batched_bias(stores):
    """Repair: an index that does not declare ``supports_batched_bias``
    gets one ``hybrid_search`` per query, as in the JAX package."""
    _js, ts = stores

    class OneQueryAtATime(TAnn):
        supports_batched_bias = False

        def search(self, queries, k=10, *, filter_mask=None, bias=None,
                   nprobe=None):
            assert bias is None or torch.as_tensor(bias).dim() == 1
            return super().search(queries, k, filter_mask=filter_mask,
                                  bias=bias, nprobe=nprobe)

    plain = ts.index
    ts.index = OneQueryAtATime.__new__(OneQueryAtATime)
    ts.index.__dict__.update(plain.__dict__)
    try:
        got = ts.hybrid_search_batch(QUERIES, k=4)
    finally:
        ts.index = plain
    for g, q in zip(got, QUERIES):
        assert_same_results(g, ts.hybrid_search(q, k=4))
