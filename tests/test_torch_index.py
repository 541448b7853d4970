"""The port's FlatIndex, BM25Index, analyser and tokenizer against the JAX
package, on the same numpy inputs.

FlatIndex: same operations on both packages give the same capacity, ids and
scores (rtol/atol 1e-4), and an npz written by either package loads in the
other with identical search results.  BM25: dense scores at rtol 1e-6
(tests/unit/test_bm25.py), incremental equals fresh, JSON cross-loads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import bm25 as jbm25
from archi_tpu.engine.flat_index import FlatIndex as JaxFlatIndex
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu_torch.engine import bm25 as tbm25
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.models.tokenizer import WordPieceTokenizer

TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _vecs(seed, n, d=32):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _pair(dtype, d=32):
    jd, td = DTYPES[dtype]
    return JaxFlatIndex(d, dtype=jd, tile_n=256), \
        FlatIndex(d, dtype=td, tile_n=256, device="cpu")


def _search_both(jidx, tidx, q, k=10, **kw):
    jids, jv, _ = jidx.search(q, k=k, **kw)
    tids, tv, _ = tidx.search(q, k=k, **kw)
    return (jids, np.asarray(jv)), (tids, tv)


def _assert_same(a, b, tol=TOL):
    (aids, av), (bids, bv) = a, b
    np.testing.assert_allclose(bv, av, rtol=tol, atol=tol)
    for ra, rb, va in zip(aids, bids, av):
        for x, y, s in zip(ra, rb, va):
            # ids may differ only between (near-)equal scores
            assert x == y or np.sum(np.abs(va - s) <= tol) > 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flat_index_add_delete_grow_compact(dtype):
    jidx, tidx = _pair(dtype)
    q = _vecs(99, 3)
    steps = [("add", 300), ("add", 900), ("delete", 40), ("add", 2500),
             ("compact", 0), ("add", 7)]
    next_id = 0
    for op, n in steps:
        if op == "add":
            v = _vecs(next_id, n)
            ids = list(range(next_id, next_id + n))
            assert jidx.add(v, ids) == tidx.add(v, ids)
            next_id += n
        elif op == "delete":
            gone = list(range(5, 5 + n))
            assert jidx.delete(gone) == tidx.delete(gone) == n
        else:
            jidx.compact()
            tidx.compact()
        assert tidx.capacity == jidx.capacity and len(tidx) == len(jidx)
        assert tidx.n_rows == jidx.n_rows
        _assert_same(*_search_both(jidx, tidx, q))
    deleted = set(range(5, 45))
    _, _, rows = tidx.search(q, k=50)
    assert not deleted & {tidx._ids[r] for r in rows.ravel()}


def test_flat_index_filter_and_bias():
    jidx, tidx = _pair("float32")
    v = _vecs(1, 600)
    jidx.add(v, list(range(600)))
    tidx.add(v, list(range(600)))
    q = _vecs(2, 4)
    rng = np.random.default_rng(3)
    fm = (rng.random(600) > 0.5).astype(np.float32)
    _assert_same(*_search_both(jidx, tidx, q, filter_mask=fm))
    shared = rng.random(600).astype(np.float32)
    _assert_same(*_search_both(jidx, tidx, q, bias=shared))
    per_query = rng.random((4, 600)).astype(np.float32)
    _assert_same(*_search_both(jidx, tidx, q, bias=per_query))
    _assert_same(*_search_both(jidx, tidx, q[0], k=3))


def test_int8_storage_is_clip_round_127():
    tidx = FlatIndex(8, dtype="int8", device="cpu", normalize=False)
    x = np.array([[0.5, -1.0, 1.2, 0.0, 0.004, -0.996, 0.25, 0.1]],
                 np.float32)
    tidx.add(x, ["a"])
    want = np.clip(np.round(x * 127), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(tidx.emb[:1].numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_npz_cross_loads(dtype, tmp_path):
    jidx, tidx = _pair(dtype)
    v = _vecs(4, 700)
    ids = [f"c{i}" for i in range(350)] + list(range(350))
    jidx.add(v, ids)
    tidx.add(v, ids)
    jidx.delete(["c3", 10])
    tidx.delete(["c3", 10])
    jidx.save(str(tmp_path / "jax.npz"))
    tidx.save(str(tmp_path / "torch.npz"))
    for name in ("jax", "torch"):
        j2 = JaxFlatIndex.load(str(tmp_path / name))
        t2 = FlatIndex.load(str(tmp_path / name), device="cpu")
        assert t2.dtype == DTYPES[dtype][1] and t2._ids == j2._ids
        assert t2.capacity == j2.capacity and len(t2) == 698
        q = _vecs(5, 3)
        jr, tr = _search_both(j2, t2, q)
        np.testing.assert_allclose(tr[1], jr[1], rtol=TOL, atol=TOL)
        assert tr[0] == jr[0]
        z = np.load(tmp_path / f"{name}.npz")
        assert sorted(z.files) == ["alive", "emb", "meta"]


# ------------------------------------------------------------------- BM25
CORPUS = [
    "The quick brown fox jumps over the lazy dog",
    "A fast brown fox leaps over lazy hounds",
    "Retrieval augmented generation on accelerators",
    "Hybrid search combines BM25 with dense retrieval",
    "Dense retrieval embeds queries and documents",
    "The dog sleeps; the fox runs",
    "Tokenizer tests: café naïve résumé über",
    "Numbers 123 and 4567 are dropped, x y single letters too",
]
QUERIES = ["brown fox", "dense retrieval", "lazy dog sleeps", "café résumé",
           "hybrid BM25", "nothing matches zzz"]


def _bm25_pair(stemming=False):
    return (jbm25.BM25Index(stemming=stemming),
            tbm25.BM25Index(stemming=stemming, device="cpu"))


def _scores(idx, q, n=16):
    s = idx.scores(q, n)
    return s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s)


@pytest.mark.parametrize("stemming", [False, True])
def test_bm25_scores_match_jax(stemming):
    jidx, tidx = _bm25_pair(stemming)
    rows = list(range(len(CORPUS)))
    jidx.add(rows, CORPUS)
    tidx.add(rows, CORPUS)
    for q in QUERIES:
        np.testing.assert_allclose(_scores(tidx, q), _scores(jidx, q),
                                   rtol=1e-6, atol=0)
    jv, jr = jidx.topk("brown fox dog", 16, k=5)
    tv, tr = tidx.topk("brown fox dog", 16, k=5)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_bm25_incremental_equals_fresh_and_remove():
    inc = tbm25.BM25Index(device="cpu")
    for i, text in enumerate(CORPUS):       # one delta flush per query
        inc.add([i], [text])
        inc.scores("fox", 16)
    assert inc.delta_flushes >= 1
    fresh = tbm25.BM25Index(device="cpu")
    fresh.add(list(range(len(CORPUS))), CORPUS)
    jidx = jbm25.BM25Index()
    jidx.add(list(range(len(CORPUS))), CORPUS)
    for q in QUERIES:
        np.testing.assert_allclose(_scores(inc, q), _scores(fresh, q),
                                   rtol=1e-6)
    inc.remove([0, 5])
    jidx.remove([0, 5])
    for q in QUERIES:
        np.testing.assert_allclose(_scores(inc, q), _scores(jidx, q),
                                   rtol=1e-6, atol=0)


def test_bm25_rebuild_after_many_flushes(monkeypatch):
    monkeypatch.setattr(tbm25, "REBUILD_FLUSHES", 3)
    idx = tbm25.BM25Index(device="cpu")
    for i, text in enumerate(CORPUS):
        idx.add([i], [text])
        idx.scores("retrieval", 16)
    assert idx.full_builds >= 2
    fresh = tbm25.BM25Index(device="cpu")
    fresh.add(list(range(len(CORPUS))), CORPUS)
    np.testing.assert_allclose(_scores(idx, "retrieval fox"),
                               _scores(fresh, "retrieval fox"), rtol=1e-6)


def test_bm25_long_postings_span_chunks():
    """A term in more rows than one work-list chunk holds."""
    n = tbm25.CHUNK * 2 + 37
    texts = [f"common word{i % 7}" for i in range(n)]
    jidx, tidx = _bm25_pair()
    jidx.add(list(range(n)), texts)
    tidx.add(list(range(n)), texts)
    np.testing.assert_allclose(_scores(tidx, "common word3", n),
                               _scores(jidx, "common word3", n), rtol=1e-6)


def test_bm25_json_cross_loads(tmp_path):
    jidx, tidx = _bm25_pair(stemming=True)
    rows = list(range(len(CORPUS)))
    jidx.add(rows, CORPUS)
    tidx.add(rows, CORPUS)
    jidx.save(str(tmp_path / "jax.json"))
    tidx.save(str(tmp_path / "torch.json"))
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "torch.json").read_text()
    t2 = tbm25.BM25Index.load(str(tmp_path / "jax.json"), device="cpu")
    j2 = jbm25.BM25Index.load(str(tmp_path / "torch.json"))
    for q in QUERIES:
        np.testing.assert_allclose(_scores(t2, q), _scores(j2, q), rtol=1e-6)


# ------------------------------------------------- analyser and tokenizer
TEXTS = CORPUS + [
    "Ünïcödé — “quotes”, em–dashes… and €uros; 中文字符 mixed in",
    "e-mail: someone@example.com, URL https://x.org/a_b?c=d",
    "tabs\tand\nnewlines\r\n and \x00 control ​ chars",
    "SHOUTING CamelCase mIxEd 42nd 3rd",
]


@pytest.mark.parametrize("stemming", [False, True])
def test_analyze_matches_reference(stemming):
    for text in TEXTS:
        assert tbm25.analyze(text, stemming=stemming) == \
            jbm25.analyze(text, stemming=stemming), text


def test_tokenizer_ids_match_reference():
    jtok = JaxTokenizer.build_vocab(TEXTS, size=400)
    ttok = WordPieceTokenizer.build_vocab(TEXTS, size=400)
    assert ttok.vocab == jtok.vocab
    for text in TEXTS + ["unseenword supercalifragilistic"]:
        for max_len in (8, 512):
            assert ttok.encode(text, max_len) == jtok.encode(text, max_len)
        assert ttok.tokenize(text) == jtok.tokenize(text)
    ids = ttok.encode(TEXTS[0])
    assert ttok.decode(ids) == jtok.decode(ids)



def test_filter_mask_longer_than_the_snapshot_is_cut():
    """A mask built after a concurrent append grew the capacity is longer
    than the snapshot a search reads; it is cut to the snapshot."""
    tidx = FlatIndex(32, dtype="float32", tile_n=256, device="cpu")
    v = _vecs(0, 100)
    tidx.add(v, list(range(100)))
    q = np.stack([v[7], v[8]])
    mask = np.ones(tidx.capacity, np.float32)
    mask[7] = 0.0
    want = tidx.search(q, k=5, filter_mask=mask)
    longer = np.concatenate([mask, np.ones(3 * tidx.capacity, np.float32)])
    got = tidx.search(q, k=5, filter_mask=longer)
    assert got[0] == want[0] and 7 not in got[0][0] and got[0][1][0] == 8
    np.testing.assert_array_equal(got[1], want[1])


def test_concurrent_ingest_and_search_see_consistent_snapshots():
    """Searches and BM25 scoring running while another thread appends
    (growing the buffers) and deletes never fail, and only return rows that
    were added; after the writer stops, deleted ids never come back."""
    import sys
    import threading

    tidx = FlatIndex(16, dtype="bfloat16", tile_n=256, device="cpu")
    bm = tbm25.BM25Index(device="cpu")
    texts = lambda ids: [f"word{i % 5} common" for i in ids]  # noqa: E731
    tidx.add(_vecs(0, 64, d=16), list(range(64)))
    bm.add(list(range(64)), texts(range(64)))
    steps = 30
    errors, stop = [], threading.Event()

    def writer():
        try:
            for step in range(1, steps):
                ids = list(range(64 * step, 64 * (step + 1)))
                bm.add(tidx.add(_vecs(step, 64, d=16), ids), texts(ids))
                tidx.delete([64 * step])
        except Exception as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)
        finally:
            stop.set()

    def reader(seed):
        q = _vecs(100 + seed, 2, d=16)
        try:
            while not stop.is_set():
                ids, vals, _ = tidx.search(q, k=8)
                assert all(i is None or 0 <= i < 64 * steps
                           for row in ids for i in row)
                assert np.isfinite(vals).all()
                s = bm.scores("word3", tidx.capacity)
                assert s.shape[0] >= 64 and torch.isfinite(s).all()
        except Exception as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(tidx) == 64 * steps - (steps - 1)
    gone = {64 * s for s in range(1, steps)}
    ids, _, _ = tidx.search(_vecs(7, 64, d=16), k=64)
    assert not gone & {i for row in ids for i in row}
