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


def _long_corpus():
    n = tbm25.CHUNK * 2 + 37          # "common" spans three pieces
    return [f"common word{i % 7}" for i in range(n)]


def _fill_at_once(idx, texts):
    idx.add(list(range(len(texts))), texts)


def _fill_with_flushes(idx, texts):
    """One delta flush per document (a query between adds)."""
    for i, text in enumerate(texts):
        idx.add([i], [text])
        idx.scores("fox", 16)


def _fill_then_remove(idx, texts):
    _fill_at_once(idx, texts)
    idx.scores("fox", 16)
    idx.remove([0, 5])


def _fill_then_upsert(idx, texts):
    """Rows 2 and 5 added again (5 twice in one batch) before the first
    query: a row's old terms stay, its counts and length are the last
    text's, as the JAX package's dicts keep them."""
    _fill_at_once(idx, texts)
    idx.add([2, 5, 5], ["fox fox retrieval upserted", "dense fox",
                        "lazy lazy hounds dense"])


#: native-route texts around texts only the Python route takes: non-Latin
#: scripts, an empty text, one of stopwords only, a Latin one transliterated
MIXED_ROUTES = CORPUS[:3] + [
    "日本語のテキスト fox", "", "the and of to it", "Привет мир brown fox",
    "Ångström über straße dog", "café naïve fox"] + CORPUS[3:]


def _flush_corpus():
    """One more document than delta flushes before a full rebuild."""
    return [f"fox doc{i} common w{i % 5}" for i in
            range(tbm25.REBUILD_FLUSHES + 2)]


#: (corpus, how it is filled, queries, n_pad, stemming): empty, unknown and
#: repeated terms; postings longer than two pieces; deltas, past the
#: rebuild after ``REBUILD_FLUSHES``; removes; upserts; batches mixing the
#: native and Python routes; stemming; one query; a n_pad below the rows,
#: whose postings are dropped
BATCH_CASES = {
    "mixed": (CORPUS, _fill_at_once,
              QUERIES + ["", "fox fox brown fox", "zzz qqq"], 16, False),
    "long_postings": (_long_corpus(), _fill_at_once,
                      ["common word3", "word1", "zzz", "common"],
                      tbm25.CHUNK * 2 + 40, False),
    "after_flushes": (CORPUS, _fill_with_flushes, QUERIES, 16, False),
    "after_remove": (CORPUS, _fill_then_remove, QUERIES, 16, False),
    "one_query": (CORPUS, _fill_at_once, ["lazy dog sleeps"], 16, False),
    "rows_dropped": (CORPUS, _fill_at_once, QUERIES, 5, False),
    "upsert": (CORPUS, _fill_then_upsert,
               QUERIES + ["upserted", "hounds"], 16, False),
    "mixed_routes": (MIXED_ROUTES, _fill_at_once,
                     QUERIES + ["日本語のテキスト", "привет fox", "straße",
                                "ångström", "naive"], 16, False),
    "stemming": (CORPUS + ["Running runners ran; jumping jumps"],
                 _fill_at_once,
                 QUERIES + ["running jump", "leaping", "combining"], 16,
                 True),
    "rebuild_flushes": (_flush_corpus(), _fill_with_flushes,
                        ["common w3", "doc7 doc65", "fox"], 128, False),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_bm25_scores_batch_rows_match_jax(case):
    """Each row of one batched pass equals the JAX package's scores of its
    query; ``hit`` is "the row's best score is above 0"; the padding rows
    are zero."""
    texts, fill, queries, n_pad, stemming = BATCH_CASES[case]
    jidx, tidx = _bm25_pair(stemming)
    fill(jidx, texts)
    fill(tidx, texts)
    if case == "rebuild_flushes":
        assert tidx.full_builds == 2
    scores, hit = tidx.scores_batch(queries, n_pad,
                                    n_rows=len(queries) + 3)
    assert scores.shape == (len(queries) + 3, n_pad)
    assert scores.dtype == torch.float32 and hit.dtype == torch.bool
    for row, q in zip(scores.numpy(), queries):
        np.testing.assert_allclose(row, _scores(jidx, q, n_pad), rtol=1e-6,
                                   atol=0)
    assert torch.equal(hit, scores.max(dim=1).values > 0)
    assert not scores[len(queries):].any()
    if case == "rows_dropped":   # postings of rows >= n_pad were there
        full, _ = tidx.scores_batch(queries, 16)
        assert (full[:, n_pad:] > 0).any()
        torch.testing.assert_close(full[:, :n_pad], scores[:len(queries)],
                                   rtol=1e-6, atol=0)
    else:
        assert hit[:len(queries)].any() and not hit[len(queries):].any()


def _snapshot_sets(idx):
    """What a query reads, order aside: each term's (row, tf, dl) entries
    as a set and its df, and the entry and document counts."""
    idx._ensure_built()
    snap = idx._snap
    rows, tf, dl = (t.numpy() for t in (snap.rows, snap.tf, snap.dl))
    terms = {}
    for tid, (pieces, df) in snap.terms.items():
        entries = {(int(rows[i]), float(tf[i]), float(dl[i]))
                   for start, length in pieces.tolist()
                   for i in range(start, start + length)}
        terms[tid] = (entries, df)
    return terms, snap.nnz, snap.n_docs, snap.len_sum


def _one_at_a_time(idx, steps):
    for rows, texts in steps:
        for row, text in zip(rows, texts):
            idx.add([row], [text])
            idx.scores("fox", 16)


#: (add, remove) steps: batches of (rows, texts); "remove" removes rows
SNAPSHOT_STEPS = {
    "fill": [(list(range(len(MIXED_ROUTES))), MIXED_ROUTES)],
    "upsert": [(list(range(len(CORPUS))), CORPUS),
               ([3, 6], ["dense fox upserted", "hounds hounds"])],
    "remove": [(list(range(len(CORPUS))), CORPUS), "remove",
               ([9, 2], ["brown dog returns", "fox"])],
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_STEPS))
def test_bm25_batch_snapshot_equals_one_text_at_a_time(case):
    """A batched fill (one add a step, a full build) and a fill one text
    at a time with a delta flush after each publish the same entries:
    per term the same (row, tf, dl) and df, and the same counts."""
    batched = tbm25.BM25Index(device="cpu")
    single = tbm25.BM25Index(device="cpu")
    for step in SNAPSHOT_STEPS[case]:
        if step == "remove":
            for idx in (batched, single):
                idx.remove([0, 5])
            continue
        batched.add(*step)
        batched.scores("fox", 16)
        _one_at_a_time(single, [step])
    assert single.delta_flushes > 0
    assert batched._term_ids == single._term_ids
    assert _snapshot_sets(batched) == _snapshot_sets(single)


def _ingest_rounds_view(idx, rows, texts):
    """What the held ingest cell's harness reads of the index
    (``ragbench/traffic/ingest_rounds.py``): every term's count in each
    row, and each row's length."""
    out = {}
    for row in rows:
        tf = {}
        for t in {t for text in texts for t in tbm25.analyze(text)}:
            tid = idx._term_ids.get(t)
            f = idx._postings[tid].get(row) if tid is not None else None
            if f is not None:
                tf[t] = f
        out[row] = (idx._doc_len.get(row), tf)
    return out


def test_bm25_postings_reads_match_jax_and_save_round_trips(tmp_path):
    """``_postings[tid].get(row)``, ``len(_postings[tid])`` and
    ``_doc_len.get(row)`` read what the JAX package's dicts hold, through
    adds, an upsert and a remove; ``save`` writes its bytes, and ``load``
    then ``save`` writes them again."""
    jidx, tidx = _bm25_pair()
    texts = MIXED_ROUTES + ["fox fox upserted", "common words"]
    # rows out of order: a term's rows, and the documents, save in the
    # order they were added
    rows = list(range(len(MIXED_ROUTES)))[::-1] + [4, 40]
    for idx in (jidx, tidx):
        idx.add(rows[:6], texts[:6])
        idx.scores("fox", 64)
        idx.add(rows[6:], texts[6:])
        idx.remove([1, 7])
    probe = sorted(set(rows)) + [1, 7, 99]
    assert _ingest_rounds_view(tidx, probe, texts) == \
        _ingest_rounds_view(jidx, probe, texts)
    assert [len(tidx._postings[t]) for t in range(tidx.n_terms)] == \
        [len(p) for p in jidx._postings]
    assert len(tidx._doc_len) == len(jidx._doc_len) == tidx.n_docs
    jidx.save(str(tmp_path / "jax.json"))
    tidx.save(str(tmp_path / "torch.json"))
    saved = (tmp_path / "torch.json").read_bytes()
    assert saved == (tmp_path / "jax.json").read_bytes()
    tbm25.BM25Index.load(str(tmp_path / "torch.json"), device="cpu").save(
        str(tmp_path / "again.json"))
    assert (tmp_path / "again.json").read_bytes() == saved


@pytest.mark.parametrize("row", [-1, 2 ** 31])
def test_bm25_rows_outside_the_device_buffers_are_refused(row):
    """Rows index int32 device buffers: one outside [0, 2**31) is refused
    before the batch changes anything."""
    idx = tbm25.BM25Index(device="cpu")
    with pytest.raises(ValueError, match="rows"):
        idx.add([0, row], ["fox", "dog"])
    assert idx.n_terms == 0 and idx.n_docs == 0


@pytest.mark.parametrize("native_on", [True, False])
def test_bm25_empty_batch_changes_nothing(native_on):
    """An add of no texts, on either analysis route, leaves the index and
    its scores as they were."""
    from archi_tpu_torch import native
    idx = tbm25.BM25Index(device="cpu")
    idx.add([0, 1], ["fox dog", "brown fox"])
    want = idx.scores("fox", 8)
    previous = native.use_native(native_on)
    try:
        idx.add([], [])
        idx.add_analyzed([], [])
    finally:
        native.use_native(previous)
    assert (idx.n_docs, idx.n_terms) == (2, 3)
    assert torch.equal(idx.scores("fox", 8), want)


def test_bm25_scores_is_the_batch_of_one():
    _jidx, tidx = _bm25_pair()
    _fill_at_once(tidx, CORPUS)
    batch, _ = tidx.scores_batch(QUERIES, 16)
    for q, row in zip(QUERIES, batch):
        assert torch.equal(tidx.scores(q, 16), row)
    with pytest.raises(ValueError, match="n_rows"):
        tidx.scores_batch(QUERIES, 16, n_rows=2)


def test_bm25_batches_see_whole_snapshots_while_ingest_flushes():
    """Batches scored while another thread adds documents and flushes them
    each equal the scores of the index after some whole number of the
    writer's adds: buffers, pieces, df and document stats of one state."""
    import sys
    import threading
    import time

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(12)]
    docs = [" ".join(rng.choice(words, rng.integers(1, 6))) for _ in range(96)]
    steps = [docs[:16]] + [docs[16 + 8 * i:24 + 8 * i] for i in range(10)]
    queries = ["w1 w2", "w3", "w4 w5 w6", "unknown", "w0 w7 w11"]
    idx = tbm25.BM25Index(device="cpu")
    idx.add(list(range(16)), steps[0])
    seen, errors, stop = [], [], threading.Event()

    def writer():
        try:
            row = 16
            for batch in steps[1:]:
                # let the readers score between the steps too
                mark, deadline = len(seen), time.monotonic() + 5
                while len(seen) <= mark and time.monotonic() < deadline:
                    time.sleep(1e-4)
                idx.add(list(range(row, row + len(batch))), batch)
                row += len(batch)
                idx._ensure_built()
        except Exception as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                seen.append(idx.scores_batch(queries, 128)[0].numpy())
        except Exception as e:  # noqa: BLE001 — re-raised by the test
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(seen) >= len(steps)
    states = []
    for k in range(1, len(steps) + 1):
        fresh = tbm25.BM25Index(device="cpu")
        texts = [t for batch in steps[:k] for t in batch]
        fresh.add(list(range(len(texts))), texts)
        states.append(fresh.scores_batch(queries, 128)[0].numpy())
    for got in seen:
        assert any(np.allclose(got, want, rtol=1e-6, atol=0)
                   for want in states)


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
