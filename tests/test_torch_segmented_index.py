"""The port's hot-tail ``SegmentedFlatIndex`` against the JAX package's
``archi_tpu/engine/segmented_index.py`` on the same rows: parity across
merges, deletes in main and tail, filter/bias alignment by global row, the
id view, checkpoints read by the other package, concurrent ingest + query;
and ``FlatIndex._grow_to`` / ``_write_block`` (the merge's block write).

f32 rows: scores within 1e-5, rows tie-aware (random rows have no ties).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine.segmented_index import SegmentedFlatIndex as JSeg
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.segmented_index import SegmentedFlatIndex

TOL = 1e-5


def _pair(dim=32, merge_rows=300):
    t = SegmentedFlatIndex(dim, dtype=torch.float32, tile_n=256,
                           merge_rows=merge_rows, tail_tile_n=256,
                           device="cpu")
    j = JSeg(dim, dtype=jnp.float32, tile_n=256, merge_rows=merge_rows,
             tail_tile_n=256)
    return t, j


def _add_batches(t, j, rng, n_batches=8, batch=100, dim=32):
    for b in range(n_batches):
        vecs = rng.standard_normal((batch, dim)).astype(np.float32)
        ids = [f"c{b * batch + i}" for i in range(batch)]
        assert t.add(vecs, ids) == j.add(vecs, ids)  # GLOBAL rows agree


def _same(got, want):
    (gi, gv, gr), (wi, wv, wr) = got, want
    np.testing.assert_allclose(gv, np.asarray(wv), rtol=0, atol=TOL)
    assert [list(r) for r in gr] == [list(map(int, r)) for r in wr]
    assert gi == wi


@pytest.fixture
def pair(rng):
    t, j = _pair()
    _add_batches(t, j, rng)
    return t, j


def test_parity_across_merges(pair, rng):
    t, j = pair
    assert t.n_rows == j.n_rows == 800
    assert t.n_merged == j.n_merged >= 300     # merged at least once
    assert t.capacity == j.capacity
    q = rng.standard_normal((5, 32)).astype(np.float32)
    _same(t.search(q, k=10), j.search(q, k=10))
    _same(t.search(q[0], k=3), j.search(q[0], k=3))
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))


def test_delete_in_main_and_tail(pair, rng):
    t, j = pair
    dead = ["c5", "c350", "c799"]  # main, main (post-merge), tail
    assert t.delete(dead) == j.delete(dead) == 3
    assert len(t) == len(j) == 797 and t._n_dead == 3
    q = rng.standard_normal((3, 32)).astype(np.float32)
    got = t.search(q, k=20)
    _same(got, j.search(q, k=20))
    for rr in got[2]:
        assert not {5, 350, 799} & set(rr.tolist())


def test_filter_and_bias_alignment_across_segments(pair, rng):
    """Per-global-row vectors hit the same rows in main and tail, shared
    [N] and per-query [B, N], numpy and tensor."""
    t, j = pair
    q = rng.standard_normal((2, 32)).astype(np.float32)
    fm = np.zeros(t.capacity, np.float32)
    fm[[10, 400, 777]] = 1.0  # main + merged + tail rows
    bias = np.zeros(t.capacity, np.float32)
    bias[400] = 5.0
    got = t.search(q, k=3, filter_mask=fm, bias=bias)
    _same(got, j.search(q, k=3, filter_mask=fm, bias=bias))
    assert all(r[0] == 400 for r in got[2])  # bias dominates
    per_q = np.zeros((2, t.capacity), np.float32)
    per_q[0, 777] = 5.0                       # a tail row for query 0
    per_q[1, 10] = 5.0                        # a main row for query 1
    got = t.search(q, k=4, bias=torch.from_numpy(per_q))
    _same(got, j.search(q, k=4, bias=per_q))
    assert got[2][0][0] == 777 and got[2][1][0] == 10


def test_id_rows_view_and_keys_union(pair):
    t, j = pair
    assert t.tail.n_rows > 0
    for key in ("c0", "c799", "c350", "nope"):
        assert (key in t._id_rows) == (key in j._id_rows)
        assert t._id_rows.get(key) == j._id_rows.get(key)
    assert t._id_rows.keys() == j._id_rows.keys()
    assert set(iter(t._id_rows)) == set(t._id_rows.keys())
    assert t._id_rows.pop("c1") == j._id_rows.pop("c1") == [1]
    assert "c1" not in t._id_rows


def test_explicit_merge_and_compact(rng):
    t, j = _pair()
    _add_batches(t, j, rng, n_batches=2)   # below the merge threshold
    for idx in (t, j):
        assert idx.tail.n_rows == 200
        idx.merge()
        assert idx.tail.n_rows == 0 and idx.n_merged == 200
        idx.delete(["c0", "c1"])
        idx.compact()
        assert len(idx) == 198
    q = rng.standard_normal((2, 32)).astype(np.float32)
    _same(t.search(q, k=5), j.search(q, k=5))


def test_checkpoints_cross_packages(pair, rng, tmp_path):
    t, j = pair
    for idx in (t, j):
        idx.delete(["c7", "c790"])
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    t2 = SegmentedFlatIndex.load(str(tmp_path / "j.npz"), merge_rows=300,
                                 device="cpu")
    j2 = JSeg.load(str(tmp_path / "t.npz"), merge_rows=300)
    assert len(t2) == len(j2) == len(t) == 798
    assert t2.dtype == torch.float32 and t2.merge_rows == 300
    q = rng.standard_normal((3, 32)).astype(np.float32)
    _same(t2.search(q, k=6), j2.search(q, k=6))
    # appends after the reload go through the tail of both
    vecs = rng.standard_normal((5, 32)).astype(np.float32)
    assert t2.add(vecs, list("abcde")) == j2.add(vecs, list("abcde"))
    assert t2.tail.n_rows == 5
    _same(t2.search(vecs, k=3), j2.search(vecs, k=3))


def test_concurrent_ingest_and_query(rng):
    """Queries racing adds + merges never miss previously-visible rows and
    never return duplicate rows."""
    seg = SegmentedFlatIndex(16, dtype=torch.float32, tile_n=256,
                             merge_rows=128, tail_tile_n=256, device="cpu")
    base = rng.standard_normal((200, 16)).astype(np.float32)
    seg.add(base, list(range(200)))
    probe = base[:4] / np.linalg.norm(base[:4], axis=1, keepdims=True)
    stop = threading.Event()
    errors: list = []
    merges = []

    def ingest():
        i = 0
        while not stop.is_set():
            vecs = rng.standard_normal((64, 16)).astype(np.float32)
            seg.add(vecs, list(range(1000 + 64 * i, 1000 + 64 * (i + 1))))
            merges.append(seg._merge_epoch)
            i += 1

    th = threading.Thread(target=ingest, daemon=True)
    th.start()
    try:
        for _ in range(60):
            _ids, _vals, rows = seg.search(probe, k=8)
            for qi in range(4):
                rr = [int(r) for r in rows[qi]]
                if len(set(rr)) != len(rr):
                    errors.append(("dup", rr))
                if rr[0] != qi:  # its own vector stays rank-1
                    errors.append(("miss", qi, rr))
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert not errors, errors[:5]
    assert merges and merges[-1] > 1           # merges really raced
    # no row lost: every id added is found by its global row
    n = seg.n_rows
    assert len(seg) == n and seg._id_rows.get(0) == [0]
    assert sorted(r for k in seg._id_rows.keys()
                  for r in seg._id_rows.get(k)) == list(range(n))


def test_vectorstore_over_segmented_index():
    """TorchVectorStore's global-row couplings (bm25 bias, enabled-ids
    masks, alive view, id lookups) hold over the hot-tail index."""
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.registry import HashEmbeddings

    idx = SegmentedFlatIndex(64, dtype=torch.float32, tile_n=256,
                             merge_rows=3, tail_tile_n=256, device="cpu")
    store = TorchVectorStore(HashEmbeddings(64), index=idx)
    store.add_texts(["the quick brown fox", "lazy dog sleeps"],
                    [{"source": "a"}, {"source": "b"}], ids=["x1", "x2"])
    store.add_texts(["fox runs through the forest", "cat naps quietly"],
                    [{"source": "c"}, {"source": "d"}], ids=["x3", "x4"])
    store.add_texts(["a fox sleeps in the tail"], [{"source": "e"}],
                    ids=["x5"])
    assert idx.n_merged == 4 and idx.tail.n_rows == 1
    res = store.hybrid_search("fox", k=2)
    assert res and all("fox" in d.page_content for d, _s in res)
    res = store.hybrid_search("fox", k=4, enabled_ids={"x3", "x5"})
    assert sorted(d.metadata["source"] for d, _s in res) == ["c", "e"]
    res = store.hybrid_search("fox", k=2, semantic_weight=0.0,
                              bm25_weight=1.0)
    assert res and all("fox" in d.page_content for d, _s in res)
    store.delete(["x1"])
    res = store.hybrid_search("quick brown", k=4)
    assert all(d.metadata["source"] != "a" for d, _s in res)
    assert store.count() == 4


# --------------------------------------------- FlatIndex block write (merge)
def test_grow_to_and_write_block():
    idx = FlatIndex(8, dtype=torch.float32, tile_n=256, device="cpu")
    x = np.eye(8, dtype=np.float32)
    idx.add(x[:3], ["a", "b", "c"])
    cap0 = idx.capacity
    idx._grow_to(cap0 + 1)
    assert idx.capacity == 2 * cap0 and idx.emb.shape[0] == 2 * cap0
    np.testing.assert_array_equal(idx.emb[:3].numpy(), x[:3])
    assert idx.alive[:3].tolist() == [1.0] * 3 and idx.alive[3:].sum() == 0
    idx._grow_to(5)                               # never shrinks
    assert idx.capacity == 2 * cap0
    block = torch.from_numpy(x[3:8])
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    old_emb = idx.emb
    idx._write_block(block, alive, 3, 8)
    assert idx.n_rows == 8 and idx.emb is not old_emb   # a new buffer
    assert old_emb[3:8].abs().sum() == 0                # readers' copy kept
    np.testing.assert_array_equal(idx.emb[:8].numpy(), x)
    assert idx.alive[:8].tolist() == [1, 1, 1, 1, 0, 1, 1, 1]
    with pytest.raises(ValueError):
        idx._write_block(block, alive, idx.capacity - 2, idx.capacity)


def test_write_block_swaps_rows_and_count_together():
    """A search racing block writes sees the old (emb, alive, n_rows) or
    the new one: the row written last is found exactly when it is live."""
    idx = FlatIndex(4, dtype=torch.float32, tile_n=256, device="cpu")
    idx.add(np.eye(4, dtype=np.float32)[:1], ["r0"])
    vec = np.asarray([[0.0, 1.0, 0.0, 0.0]], np.float32)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            vals, rows = idx.search_dispatch(vec, k=1)
            v, r = float(vals[0, 0]), int(rows[0, 0])
            if not (r == 0 and abs(v) < 1e-6 or r >= 1 and v > 0.99):
                errors.append((r, v))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        for n in range(1, 200):
            idx._grow_to(n + 1)
            idx._write_block(torch.from_numpy(vec), torch.ones(1), n, n + 1)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive() and not errors, errors[:5]
