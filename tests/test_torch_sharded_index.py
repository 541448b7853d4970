"""The port's corpus-sharded flat index
(``archi_tpu_torch/engine/sharded_index.py``) against the JAX package's
``archi_tpu/engine/sharded_index.py`` on the 8-device CPU mesh.

The port runs eight shards on ``["cpu"] * 8`` (a device may repeat: the
counterpart of the mesh's virtual CPU devices), with the same numpy rows.

- every case of ``tests/unit/test_sharded_index.py``: parity with the
  single-device index, brute force, delete and grow, a partial last shard,
  the filter mask, growth without a host round trip;
- against JAX ``ShardedFlatIndex`` on the same rows, rows tie-aware and
  scores within 1e-6: through growth, tombstones, filter masks (short and
  long), the shared and per-query ``[B, N]`` bias, a block across a seam,
  ties across shards and short shards with k past their rows;
- ``save`` writes FlatIndex's layout, which ``FlatIndex.load`` of both
  packages reads; a ``type: sharded`` checkpoint restarts as a
  single-device FlatIndex in both packages (mirrored, not changed);
- a search during ingest and growth reads a consistent snapshot.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from archi_tpu.engine.flat_index import FlatIndex as JFlat
from archi_tpu.engine.sharded_index import ShardedFlatIndex as JSharded
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex, sharded_search
from archi_tpu_torch.engine.topk import NEG_INF

CPU8 = ["cpu"] * 8
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _pair(d, tile=256, dtype="float32"):
    assert len(jax.devices()) == 8, jax.devices()
    return (ShardedFlatIndex(d, devices=CPU8, dtype=dtype, tile_n=tile),
            JSharded(d, dtype=np.float32 if dtype == "float32" else dtype,
                     tile_n=tile))


def assert_same(got, want, tol=TOL):
    """(ids, vals, rows): scores within tol position by position; a live
    row in one list only ties with the last live score kept; ids of the
    rows both return agree."""
    (gi, gv, gr), (wi, wv, wr) = got, want
    gv, wv = np.asarray(gv), np.asarray(wv)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    for b in range(gv.shape[0]):
        live = wv[b] > -1e29
        g = {int(r): v for r, v in zip(gr[b], gv[b]) if v > -1e29}
        w = {int(r): v for r, v in zip(wr[b], wv[b]) if v > -1e29}
        last = wv[b][live][-1] if live.any() else None
        for r in set(g) ^ set(w):
            assert abs(g.get(r, w.get(r)) - last) <= tol, (b, r)
        for i, r, v in zip(gi[b], gr[b], gv[b]):
            if v > -1e29 and int(r) in w:
                assert i == wi[b][list(map(int, wr[b])).index(int(r))]
            if v <= -1e29:
                assert i is None


# ------------------------------------------ tests/unit/test_sharded_index.py
def test_sharded_matches_single_device(rng):
    d, tile = 64, 256
    sharded = ShardedFlatIndex(d, devices=CPU8, dtype="float32", tile_n=tile)
    flat = FlatIndex(d, dtype="float32", tile_n=tile, device="cpu")
    emb = rng.standard_normal((5000, d)).astype(np.float32)
    ids = [f"c{i}" for i in range(5000)]
    sharded.add(emb, ids)
    flat.add(emb, ids)
    assert sharded.capacity % (8 * tile) == 0
    assert sharded.n_shards == 8 and sharded.shard_cap * 8 == sharded.capacity
    q = rng.standard_normal((4, d)).astype(np.float32)
    s_ids, s_vals, s_rows = sharded.search(q, k=10)
    f_ids, f_vals, f_rows = flat.search(q, k=10)
    np.testing.assert_allclose(s_vals, f_vals, rtol=0, atol=TOL)
    assert s_ids == f_ids and (s_rows == f_rows).all()


def test_sharded_matches_brute_force(rng):
    d = 32
    idx = ShardedFlatIndex(d, devices=CPU8, dtype="float32", tile_n=256)
    emb = rng.standard_normal((3000, d)).astype(np.float32)
    idx.add(emb, list(range(3000)))
    q = rng.standard_normal((2, d)).astype(np.float32)
    got_ids, vals, _ = idx.search(q, k=5)
    ref = _norm(q) @ _norm(emb).T
    top = np.argsort(-ref, axis=1)[:, :5]
    for b in range(2):
        assert got_ids[b] == list(top[b])
        np.testing.assert_allclose(vals[b], ref[b, top[b]], atol=1e-5)


def test_sharded_delete_and_grow(rng):
    d = 16
    idx = ShardedFlatIndex(d, devices=CPU8, dtype="float32", tile_n=256)
    emb = rng.standard_normal((1000, d)).astype(np.float32)
    idx.add(emb, [f"a{i}" for i in range(1000)])
    cap0 = idx.capacity
    idx.delete(["a7"])
    got, _, _ = idx.search(emb[7], k=1)
    assert got[0][0] != "a7"
    # grow across the sharded-unit boundary: rows move shard
    emb2 = rng.standard_normal((4000, d)).astype(np.float32)
    idx.add(emb2, [f"b{i}" for i in range(4000)])
    assert idx.capacity > cap0
    got2, _, _ = idx.search(emb2[1234], k=1)
    assert got2[0][0] == "b1234"
    got3, _, _ = idx.search(emb[7], k=1)        # the tombstone moved too
    assert got3[0][0] != "a7"
    got4, _, _ = idx.search(emb[999], k=1)
    assert got4[0][0] == "a999"


def test_sharded_partial_last_shard(rng):
    """n_rows smaller than one shard: other shards contribute only NEG_INF
    and the merge is still exact."""
    d = 16
    idx = ShardedFlatIndex(d, devices=CPU8, dtype="float32", tile_n=256)
    emb = rng.standard_normal((10, d)).astype(np.float32)
    idx.add(emb, list(range(10)))
    got, vals, _ = idx.search(emb[3], k=10)
    assert got[0][0] == 3
    assert all(g is not None for g in got[0])


def test_sharded_filter_mask(rng):
    d = 16
    idx = ShardedFlatIndex(d, devices=CPU8, dtype="float32", tile_n=256)
    emb = rng.standard_normal((100, d)).astype(np.float32)
    idx.add(emb, list(range(100)))
    mask = np.zeros(idx.capacity, np.float32)
    mask[40:60] = 1.0
    _, _, rows = idx.search(emb[5], k=5, filter_mask=mask)
    assert all(40 <= r < 60 for r in rows[0])


def test_growth_is_device_side(monkeypatch, rng):
    """Capacity growth moves rows between the shard tensors: nothing goes
    through host arrays during ``_grow_to``, every shard stays on its
    device, and the data is intact after the reshuffle."""
    idx = ShardedFlatIndex(16, devices=CPU8, tile_n=256, dtype="float32")
    base_cap = idx.capacity
    vecs = rng.standard_normal((base_cap, 16)).astype(np.float32)
    idx.add(vecs, list(range(base_cap)))

    def forbidden(*a, **kw):
        raise AssertionError("host round-trip during sharded growth")

    more = torch.from_numpy(rng.standard_normal((base_cap, 16)).astype(
        np.float32))
    monkeypatch.setattr(torch.Tensor, "numpy", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    idx.add(more, list(range(base_cap, 2 * base_cap)))
    monkeypatch.undo()
    assert idx.capacity >= 2 * base_cap
    assert [e.shape[0] for e in idx._embs] == [idx.capacity // 8] * 8
    assert all(e.device.type == "cpu" for e in idx._embs)
    ids, vals, _ = idx.search(vecs[3], k=1)
    assert ids[0][0] == 3 and vals[0][0] > 0.99
    ids2, _, _ = idx.search(more[7].numpy(), k=1)
    assert ids2[0][0] == base_cap + 7


# --------------------------------------------- against the JAX ShardedFlatIndex
def _fill_both(t, j, blocks):
    for x, ids in blocks:
        assert t.add(x, ids) == j.add(x, ids)
        assert t.capacity == j.capacity


@pytest.mark.parametrize("case", ["grow_tombstones", "seam_block",
                                  "short_shards"])
def test_matches_jax_through_growth_and_tombstones(case, rng):
    d = 32
    t, j = _pair(d)
    if case == "grow_tombstones":
        sizes = [700, 1500, 300, 4000]      # three capacity doublings
    elif case == "seam_block":
        sizes = [200, 300, 1000]            # blocks across shard seams
    else:
        sizes = [24]        # one short shard, seven empty; k past the rows
    blocks, n = [], 0
    for s in sizes:
        x = rng.standard_normal((s, d)).astype(np.float32)
        blocks.append((x, [f"r{n + i}" for i in range(s)]))
        n += s
    _fill_both(t, j, blocks)
    dead = [f"r{i}" for i in range(0, n, 37)]
    assert t.delete(dead) == j.delete(dead)
    x_all = np.concatenate([x for x, _ in blocks])
    q = np.concatenate([x_all[[1, n // 2, n - 1]],
                        rng.standard_normal((2, d)).astype(np.float32)])
    for k in (1, 10, 20, 60):
        assert_same(t.search(q, k=k), j.search(q, k=k))
    assert len(t) == len(j) and t.n_rows == j.n_rows


@pytest.mark.parametrize("bias_kind", ["shared", "per_query",
                                       "per_query_short"])
@pytest.mark.parametrize("mask_kind", [None, "long", "short"])
def test_bias_and_filter_match_jax(bias_kind, mask_kind, rng):
    d, n = 24, 2900
    t, j = _pair(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    _fill_both(t, j, [(x, list(range(n)))])
    t.delete([5, 2000]), j.delete([5, 2000])
    q = rng.standard_normal((4, d)).astype(np.float32)
    cap = t.capacity
    if bias_kind == "shared":
        bias = 0.2 * rng.random(cap).astype(np.float32)
        bias[[17, 1500]] = 5.0
    else:
        width = cap if bias_kind == "per_query" else n - 100
        bias = 0.2 * rng.random((4, width)).astype(np.float32)
        bias[np.arange(4), [10, 700, 1800, 2500]] = 5.0    # across shards
    mask = None
    if mask_kind is not None:
        mask = (rng.random(cap if mask_kind == "long" else n // 2)
                > 0.4).astype(np.float32)
    got = t.search(q, k=10, bias=bias, filter_mask=mask)
    want = j.search(q, k=10, bias=bias, filter_mask=mask)
    assert_same(got, want)
    if bias_kind != "shared" and mask is None:
        assert [int(r[0]) for r in got[2]] == [10, 700, 1800, 2500]


def test_ties_across_shards_rank_by_the_lower_row(rng):
    """The same row stored in several shards: equal scores come back lowest
    global row first, as ``lax.top_k`` over the shard-major merge does."""
    d = 16
    t, j = _pair(d)
    base = rng.standard_normal((2048, d)).astype(np.float32)
    dup = base[7].copy()
    for r in (300, 700, 1100, 1500, 1900, 40):     # shards 0..7 at cap 2048
        base[r] = dup
    _fill_both(t, j, [(base, list(range(2048)))])
    ids, vals, rows = t.search(dup, k=7)
    assert list(rows[0]) == [7, 40, 300, 700, 1100, 1500, 1900]
    assert np.ptp(vals[0]) == 0.0
    assert_same((ids, vals, rows), j.search(dup, k=7))


def test_sharded_search_function_merges_like_jax_sharded_search(rng):
    """The bare ``sharded_search`` over hand-cut shards equals JAX
    ``_sharded_search`` over the same mesh-sharded arrays."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from archi_tpu.engine.sharded_index import _sharded_search, default_mesh

    n, d, b, k, live = 2048, 16, 3, 12, 1500
    e = _norm(rng.standard_normal((n, d))).astype(np.float32)
    bias = np.zeros((n,), np.float32)
    bias[[3, 900]] = NEG_INF
    bias[1400] = 2.0
    q = _norm(rng.standard_normal((b, d))).astype(np.float32)
    mesh = default_mesh()
    jv, jr = _sharded_search(
        jax.device_put(q), jax.device_put(e, NamedSharding(mesh, P("data"))),
        jax.device_put(bias, NamedSharding(mesh, P("data"))),
        np.int32(live), mesh=mesh, axis="data", k=k, tile_n=256, impl="xla")
    sc = n // 8
    tv, tr = sharded_search(
        torch.from_numpy(q), [torch.from_numpy(e[s * sc:(s + 1) * sc])
                              for s in range(8)],
        [torch.from_numpy(bias[s * sc:(s + 1) * sc]) for s in range(8)],
        live, k=k)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    assert (tr.numpy() == np.asarray(jr)).all()


# ----------------------------------------------------- checkpoint and restart
def test_checkpoint_reads_as_flat_index_in_both_packages(rng, tmp_path):
    d = 16
    t, j = _pair(d)
    x = rng.standard_normal((3000, d)).astype(np.float32)
    _fill_both(t, j, [(x, [f"c{i}" for i in range(3000)])])
    t.delete(["c10"]), j.delete(["c10"])
    t.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    q = x[[11, 2999]]
    want_ids, want_vals, _ = j.search(q, k=5)
    for path in ("port.npz", "jax.npz"):
        tf = FlatIndex.load(str(tmp_path / path), device="cpu")
        jf = JFlat.load(str(tmp_path / path))
        assert len(tf) == len(jf) == 2999
        # load drops the tombstoned row, so rows renumber: compare by id
        got = tf.search(q, k=5)
        assert_same(got, jf.search(q, k=5))
        assert got[0] == want_ids
        np.testing.assert_allclose(got[1], want_vals, atol=TOL)


def _dm(tmp_path):
    return {"embedding_name": "hash", "embedding_kwargs": {"dim": 32},
            "data_path": str(tmp_path / "data"),
            "db_path": str(tmp_path / "catalog.db"),
            "index": {"type": "sharded", "dtype": "float32", "tile_n": 256}}


TEXTS = [f"chunk {i} about topic{i % 5} word{i}" for i in range(40)]


def test_sharded_restart_restores_a_flat_index_in_jax(tmp_path):
    """The JAX package restores a ``type: sharded`` checkpoint as a plain
    single-device FlatIndex (``index_cls`` stays None)."""
    from archi_tpu.bin.bootstrap import build_context

    dm = _dm(tmp_path)
    ctx = build_context(overrides={"data_manager": dm})
    assert isinstance(ctx.vectorstore.index, JSharded)
    ctx.vectorstore.add_texts(TEXTS)
    ctx.vectorstore.save(os.path.join(dm["data_path"], "engine_checkpoint"))
    again = build_context(overrides={"data_manager": dm}).vectorstore
    assert type(again.index) is JFlat and again.count() == 40


def test_sharded_restart_restores_a_flat_index_in_port(tmp_path):
    from archi_tpu_torch.bin.bootstrap import build_vectorstore

    dm = _dm(tmp_path)
    st = build_vectorstore(dm, devices=["cpu"] * 4)
    assert isinstance(st.index, ShardedFlatIndex) and st.index.n_shards == 4
    st.add_texts(TEXTS)
    want = st.hybrid_search("topic3 word13", k=4)
    st.save(os.path.join(dm["data_path"], "engine_checkpoint"))
    again = build_vectorstore(dm, devices=["cpu"] * 4)
    assert type(again.index) is FlatIndex and again.count() == 40
    got = again.hybrid_search("topic3 word13", k=4)
    assert [d.metadata["chunk_id"] for d, _ in got] == \
        [d.metadata["chunk_id"] for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-6)


# ----------------------------------------------------- concurrent ingest
def test_search_during_ingest_and_growth_sees_a_consistent_snapshot(rng):
    """Every row a concurrent search returns was fully written: rows are
    their own best match (score 1) while blocks that cross seams and force
    growth land."""
    d = 16
    idx = ShardedFlatIndex(d, devices=["cpu"] * 4, dtype="float32",
                           tile_n=128)
    x = _norm(rng.standard_normal((6000, d))).astype(np.float32)
    idx.add(x[:100], list(range(100)))
    stop, errors = threading.Event(), []

    def reader():
        while not stop.is_set():
            n = idx.n_rows
            ids, vals, rows = idx.search(x[n - 1], k=1)
            if ids[0][0] is not None and (ids[0][0] != rows[0][0]
                                          or vals[0][0] < 0.999):
                errors.append((n, ids, vals))

    th = threading.Thread(target=reader)
    th.start()
    try:
        for s0 in range(100, 6000, 700):
            idx.add(x[s0:s0 + 700], list(range(s0, min(s0 + 700, 6000))))
    finally:
        stop.set()
        th.join()
    assert not errors, errors[:2]
    assert idx.capacity >= 6000
    _, vals, rows = idx.search(x[[0, 2500, 5999]], k=1)
    assert list(rows[:, 0]) == [0, 2500, 5999]
