"""The port's sharded XL tier (``archi_tpu_torch/engine/sharded_xl.py``)
against the JAX package's ``archi_tpu/engine/sharded_xl.py``.

- every case of ``tests/unit/test_sharded_xl.py``, on ``["cpu"] * 8``:
  balance and snapshots, recall and exact scores against brute force over
  the bf16 rows, cross-shard tombstones, the shared and per-query global
  bias, the filter mask by global row, k past the rows of a shard, growth
  into the tails then a re-adopt, save/load, ``adopt_stores`` over
  ``HostVectorStore.view`` windows;
- checkpoints cross both packages (either saves, the other loads) and the
  two serve the same results, tie-aware at 1e-4 (the standard of
  ``tests/test_torch_xl_index.py``);
- ``HostVectorStore.view`` refuses appends, as the JAX package's does;
- ``profile=`` reports the three phases and the fetched bytes.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from archi_tpu.engine import host_store as jhs
from archi_tpu.engine.sharded_xl import ShardedXlPQIndex as JSharded
from archi_tpu_torch.engine.host_store import BF16, HostVectorStore
from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex

DIM = 32
RTOL, ATOL = 1e-4, 1e-4
CPU8 = ["cpu"] * 8
CFG = dict(nlist=16, block=32, pq_m=8, pq_refine_m=8, nprobe_blocks=10 ** 6,
           rerank_overfetch=16, min_snapshot_rows=256, build_block_rows=256,
           tile_n=128, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_index(cls=ShardedXlPQIndex, **kw):
    cfg = dict(CFG)
    cfg.update(kw)
    if cls is ShardedXlPQIndex:
        cfg.setdefault("devices", CPU8)
    return cls(DIM, **cfg)


def corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def brute_rows(v, q, k, alive=None, bias=None):
    # the host plane stores bf16 rows; ground truth sees the same bits
    vb = v.astype(ml_dtypes.bfloat16).astype(np.float32)
    s = q @ vb.T
    if bias is not None:
        s = s + bias
    if alive is not None:
        s = np.where(alive[None, :] > 0, s, -np.inf)
    return np.argsort(-s, axis=1)[:, :k]


def assert_same_topk(got, want):
    """(ids, vals, rows): scores within tolerance position by position; a
    row in one list only ties with the last score kept; ids agree."""
    (gi, gv, gr), (wi, wv, wr) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    for b in range(gv.shape[0]):
        g = dict(zip(np.asarray(gr[b]).tolist(), gv[b].tolist()))
        w = dict(zip(np.asarray(wr[b]).tolist(), wv[b].tolist()))
        for r in set(g) ^ set(w):
            assert abs(g.get(r, w.get(r)) - wv[b, -1]) <= ATOL, (b, r)
        for i, r in zip(gi[b], np.asarray(gr[b]).tolist()):
            if r in w and r >= 0:
                assert i == wi[b][list(np.asarray(wr[b])).index(r)]


@pytest.fixture(scope="module")
def built():
    """2,000 rows in 8 batches: crosses min_snapshot_rows on every shard
    (8 shards x 250) so snapshots build and fresh tails stay non-empty."""
    v = corpus(2000)
    idx = make_index(min_snapshot_rows=128, build_block_rows=128)
    for i in range(8):
        idx.add(v[i * 250:(i + 1) * 250],
                ids=list(range(i * 250, (i + 1) * 250)))
    return idx, v


# -------------------------------------------- tests/unit/test_sharded_xl.py
def test_shards_balanced_and_snapshots_built(built):
    idx, _ = built
    assert idx.n_shards == 8 and len(idx) == 2000
    sizes = [s.n_rows for s in idx.shards]
    assert max(sizes) - min(sizes) <= 250, sizes
    assert [s._n_snap for s in idx.shards if s._n_snap > 0]
    assert any(s.n_rows > s._n_snap for s in idx.shards)
    assert all(s.device == torch.device("cpu") for s in idx.shards)


def test_exact_recall_vs_brute_force(built):
    idx, v = built
    q = corpus(16, seed=9)
    ids, vals, rows = idx.search(q, k=10)
    exact = brute_rows(v, q, 10)
    rec = np.mean([len(set(map(int, rows[b])) & set(map(int, exact[b])))
                   for b in range(16)]) / 10
    assert rec >= 0.99, rec
    assert ids[0][0] == int(rows[0][0])
    vb = v.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = float(q[0] @ vb[int(rows[0][0])])
    assert abs(float(vals[0][0]) - want) < 5e-3


def test_self_query_top1(built):
    idx, v = built
    ids, _, _ = idx.search(v[123:124] + 1e-3, k=1)
    assert ids[0][0] == 123


def test_cross_shard_tombstones():
    v = corpus(2000)
    idx = make_index(min_snapshot_rows=128, build_block_rows=128)
    for i in range(8):
        idx.add(v[i * 250:(i + 1) * 250],
                ids=list(range(i * 250, (i + 1) * 250)))
    q = v[777:778]
    ids, _, _ = idx.search(q, k=1)
    assert ids[0][0] == 777
    assert idx.delete([777]) == 1
    ids, _, rows = idx.search(q, k=5)
    assert 777 not in set(map(int, rows[0]))
    assert 777 not in {i for i in ids[0] if i is not None}
    alive = np.ones(2000)
    alive[777] = 0
    exact = brute_rows(v, q, 5, alive=alive)
    assert set(map(int, rows[0])) & set(map(int, exact[0]))
    assert idx.alive.shape == (2000,) and float(idx.alive[777]) == 0.0


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_global_bias_shared_and_batched(built, as_tensor):
    idx, v = built
    q = corpus(4, seed=3)
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    bias = np.zeros(2000, np.float32)
    bias[1500] = 10.0
    _, _, rows = idx.search(q, k=3, bias=wrap(bias))
    assert all(int(r[0]) == 1500 for r in rows)
    bb = np.zeros((4, 2000), np.float32)
    targets = [10, 600, 1100, 1900]   # spread across shards
    for b, t in enumerate(targets):
        bb[b, t] = 10.0
    _, _, rows = idx.search(q, k=3, bias=wrap(bb))
    assert [int(r[0]) for r in rows] == targets


def test_filter_mask_by_global_row(built):
    idx, v = built
    q = v[42:43]
    fm = np.zeros(2000, np.float32)
    fm[100:200] = 1.0
    _, vals, rows = idx.search(q, k=5, filter_mask=fm)
    got = [int(r) for r, val in zip(rows[0], vals[0]) if val > -1e29]
    assert got and all(100 <= r < 200 for r in got)
    exact = brute_rows(v, q, 5, alive=fm)
    assert got[0] == int(exact[0][0])
    # a short mask excludes the rows past its length
    _, vals, rows = idx.search(v[1500:1501], k=5, filter_mask=fm[:150])
    got = [int(r) for r, val in zip(rows[0], vals[0]) if val > -1e29]
    assert got and all(100 <= r < 150 for r in got)


def test_k_larger_than_per_shard_rows():
    v = corpus(24, seed=5)
    idx = make_index(min_snapshot_rows=10 ** 9)   # tails only
    idx.add(v[:12], ids=list(range(12)))
    idx.add(v[12:], ids=list(range(12, 24)))
    q = corpus(2, seed=6)
    ids, vals, rows = idx.search(q, k=20)
    live = [int(r) for r, val in zip(rows[0], vals[0]) if val > -1e29]
    assert len(live) == 20
    exact = brute_rows(v, q, 20)
    assert set(live) == set(map(int, exact[0]))
    ids, vals, _ = idx.search(q, k=30)
    assert sum(1 for val in vals[0] if val > -1e29) == 24
    assert ids[0][-1] is None


def test_growth_after_snapshot_lands_in_tail_then_adopts():
    v = corpus(2000)
    idx = make_index(min_snapshot_rows=128, build_block_rows=128)
    for i in range(8):
        idx.add(v[i * 250:(i + 1) * 250],
                ids=list(range(i * 250, (i + 1) * 250)))
    extra = corpus(64, seed=11)
    g = idx.add(extra, ids=[f"x{i}" for i in range(64)])
    assert g == list(range(2000, 2064))
    ids, _, _ = idx.search(extra[7:8], k=1)
    assert ids[0][0] == "x7"
    snaps_before = [s._n_snap for s in idx.shards]
    idx.refresh_snapshots()
    assert sum(s._n_snap for s in idx.shards) >= sum(snaps_before)
    ids, _, _ = idx.search(extra[7:8], k=1)
    assert ids[0][0] == "x7"


def test_save_load_roundtrip(tmp_path):
    v = corpus(600, seed=20)
    idx = make_index(min_snapshot_rows=128, build_block_rows=128)
    for i in range(3):
        idx.add(v[i * 200:(i + 1) * 200],
                ids=list(range(i * 200, (i + 1) * 200)))
    idx.delete([5])
    p = str(tmp_path / "sx")
    idx.save(p)
    idx2 = ShardedXlPQIndex.load(p, devices=CPU8)
    q = v[300:302]
    ids1, v1, r1 = idx.search(q, k=5)
    ids2, v2, r2 = idx2.search(q, k=5)
    assert set(ids1[0]) == set(ids2[0]) and set(ids1[1]) == set(ids2[1])
    np.testing.assert_allclose(np.sort(v1), np.sort(v2), atol=2e-3)
    _, _, rows = idx2.search(v[5:6], k=3)
    assert 5 not in set(map(int, rows[0]))
    with pytest.raises(ValueError, match="8 shards; 4 devices"):
        ShardedXlPQIndex.load(p, devices=["cpu"] * 4)


def test_adopt_stores_from_plane_views():
    """Bulk load: one corpus plane sliced into zero-copy per-shard views,
    adopted without add(); global rows are the plane's rows."""
    n, n_shards = 2048, 4
    v = corpus(n, seed=9)
    parent = HostVectorStore(DIM, dtype=BF16)
    parent.add(v)
    per = n // n_shards
    views = [HostVectorStore.view(parent, s * per, (s + 1) * per)
             for s in range(n_shards)]
    assert all(np.shares_memory(w._buf, parent._buf) for w in views)
    idx = make_index(devices=["cpu"] * n_shards, stores=views,
                     normalize=False)
    idx.adopt_stores([[f"c{s * per + j}" for j in range(per)]
                      for s in range(n_shards)])
    assert len(idx) == n
    assert all(ix._n_snap == per for ix in idx.shards)
    rng = np.random.default_rng(10)
    qi = rng.integers(0, n, 8)
    q = v[qi] + 0.02 * rng.standard_normal((8, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids, vals, rows = idx.search(q, k=5)
    ref = brute_rows(v, q, 5)
    hit = np.mean([len({f"c{r}" for r in ref[b]} & set(ids[b])) / 5
                   for b in range(8)])
    assert hit >= 0.9, hit
    assert all(ids[b][0] == f"c{int(rows[b][0])}" for b in range(8))
    assert all(int(rows[b][0]) == int(qi[b]) for b in range(8))
    # the adopted tier serves the same results as one filled by add()
    filled = make_index(devices=["cpu"] * n_shards, normalize=False,
                        min_snapshot_rows=per, build_block_rows=per)
    for s in range(n_shards):
        filled.add(v[s * per:(s + 1) * per],
                   [f"c{s * per + j}" for j in range(per)])
    assert [s.n_rows for s in filled.shards] == [per] * n_shards
    assert_same_topk(filled.search(q, k=5), (ids, vals, rows))


# ------------------------------------------------------ HostVectorStore.view
@pytest.mark.parametrize("dtype", [BF16, np.float16])
def test_view_is_a_read_only_window_like_jax(dtype):
    v = corpus(300, seed=2)
    t = HostVectorStore(DIM, dtype=dtype)
    j = jhs.HostVectorStore(
        DIM, dtype=ml_dtypes.bfloat16 if dtype == BF16 else dtype)
    t.add(v), j.add(v)
    tv = HostVectorStore.view(t, 100, 250)
    jv = jhs.HostVectorStore.view(j, 100, 250)
    assert len(tv) == len(jv) == 150
    rows = [0, 7, 149, -1]
    np.testing.assert_array_equal(tv.get(rows), jv.get(rows))
    np.testing.assert_array_equal(tv.get([3]), t.get([103]))
    with pytest.raises(RuntimeError, match="read-only"):
        tv.add(v[:2])
    with pytest.raises(AssertionError):
        HostVectorStore.view(t, 10, 301)


# ----------------------------------------------------- across the packages
@pytest.fixture(scope="module")
def data():
    v = corpus(1600, seed=31)
    fresh = corpus(40, seed=32)
    q = np.concatenate([v[[3, 800, 1599]], fresh[[5]], corpus(4, seed=33)])
    q = q + 0.01 * np.random.default_rng(4).standard_normal(q.shape)
    return v, fresh, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
        np.float32)


def _fill(idx, v, fresh):
    for i in range(4):
        idx.add(v[i * 400:(i + 1) * 400], [f"c{j}" for j in
                                           range(i * 400, (i + 1) * 400)])
    idx.add(fresh, [f"f{j}" for j in range(len(fresh))])
    idx.delete(["c3", "c1000", "f2"])
    return idx


def _searches(idx, q, n):
    rng = np.random.default_rng(5)
    bias = (0.1 * rng.random(n)).astype(np.float32)
    bias[[10, 1200]] = 3.0
    bb = (0.1 * rng.random((len(q), n - 30))).astype(np.float32)
    fm = (rng.random(n) > 0.3).astype(np.float32)
    return [idx.search(q, k=10), idx.search(q, k=10, bias=bias),
            idx.search(q, k=10, bias=bb), idx.search(q, k=10, filter_mask=fm),
            idx.search(q, k=10, filter_mask=fm[:900], bias=bias)]


@pytest.fixture(scope="module")
def saved(data, tmp_path_factory):
    """The same rows, adds and deletes through both packages' 4-shard
    tiers, each saved; → (rows in use, {package: checkpoint path})."""
    v, fresh, _q = data
    root = tmp_path_factory.mktemp("sharded_xl")
    kw = dict(min_snapshot_rows=256, build_block_rows=128)
    paths = {}
    for name, idx in (
            # one repeated JAX device: its compiles are shared by the shards
            ("jax", make_index(JSharded, devices=[jax.devices()[0]] * 4,
                               **kw)),
            ("port", make_index(devices=["cpu"] * 4, **kw))):
        _fill(idx, v, fresh)
        assert [s._n_snap for s in idx.shards] == [384] * 4
        paths[name] = str(root / name)
        idx.save(paths[name])
    return idx.n_rows, paths


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(data, saved, writer):
    """A checkpoint either package wrote loads in both, and the two loads
    serve the same results (the reload re-uploads the tails from the bf16
    plane, so both sides read the same rows)."""
    _v, _fresh, q = data
    n, paths = saved
    port = ShardedXlPQIndex.load(paths[writer], devices=["cpu"] * 4)
    ref = JSharded.load(paths[writer], devices=[jax.devices()[0]] * 4)
    assert port.n_shards == ref.n_shards == 4 and len(port) == len(ref)
    assert port.n_rows == n
    assert [s._n_snap for s in port.shards] == [s._n_snap for s in
                                                ref.shards]
    for got, want in zip(_searches(port, q, n), _searches(ref, q, n)):
        assert_same_topk(got, want)


def test_profile_reports_the_phases(built):
    idx, _ = built
    prof = {}
    idx.search(corpus(32, seed=1), k=10, profile=prof)
    assert set(prof) == {"dispatch_s", "fetch_s", "rerank_s", "merge_s",
                         "fetch_bytes"}
    assert prof["fetch_bytes"] > 0 and all(
        prof[key] >= 0 for key in prof)
