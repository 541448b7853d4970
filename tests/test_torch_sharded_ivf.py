"""The port's sharded IVF (``archi_tpu_torch/engine/sharded_ivf.py``)
against the JAX package's ``archi_tpu/engine/sharded_ivf.py``.

- every case of ``tests/unit/test_sharded_ivf.py``, on ``["cpu"] * n``;
- JAX-built shards, saved and loaded by the port, searched by both: the
  same results, rows tie-aware (1e-4, the standard of
  ``tests/test_torch_ivf.py``), at a partial and at the full probe;
- at the full probe, the port's own build returns the JAX build's exact
  top-k.
"""

import jax
import numpy as np
import pytest
import torch

from archi_tpu.engine.sharded_ivf import ShardedIVFIndex as JSharded
from archi_tpu_torch.engine.ivf_index import IVFIndex
from archi_tpu_torch.engine.sharded_ivf import ShardedIVFIndex
from tests.unit.test_ivf import _clustered_data, _norm

RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(n):
    return ["cpu"] * n


def assert_same_topk(got, want):
    """(ids, vals, rows): scores within tolerance position by position; a
    row in one list only ties with the last score kept."""
    (_gi, gv, gr), (_wi, wv, wr) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    for b in range(gv.shape[0]):
        g = dict(zip(np.asarray(gr[b]).tolist(), gv[b].tolist()))
        w = dict(zip(np.asarray(wr[b]).tolist(), wv[b].tolist()))
        for r in set(g) ^ set(w):
            assert abs(g.get(r, w.get(r)) - wv[b, -1]) <= ATOL, (b, r)


# --------------------------------------------- tests/unit/test_sharded_ivf.py
def test_sharded_ivf_exact_at_full_probe(rng):
    x = _clustered_data(rng, n_clusters=16, per=100, d=32)
    ids = [f"c{i}" for i in range(len(x))]
    idx = ShardedIVFIndex.build(x, ids, devices=_cpu(8), nlist=8, block=64,
                                dtype=torch.float32)
    assert len(idx.shards) == 8
    q = x[123] + 0.01 * rng.standard_normal(32).astype(np.float32)
    got, vals, rows = idx.search(q, k=10, nprobe=8)
    ref = _norm(q[None]) @ x.T
    top = np.argsort(-ref[0])[:10]
    assert got[0] == [f"c{i}" for i in top]


def test_sharded_ivf_recall_modest_probe(rng):
    x = _clustered_data(rng, n_clusters=32, per=64, d=32)
    idx = ShardedIVFIndex.build(x, list(range(len(x))), devices=_cpu(4),
                                nlist=16, block=64, dtype=torch.float32)
    queries = _norm(x[rng.choice(len(x), 16)] +
                    0.05 * rng.standard_normal((16, 32))).astype(np.float32)
    ref_top = np.argsort(-(queries @ x.T), axis=1)[:, :10]
    got, vals, rows = idx.search(queries, k=10, nprobe=4)
    recall = np.mean([len(set(int(r) for r in rows[b]) & set(ref_top[b]))
                      / 10 for b in range(16)])
    assert recall >= 0.9, recall


def test_sharded_ivf_uneven_split(rng):
    """Row count not divisible by shard count."""
    x = _clustered_data(rng, n_clusters=4, per=33, d=16)  # 132 rows
    idx = ShardedIVFIndex.build(x, list(range(132)), devices=_cpu(5),
                                nlist=4, block=32, dtype=torch.float32)
    assert len(idx) == 132 and idx.offsets == [0, 27, 54, 81, 108]
    got, _, _ = idx.search(x[131], k=1, nprobe=4)
    assert got[0][0] == 131


def test_sharded_matches_single_device_ivf(rng):
    x = _clustered_data(rng, n_clusters=16, per=64, d=32)
    ids = list(range(len(x)))
    sharded = ShardedIVFIndex.build(x, ids, devices=_cpu(8), nlist=8,
                                    block=64, dtype=torch.float32)
    single = IVFIndex.build(x, ids, nlist=8, block=64, dtype=torch.float32,
                            device="cpu")
    queries = _norm(x[rng.choice(len(x), 8)] +
                    0.02 * rng.standard_normal((8, 32))).astype(np.float32)
    ref = queries @ x.T
    gs, vs, rs = sharded.search(queries, k=10, nprobe=8)
    g1, v1, r1 = single.search(queries, k=10, nprobe=8)
    for b in range(8):
        ref_top = set(np.argsort(-ref[b])[:10].tolist())
        assert set(int(r) for r in rs[b]) == ref_top
        assert set(int(r) for r in r1[b]) == ref_top
        np.testing.assert_allclose(np.sort(vs[b]), np.sort(v1[b]),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_global_ids_at_shard_seams(rng):
    n, d = 320, 16
    x = _norm(rng.standard_normal((n, d))).astype(np.float32)
    idx = ShardedIVFIndex.build(x, list(range(n)), devices=_cpu(4), nlist=4,
                                block=32, dtype=torch.float32)
    shard_size = int(np.ceil(n / 4))
    for s in range(1, 4):
        for row in (s * shard_size - 1, s * shard_size):
            got, vals, rows = idx.search(x[row], k=1, nprobe=4)
            assert int(rows[0][0]) == row, (s, row, rows)


def test_build_device_matches_host_build(rng):
    x = _clustered_data(rng, n_clusters=8, per=80, d=32)
    host = IVFIndex.build(x, None, nlist=8, block=64, iters=5, seed=3,
                          dtype=torch.float32, device="cpu")
    dev = IVFIndex.build_device(torch.from_numpy(x), nlist=8, block=64,
                                iters=5, seed=3, dtype=torch.float32)
    assert len(dev) == len(x)
    queries = _norm(x[rng.choice(len(x), 8)] +
                    0.02 * rng.standard_normal((8, 32))).astype(np.float32)
    _g1, v1, r1 = host.search(queries, k=10, nprobe=8)
    _g2, v2, r2 = dev.search(queries, k=10, nprobe=8)
    for b in range(8):
        assert set(int(r) for r in r1[b]) == set(int(r) for r in r2[b])
        np.testing.assert_allclose(np.sort(v1[b]), np.sort(v2[b]),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ against the JAX class
@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """A JAX sharded IVF over 6 devices (uneven split), each shard saved."""
    rng = np.random.default_rng(3)
    x = _clustered_data(rng, n_clusters=24, per=50, d=32)
    ids = [f"c{i}" for i in range(len(x))]
    j = JSharded.build(x, ids, devices=jax.devices()[:6], nlist=8, block=64,
                       dtype=np.float32)
    root = tmp_path_factory.mktemp("sharded_ivf")
    paths = []
    for s, shard in enumerate(j.shards):
        paths.append(str(root / f"shard{s}.npz"))
        shard.save(paths[-1])
    q = _norm(x[rng.choice(len(x), 8)] +
              0.03 * rng.standard_normal((8, 32))).astype(np.float32)
    return x, ids, q, j, paths


@pytest.mark.parametrize("nprobe", [2, 8])
def test_jax_built_shards_search_alike(jax_built, nprobe):
    x, ids, q, j, paths = jax_built
    t = ShardedIVFIndex(
        [IVFIndex.load(p, dtype=torch.float32, device="cpu") for p in paths],
        list(j.offsets), ids)
    assert len(t) == len(j)
    got, want = t.search(q, k=10, nprobe=nprobe), j.search(q, k=10,
                                                           nprobe=nprobe)
    assert_same_topk(got, want)
    assert got[0][0] == want[0][0]


def test_port_build_equals_jax_build_at_full_probe(jax_built):
    x, ids, q, j, _paths = jax_built
    t = ShardedIVFIndex.build(x, ids, devices=_cpu(6), nlist=8, block=64,
                              dtype=torch.float32)
    assert t.offsets == list(j.offsets)
    assert_same_topk(t.search(q, k=10, nprobe=8), j.search(q, k=10,
                                                           nprobe=8))
