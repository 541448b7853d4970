"""The port's sharded IVF-PQ (``archi_tpu_torch/engine/sharded_ivfpq.py``)
against the JAX package's ``archi_tpu/engine/sharded_ivfpq.py``.

- every case of ``tests/unit/test_sharded_ivfpq.py`` (self recall, no loss
  of quality against one device, seam rows, the global bias sliced per
  shard), on ``["cpu"] * n``;
- JAX-built shards, saved and loaded by the port, searched by both with
  cell and block probing, a global bias with tombstones and boosts, and
  the exact host rerank: the same results, rows tie-aware at the
  tolerances of ``tests/test_torch_ivfpq.py`` (rtol 1e-4 / atol 1e-5);
- every shard is launched before any result is read (one fetch).
"""

import jax
import numpy as np
import pytest
import torch

from archi_tpu.engine import host_store as jhs
from archi_tpu.engine.ivfpq_index import IVFPQIndex as JIndex
from archi_tpu.engine.sharded_ivfpq import ShardedIVFPQIndex as JSharded
from archi_tpu_torch.engine import distributed
from archi_tpu_torch.engine import host_store as ths
from archi_tpu_torch.engine import sharded_ivfpq
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
from archi_tpu_torch.engine.sharded_ivfpq import ShardedIVFPQIndex
from archi_tpu_torch.engine.topk import NEG_INF
from tests.unit.test_ivf import _clustered_data, _norm

RTOL, ATOL = 1e-4, 1e-5


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


def _recall(rows, exact):
    return sum(len(set(int(r) for r in rows[b]) & set(exact[b]))
               for b in range(exact.shape[0])) / exact.size


def assert_same_topk(got, want):
    (gi, gv, gr), (wi, wv, wr) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    for b in range(gv.shape[0]):
        g = dict(zip(np.asarray(gr[b]).tolist(), gv[b].tolist()))
        w = dict(zip(np.asarray(wr[b]).tolist(), wv[b].tolist()))
        for r in set(g) ^ set(w):
            s = g.get(r, w.get(r))
            assert abs(s - wv[b, -1]) <= ATOL + RTOL * abs(s), (b, r)


# ------------------------------------------ tests/unit/test_sharded_ivfpq.py
def test_sharded_ivfpq_self_recall(rng):
    x = _clustered_data(rng, n_clusters=16, per=100, d=32)
    ids = [f"c{i}" for i in range(len(x))]
    idx = ShardedIVFPQIndex.build(x, ids, devices=_cpu(8), nlist=8,
                                  block=64, m=8, refine_m=8)
    assert len(idx.shards) == 8 and len(idx) == 1600
    q = x[123] + 0.01 * rng.standard_normal(32).astype(np.float32)
    got, vals, rows = idx.search(q, k=5, nprobe=8)
    assert int(rows[0][0]) == 123 and got[0][0] == "c123"


def test_sharded_matches_single_device_quality(rng):
    """Sharding must not cost recall (same corpus, same total probes)."""
    x = _clustered_data(rng, n_clusters=32, per=64, d=32)
    xn = _norm(x)
    queries = _norm(x[rng.choice(len(x), 16)] +
                    0.05 * rng.standard_normal((16, 32)).astype(np.float32))
    exact = np.argsort(-(queries @ xn.T), axis=1)[:, :10]
    sharded = ShardedIVFPQIndex.build(x, None, devices=_cpu(4), nlist=8,
                                      block=64, m=8, refine_m=8)
    single = IVFPQIndex.build(x, None, device="cpu", nlist=32, block=64, m=8,
                              refine_m=8)
    rs = _recall(sharded.search(queries, k=10, nprobe=8)[2], exact)
    r1 = _recall(single.search(queries, k=10, nprobe=32)[2], exact)
    assert rs >= r1 - 0.1
    assert rs >= 0.6


def test_shard_seam_rows_resolve_globally(rng):
    x = _clustered_data(rng, n_clusters=16, per=100, d=32)
    idx = ShardedIVFPQIndex.build(x, None, devices=_cpu(4), nlist=8,
                                  block=64, m=8, refine_m=8)
    shard_size = int(np.ceil(len(x) / 4))
    for probe_row in (shard_size - 1, shard_size, 2 * shard_size + 1):
        q = x[probe_row] + 0.005 * rng.standard_normal(32).astype(np.float32)
        _, _, rows = idx.search(q, k=3, nprobe=8)
        assert int(rows[0][0]) == probe_row


def test_global_bias_sliced_per_shard(rng):
    x = _clustered_data(rng, n_clusters=16, per=100, d=32)
    idx = ShardedIVFPQIndex.build(x, None, devices=_cpu(4), nlist=8,
                                  block=64, m=8, refine_m=8)
    q = x[700]  # owned by shard 1 (shard_size=400)
    _, _, base = idx.search(q, k=5, nprobe=8)
    kill = {int(r) for r in base[0]}
    bias = np.zeros(len(x), np.float32)
    for r in kill:
        bias[r] = NEG_INF
    _, vals, rows = idx.search(q, k=5, nprobe=8, bias=bias)
    assert not {int(r) for r in rows[0]} & kill
    assert (vals > NEG_INF / 2).all()
    # finite boost on a row in ANOTHER shard must surface it
    bias2 = np.zeros(len(x), np.float32)
    bias2[1500] = 10.0   # shard 3
    _, _, rows2 = idx.search(q, k=3, nprobe=8, bias=bias2)
    assert int(rows2[0][0]) == 1500


# ------------------------------------------------------ against the JAX class
@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """A JAX sharded IVF-PQ over 3 devices, each shard saved."""
    rng = np.random.default_rng(8)
    x = _clustered_data(rng, n_clusters=24, per=64, d=32)   # 1536 rows
    j = JSharded.build(x, [f"c{i}" for i in range(len(x))],
                       devices=jax.devices()[:3], nlist=8, block=64, m=8,
                       refine_m=8)
    root = tmp_path_factory.mktemp("sharded_ivfpq")
    paths = []
    for s, shard in enumerate(j.shards):
        paths.append(str(root / f"shard{s}.npz"))
        shard.save(paths[-1])
    q = _norm(x[rng.choice(len(x), 6)] +
              0.04 * rng.standard_normal((6, 32))).astype(np.float32)
    return x, q, j, paths


def _port(j, paths):
    return ShardedIVFPQIndex(
        [IVFPQIndex.load(p, device="cpu") for p in paths], list(j.offsets),
        j._ids)


@pytest.mark.parametrize("probe", [{"nprobe": 3}, {"nprobe": 8},
                                   {"nprobe_blocks": 6},
                                   {"nprobe_blocks": 6, "cell_gate": 2}],
                         ids=["cells3", "cells8", "blocks", "blocks_gate"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("rerank", [False, True], ids=["adc", "rerank"])
def test_jax_built_shards_search_alike(jax_built, probe, bias, rerank):
    x, q, j, paths = jax_built
    t = _port(j, paths)
    assert len(t) == len(j) == len(x)
    kw = dict(probe)
    if bias:
        b = np.zeros(len(x), np.float32)
        b[[3, 600, 1100]] = NEG_INF                   # tombstones
        b[[510, 1400]] = 0.5                          # boosts, shards 0, 2
        kw["bias"] = b
    jkw, tkw = dict(kw), dict(kw)
    if rerank:
        js, ts = jhs.HostVectorStore(32), ths.HostVectorStore(32)
        js.add(_norm(x)), ts.add(_norm(x))
        jkw["rerank_store"], tkw["rerank_store"] = js, ts
    got, want = t.search(q, k=10, **tkw), j.search(q, k=10, **jkw)
    assert_same_topk(got, want)
    assert got[0][0][0] == want[0][0][0]


def test_every_shard_launches_before_one_fetch(jax_built, monkeypatch):
    """The dispatch order of the reference: every shard's search_dispatch,
    then ONE fetch of all their results."""
    x, q, j, paths = jax_built
    t = _port(j, paths)
    calls = []
    for shard in t.shards:
        orig = shard.search_dispatch

        def spy(*a, _orig=orig, **kw):
            calls.append("dispatch")
            return _orig(*a, **kw)
        shard.search_dispatch = spy
    real_fetch = distributed.fetch

    def fetch(tensors):
        calls.append(f"fetch{len(tensors)}")
        return real_fetch(tensors)
    monkeypatch.setattr(sharded_ivfpq, "fetch", fetch)
    t.search(q, k=5, nprobe=4)
    assert calls == ["dispatch"] * 3 + ["fetch6"]
