"""The port's XL serving index (``archi_tpu_torch/engine/xl_index.py``)
against the JAX package's ``archi_tpu/engine/xl_index.py``.

- Checkpoints cross both ways: an index built and saved by one package
  (the plane embedded, or as its memmap file) loads in the other, and both
  serve the same results — plain, shared and per-query bias on every tier,
  filter, deletes, fresh rows — tie-aware at 1e-4.
- The bf16 host plane held as bits equals ``ml_dtypes`` rounding bit for
  bit (random rows, ties to even, subnormals, inf), in memory and as a
  plane file read by the other package.
- ``snapshot_source`` is bounded by its coverage at injection (a departure
  from the reference, which consults it for every whole block).
- A restart from an XL checkpoint builds a fresh store in both packages
  (``FlatIndex.load`` cannot read XL meta): mirrored, not changed.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from archi_tpu.engine import host_store as jhs
from archi_tpu.engine.xl_index import XlPQIndex as JXl
from archi_tpu_torch.engine import host_store as ths
from archi_tpu_torch.engine.topk import NEG_INF
from archi_tpu_torch.engine.xl_index import XlPQIndex, plane_rows

D = 32
RTOL, ATOL = 1e-4, 1e-4
CFG = dict(nlist=16, block=128, pq_m=8, pq_refine_m=8, nprobe_blocks=12,
           rerank_overfetch=8, min_snapshot_rows=2048, build_block_rows=1024,
           tile_n=256)


def _corpus(rng, n, clusters=48, noise=0.12):
    centers = rng.standard_normal((clusters, D)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + \
        noise * rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_topk(got, want):
    """(ids, vals, rows): scores within tolerance position by position; a
    row in one list only must tie with the last score kept."""
    (gi, gv, gr), (wi, wv, wr) = got, want
    gv, wv = np.asarray(gv), np.asarray(wv)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    for b in range(gv.shape[0]):
        g = dict(zip(np.asarray(gr[b]).tolist(), gv[b].tolist()))
        w = dict(zip(np.asarray(wr[b]).tolist(), wv[b].tolist()))
        for r in set(g) ^ set(w):
            assert abs(g.get(r, w.get(r)) - wv[b, -1]) <= ATOL, (b, r)
        same = [(i, r) for i, r in zip(gi[b], np.asarray(gr[b]).tolist())
                if r in w]
        assert all(i == wi[b][list(np.asarray(wr[b])).index(r)]
                   for i, r in same)


def _fill(idx, x, fresh):
    """Snapshot over x (built on the add that crosses min_snapshot_rows),
    fresh rows in the tail, deletes in both tiers."""
    idx.add(x, [f"c{i}" for i in range(len(x))])
    idx.add(fresh, [f"f{i}" for i in range(len(fresh))])
    idx.delete(["c3", "c2000", "f5"])
    return idx


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = _corpus(rng, 4096)
    fresh = _corpus(np.random.default_rng(77), 300)
    q = x[rng.integers(0, 4096, 6)] + 0.02 * rng.standard_normal(
        (6, D)).astype(np.float32)
    q = np.concatenate([q, fresh[[7, 100]]])
    return x, fresh, (q / np.linalg.norm(q, axis=1, keepdims=True)) \
        .astype(np.float32)


def _searches(idx, q, n_rows):
    rng = np.random.default_rng(5)
    shared = np.where(rng.random(n_rows) < 0.1, NEG_INF,
                      0.2 * rng.random(n_rows)).astype(np.float32)
    per_q = (shared[None, :] + 0.3 * rng.random((len(q), n_rows))) \
        .astype(np.float32)
    fm = (rng.random(n_rows) < 0.7).astype(np.float32)
    return [idx.search(q, k=10),
            idx.search(q[0], k=5),
            idx.search(q, k=10, bias=shared),
            idx.search(q, k=10, bias=per_q),
            idx.search(q, k=10, filter_mask=fm),
            idx.search(q, k=10, filter_mask=fm[:3000], bias=per_q)]


@pytest.mark.parametrize("plane", ["embedded", "memmap"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(data, tmp_path, direction, plane):
    x, fresh, q = data
    kw = dict(CFG)
    if plane == "memmap":
        kw["store_path"] = str(tmp_path / "plane.bin")
    if direction == "jax_to_port":
        src = _fill(JXl(D, **kw), x, fresh)
    else:
        src = _fill(XlPQIndex(D, device="cpu", **kw), x, fresh)
    assert src._n_snap == 4096 and src.n_rows == 4396 and len(src) == 4393
    path = str(tmp_path / "xl" / "index.npz")
    os.makedirs(os.path.dirname(path))
    src.save(path)
    if direction == "jax_to_port":
        dst = XlPQIndex.load(path, device="cpu")
        port, jax_ = dst, src
    else:
        dst = JXl.load(path)
        port, jax_ = src, dst
    assert dst._n_snap == 4096 and dst.n_rows == 4396 and len(dst) == 4393
    assert dst.store.path == kw.get("store_path")
    assert dst.nprobe_blocks == 12 and dst.rerank_overfetch == 8
    np.testing.assert_array_equal(
        np.asarray(port.store._buf[:4396]),
        np.asarray(jax_.store._buf[:4396]).view(np.uint16))
    for got, want in zip(_searches(port, q, 4396), _searches(jax_, q, 4396)):
        assert_same_topk(got, want)
    # the liveness view the lexical-only ranking reads
    np.testing.assert_array_equal(port.alive.numpy(), np.asarray(jax_.alive))
    # fresh rows found at rank 1 through the exact tail, deletes stay dead
    ids, vals, _rows = port.search(q[-2:], k=3)
    assert [i[0] for i in ids] == ["f7", "f100"] and (vals[:, 0] > 0.99).all()
    for r in port.search(x[[3, 2000]], k=5)[0] + \
            port.search(fresh[[5]], k=5)[0]:
        assert not {"c3", "c2000", "f5"} & set(r)


def test_per_query_bias_reaches_every_tier(data):
    """A [B, N] boost surfaces a probed snapshot row for one query and a
    tail row for another, in both packages alike; a per-query NEG_INF kills
    only its own query's row."""
    x, fresh, q = data
    t = _fill(XlPQIndex(D, device="cpu", **CFG), x, fresh)
    j = _fill(JXl(D, **CFG), x, fresh)
    qq = q[:2]
    base = t.search(qq, k=20)[2]
    t0 = int(next(r for r in base[0][::-1] if 0 <= r < t._n_snap))
    t1 = t.n_rows - 3                                  # the exact tail
    bias = np.zeros((2, t.n_rows), np.float32)
    bias[0, t0] = 5.0
    bias[1, t1] = 5.0
    got, want = t.search(qq, k=3, bias=bias), j.search(qq, k=3, bias=bias)
    assert_same_topk(got, want)
    assert int(got[2][0][0]) == t0 and int(got[2][1][0]) == t1
    true0 = float(ths.bf16_bits_to_f32(t.store._buf[t0]) @ qq[0])
    assert abs(got[1][0][0] - (true0 + 5.0)) < 1e-4   # exact ip + bias
    kill = np.zeros((2, t.n_rows), np.float32)
    kill[0, int(base[0][0])] = NEG_INF
    got, want = t.search(qq, k=3, bias=kill), j.search(qq, k=3, bias=kill)
    assert_same_topk(got, want)
    assert int(got[2][0][0]) != int(base[0][0])
    assert int(got[2][1][0]) == int(base[1][0])


# ------------------------------------------------------------ the bf16 plane
def _edge_values():
    tiny = np.finfo(np.float32).tiny
    return np.array([
        1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8),   # ties to even
        1.0 + 2 ** -8 + 2 ** -20, 1.00390625, 0.0, -0.0,
        tiny / 3, -tiny / 7, 1e-45, tiny, tiny * (1 - 2 ** -9),  # subnormal
        np.inf, -np.inf, 3.4e38, -3.4e38, 65504.0, 2.0 ** -130],
        np.float32)


def test_bf16_plane_bits_match_ml_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((64, 18)) * 10.0 ** rng.integers(
        -40, 38, (64, 18))).astype(np.float32)
    rows[0] = _edge_values()
    with np.errstate(over="ignore"):
        want = rows.astype(ml_dtypes.bfloat16)
    assert np.array_equal(ths.f32_to_bf16_bits(rows), want.view(np.uint16))
    store = ths.HostVectorStore(18, dtype=ths.BF16)
    store.add(rows)
    assert store.bf16 and store.dtype == np.uint16
    np.testing.assert_array_equal(store._buf[:64], want.view(np.uint16))
    got = store.get(np.arange(64))
    assert np.array_equal(got.view(np.uint32),
                          want.astype(np.float32).view(np.uint32))
    # plane files cross both ways bit for bit
    p_t, p_j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    ths.HostVectorStore(18, path=p_t, dtype=ths.BF16).add(rows)
    jhs.HostVectorStore(18, path=p_j, dtype=ml_dtypes.bfloat16).add(rows)
    from_t = jhs.HostVectorStore(18, path=p_t, dtype=ml_dtypes.bfloat16)
    from_j = ths.HostVectorStore(18, path=p_j, dtype=ths.BF16)
    assert len(from_t) == len(from_j) == 64
    assert np.array_equal(np.asarray(from_t._buf[:64]).view(np.uint16),
                          want.view(np.uint16))
    assert np.array_equal(np.asarray(from_j._buf[:64]), want.view(np.uint16))
    assert np.array_equal(from_j.get(np.arange(64)).view(np.uint32),
                          from_t.get(np.arange(64)).view(np.uint32))
    # the device upload of plane rows is the same upcast
    np.testing.assert_array_equal(plane_rows(from_j, 0, 64, "cpu").numpy(),
                                  got)


# ---------------------------------------------------------- snapshot_source
def test_snapshot_source_is_bounded_by_its_coverage():
    """Whole-block growth past the provider's coverage builds from the
    plane, and the snapshot equals one built without a provider.  The JAX
    package asks the provider for the new block too (the departure)."""
    rng = np.random.default_rng(23)
    x = _corpus(rng, 5120)
    x_bits = ths.bf16_bits_to_f32(ths.f32_to_bf16_bits(x))   # plane values
    kw = dict(CFG, normalize=False)
    calls, jcalls = [], []

    def source(i):
        calls.append(i)
        if i >= 4:   # past the coverage: never the plane's rows
            return torch.zeros((1024, D))
        return torch.from_numpy(x_bits[i * 1024:(i + 1) * 1024])

    def jax_source(i):
        jcalls.append(i)
        return jnp.asarray(x_bits[i * 1024:(i + 1) * 1024])

    built = []
    for src in (source, None):
        store = ths.HostVectorStore(D, dtype=ths.BF16)
        store.add(x[:4096])
        idx = XlPQIndex(D, store=store, snapshot_source=src, device="cpu",
                        **kw)
        assert idx._source_blocks == (4 if src else 0)
        idx.adopt_store([f"c{i}" for i in range(4096)])
        idx.add(x[4096:], [f"c{i}" for i in range(4096, 5120)])
        assert idx._n_snap == 5120     # the whole new block refreshed in
        built.append(idx)
    assert sorted(set(calls)) == [0, 1, 2, 3]
    a, b = built
    assert torch.equal(a._ivf.code_blocks, b._ivf.code_blocks)
    assert torch.equal(a._ivf.centroids, b._ivf.centroids)
    q = x[rng.integers(0, 5120, 8)]
    ra, rb = a.search(q, k=5), b.search(q, k=5)
    assert ra[0] == rb[0]
    np.testing.assert_array_equal(ra[1], rb[1])

    jstore = jhs.HostVectorStore(D, dtype=ml_dtypes.bfloat16)
    jstore.add(x[:4096])
    jidx = JXl(D, store=jstore, snapshot_source=jax_source, **kw)
    jidx.adopt_store([f"c{i}" for i in range(4096)])
    jcalls.clear()
    jidx.add(x[4096:], [f"c{i}" for i in range(4096, 5120)])
    assert 4 in jcalls       # the reference consults it past its coverage


# -------------------------------------------------------------- the restart
def _xl_dm_cfg(tmp_path, sub):
    return {"embedding_name": "hash", "embedding_kwargs": {"dim": D},
            "data_path": str(tmp_path / sub / "data"),
            "db_path": str(tmp_path / sub / "catalog.db"),
            "index": {"type": "ivfpq_xl", **CFG}}


def _xl_checkpoint(store, dm_cfg):
    texts = [f"chunk {i} about topic{i % 9} words w{i}" for i in range(40)]
    store.add_texts(texts, ids=[f"d{i}" for i in range(40)])
    store.save(os.path.join(dm_cfg["data_path"], "engine_checkpoint"))


def test_xl_restart_builds_afresh_in_jax(tmp_path):
    from archi_tpu.bin.bootstrap import _build_index, build_context
    from archi_tpu.engine.vectorstore import TpuVectorStore
    from archi_tpu.models.registry import HashEmbeddings

    dm = _xl_dm_cfg(tmp_path, "jax")
    _xl_checkpoint(TpuVectorStore(HashEmbeddings(D),
                                  index=_build_index(D, dm["index"])), dm)
    ctx = build_context(overrides={"data_manager": dm})
    assert isinstance(ctx.vectorstore.index, JXl)
    assert ctx.vectorstore.count() == 0


def test_xl_restart_builds_afresh_in_port(tmp_path):
    from archi_tpu_torch.bin.bootstrap import build_index, build_vectorstore
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.registry import HashEmbeddings

    dm = _xl_dm_cfg(tmp_path, "port")
    _xl_checkpoint(TorchVectorStore(
        HashEmbeddings(D), index=build_index(D, dm["index"], device="cpu")),
        dm)
    store = build_vectorstore(dm, device="cpu")
    assert isinstance(store.index, XlPQIndex)
    assert store.count() == 0
