"""The port's k-means, IVF block layout and ``IVFIndex`` against the JAX
package's ``archi_tpu/engine/{kmeans,ivf_index}.py``.

k-means is compared on well-separated clusters, where every assignment is
unambiguous: same assignments, centroids within 1e-5.  ``IVFIndex``
searches are compared on carried state (an index built and saved by one
package, loaded by the other): rows tie-aware, scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import ivf_index as jivf
from archi_tpu.engine.kmeans import kmeans as jax_kmeans
from archi_tpu_torch.engine import ivf_index as tivf
from archi_tpu_torch.engine.kmeans import kmeans as torch_kmeans
from archi_tpu_torch.engine.topk import NEG_INF

ATOL = 1e-5


def _clustered(rng, n_clusters=8, per=64, d=32, noise=0.2):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    x = np.repeat(centers, per, axis=0) + noise * rng.standard_normal(
        (n_clusters * per, d)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def assert_same_topk(got_v, got_r, want_v, want_r, atol=ATOL):
    """Scores within atol position by position; a row in one list only must
    tie (within atol) with the last score kept."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_r, want_r = np.asarray(got_r), np.asarray(want_r)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=atol)
    for b in range(got_v.shape[0]):
        g = dict(zip(got_r[b].tolist(), got_v[b].tolist()))
        w = dict(zip(want_r[b].tolist(), want_v[b].tolist()))
        for r in set(g) ^ set(w):
            s = g.get(r, w.get(r))
            assert abs(s - want_v[b, -1]) <= atol, (b, r, s, want_v[b, -1])


@pytest.mark.parametrize("batch", [1 << 18, 8192])
def test_kmeans_matches_on_separated_clusters(batch):
    """Clusters of copies of orthogonal unit vectors: every dot product is
    exact, so a tie between two centroids is exact in both packages (first
    index) and any other comparison is far from one.  Random initial rows
    put several centroids in some clusters and none in others."""
    rng = np.random.default_rng(1)
    x = np.eye(24, dtype=np.float32)[rng.integers(0, 16, 9600)]
    jc, ja = jax_kmeans(x, 16, iters=6, seed=3, batch=batch)
    tc, ta = torch_kmeans(torch.from_numpy(x), 16, iters=6, seed=3,
                          batch=batch)
    assert ta.dtype == torch.int32 and tc.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)


def test_kmeans_starts_from_the_same_rows_and_keeps_empty_clusters():
    """k close to n: the seeded initial rows are shared, and a cluster that
    empties keeps its previous centroid in both packages."""
    rng = np.random.default_rng(2)
    x = _clustered(rng, n_clusters=4, per=5, d=8, noise=0.01)
    jc, ja = jax_kmeans(x, 12, iters=3, seed=0)
    tc, ta = torch_kmeans(x, 12, iters=3, seed=0, device="cpu")
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)


@pytest.mark.parametrize("nlist,block", [(8, 64), (5, 16), (1, 512)])
def test_cell_block_layout_identical(nlist, block):
    assign = np.random.default_rng(nlist).integers(0, nlist, 700)
    assign[assign == nlist - 1] = 0 if nlist > 1 else assign[0]  # an empty cell
    jg, jcb = jivf.cell_block_layout(assign, nlist, block)
    tg, tcb = tivf.cell_block_layout(assign, nlist, block)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tcb, jcb)


@pytest.mark.parametrize("per_query", [False, True])
def test_bias_to_block_layout_matches(per_query):
    rng = np.random.default_rng(4)
    block_rows = rng.integers(-1, 50, (6, 8)).astype(np.int32)
    valid = (block_rows >= 0).astype(np.float32)
    bias = rng.standard_normal((3, 50) if per_query else (50,)).astype(
        np.float32)
    want = jivf._bias_to_block_layout(jnp.asarray(bias), jnp.asarray(block_rows),
                                      jnp.asarray(valid))
    got = tivf.bias_to_block_layout(torch.from_numpy(bias),
                                    torch.from_numpy(block_rows),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = _clustered(rng)
    q = _clustered(rng, n_clusters=8, per=1)
    jidx = jivf.IVFIndex.build(x, [f"id{i}" for i in range(len(x))], nlist=8,
                               block=32, dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("ivf") / "ivf.npz")
    jidx.save(path)
    return x, q, jidx, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nprobe", [2, 8])
def test_ivf_search_on_carried_state(carried, dtype, nprobe):
    x, q, _jidx, path = carried
    jidx = jivf.IVFIndex.load(path, dtype=getattr(jnp, dtype))
    tidx = tivf.IVFIndex.load(path, dtype=dtype, device="cpu")
    assert len(tidx) == len(jidx) == 512 and tidx.nlist == 8
    rng = np.random.default_rng(nprobe)
    shared = np.where(rng.random(512) < 0.1, NEG_INF, 0.0).astype(np.float32)
    per_q = (shared[None, :] + 0.3 * rng.random((8, 512))).astype(np.float32)
    for bias in (None, shared, per_q):
        jids, jv, jr = jidx.search(q, k=10, nprobe=nprobe, bias=bias)
        tids, tv, tr = tidx.search(
            torch.from_numpy(q), k=10, nprobe=nprobe,
            bias=None if bias is None else torch.from_numpy(bias))
        assert_same_topk(tv, tr, jv, jr)
        assert all(i is None or i == f"id{r}" for ii, rr in zip(tids, tr)
                   for i, r in zip(ii, rr))
    # group size 3 pads the batch of 8 to 9 (the per-query bias with it)
    jv, jr = jidx.search_dispatch(q, 7, nprobe=nprobe, bias=per_q,
                                  vmem_budget_rows=3 * nprobe * 2 * 32)
    tv, tr = tidx.search_dispatch(torch.from_numpy(q), 7, nprobe=nprobe,
                                  bias=torch.from_numpy(per_q),
                                  vmem_budget_rows=3 * nprobe * 2 * 32)
    assert_same_topk(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))


def test_full_probe_is_exact(carried):
    x, q, _jidx, path = carried
    tidx = tivf.IVFIndex.load(path, dtype="float32", device="cpu")
    _ids, tv, tr = tidx.search(torch.from_numpy(q), k=10, nprobe=8)
    exact = q @ x.T
    want_r = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    assert_same_topk(tv, tr, np.take_along_axis(exact, want_r, 1), want_r,
                     atol=1e-5)


def test_port_build_and_save_load_both_ways(carried, tmp_path):
    """The port's build on well-separated clusters lays out the same blocks
    as the JAX build; its npz loads in JAX and searches the same."""
    x, q, jidx, _path = carried
    tidx = tivf.IVFIndex.build(x, None, nlist=8, block=32, dtype="float32",
                               device="cpu")
    np.testing.assert_array_equal(tidx.block_rows, jidx.block_rows)
    np.testing.assert_array_equal(tidx.cell_blocks.numpy(),
                                  np.asarray(jidx.cell_blocks))
    tidx.save(str(tmp_path / "t.npz"))
    back = jivf.IVFIndex.load(str(tmp_path / "t.npz"), dtype=jnp.float32)
    _i, jv, jr = back.search(q, k=10, nprobe=3)
    _i, tv, tr = tidx.search(torch.from_numpy(q), k=10, nprobe=3)
    assert_same_topk(tv, tr, jv, jr)
    dev = tivf.IVFIndex.build_device(torch.from_numpy(x), nlist=8, block=32,
                                     dtype="float32")
    np.testing.assert_array_equal(dev.block_rows, tidx.block_rows)
