"""The port's PQ codec, ADC top-k and ``PQFlatIndex`` against the JAX
package's ``archi_tpu/engine/pq.py``.

Codebooks (and OPQ rotations) trained by the JAX package are carried into
the port through ``save_arrays`` / ``from_arrays``; encode, decode, LUTs
and searches over that carried state are compared exactly (codes equal up
to distance ties, scores within 1e-5, rows tie-aware).  Training itself is
compared on data whose assignments are unambiguous.  The JAX searches use
``impl="onehot"``, the formulation with the bf16-rounded table that the
TPU kernel and the port compute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import pq as jpq
from archi_tpu_torch.engine import pq as tpq
from archi_tpu_torch.engine.topk import NEG_INF

ATOL = 1e-5


def _corpus(rng, n, d=32, clusters=16, noise=0.15):
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + \
        noise * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


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


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = _corpus(rng, 2048)
    q = _corpus(rng, 8)
    codecs = {
        "pq": jpq.PQCodec.train(x, 8, ksub=64, iters=6, seed=0),
        "opq": jpq.PQCodec.train(x, 8, ksub=32, iters=4, seed=1, opq_iters=2),
    }
    return x, q, codecs


def _carry(jcodec):
    return tpq.PQCodec.from_arrays(jcodec.save_arrays(), device="cpu")


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_codec_on_carried_codebooks(data, kind):
    x, q, codecs = data
    jc = codecs[kind]
    tc = _carry(jc)
    assert (tc.rotation is None) == (kind == "pq")
    jcodes = np.array(jc.encode(x))
    tcodes = tc.encode(torch.from_numpy(x)).numpy()
    assert tcodes.dtype == np.uint8 and tcodes.shape == (2048, 8)
    differ = np.argwhere(jcodes != tcodes)
    assert len(differ) <= 2, differ
    # a differing code must be a distance tie
    xr = np.asarray(jc._rotate(jnp.asarray(x))).reshape(2048, 8, -1)
    cb = np.asarray(jc.codebooks)
    for r, j in differ:
        d = ((cb[j] - xr[r, j]) ** 2).sum(axis=1)
        assert abs(d[jcodes[r, j]] - d[tcodes[r, j]]) <= 1e-5
    np.testing.assert_allclose(tc.decode(torch.from_numpy(jcodes)).numpy(),
                               np.asarray(jc.decode(jcodes)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.luts(torch.from_numpy(q)).numpy(),
                               np.asarray(jc.luts(q)), rtol=0, atol=ATOL)
    back = jpq.PQCodec.from_arrays(tc.save_arrays())
    np.testing.assert_array_equal(np.asarray(back.codebooks),
                                  np.asarray(jc.codebooks))


def test_train_matches_on_unambiguous_data():
    """Noiseless rows at 24 points of a coarse grid: sums, means and
    distances are exact in f32 whatever the order, so every assignment is
    unambiguous (equal distances tie exactly, first index in both) and both
    packages train the same codebooks from the same seeded rows."""
    rng = np.random.default_rng(3)
    pts = (rng.integers(-8, 9, (24, 16)) / 4.0).astype(np.float32)
    x = pts[rng.integers(0, 24, 3000)]
    for kw in ({"ksub": 16, "iters": 5, "seed": 2},
               {"ksub": 32, "iters": 3, "seed": 4, "sample": 1000}):
        jc = jpq.PQCodec.train(x, 4, **kw)
        tc = tpq.PQCodec.train(torch.from_numpy(x), 4, **kw)
        np.testing.assert_array_equal(tc.codebooks.numpy(),
                                      np.asarray(jc.codebooks))
        np.testing.assert_array_equal(tc.encode(torch.from_numpy(x)).numpy(),
                                      np.asarray(jc.encode(x)))


def _jax_index(codec, x, tile):
    idx = jpq.PQFlatIndex(codec, capacity=x.shape[0], tile=tile)
    idx.add(x)
    return idx


@pytest.mark.parametrize("tile", [1024, 1 << 20])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_pq_flat_index_search_on_carried_state(data, tmp_path, tile, impl):
    x, q, codecs = data
    jidx = _jax_index(codecs["opq"], x, tile)
    jidx.save(str(tmp_path / "pq.npz"))
    tidx = tpq.PQFlatIndex.load(str(tmp_path / "pq.npz"), device="cpu")
    assert tidx.n_rows == 2048 and tidx.capacity == jidx.capacity
    bias = np.zeros(2048, np.float32)
    bias[::7] = NEG_INF                                  # tombstones
    bias[5] = 0.2                                        # a finite boost
    for kw in ({}, {"bias": bias}):
        jids, jv, jr = jidx.search(q, k=10, impl="onehot", **kw)
        tkw = {"bias": torch.from_numpy(bias)} if kw else {}
        tids, tv, tr = tidx.search(torch.from_numpy(q), k=10, impl=impl, **tkw)
        assert_same_topk(tv, tr, jv, jr)
        if kw:
            assert not np.isin(tr, np.arange(0, 2048, 7)).any()


def test_npz_written_by_the_port_loads_in_jax(data, tmp_path):
    x, q, codecs = data
    tidx = tpq.PQFlatIndex(_carry(codecs["pq"]), capacity=512, tile=1024)
    tidx.add(torch.from_numpy(x[:1500]), ids=[f"r{i}" for i in range(1500)])
    tidx.add(torch.from_numpy(x[1500:]), ids=[f"r{i}" for i in range(1500, 2048)])
    assert tidx.capacity == 2048
    tidx.save(str(tmp_path / "t.npz"))
    jidx = jpq.PQFlatIndex.load(str(tmp_path / "t.npz"))
    jids, jv, jr = jidx.search(q, k=6, impl="onehot")
    tids, tv, tr = tidx.search(torch.from_numpy(q), k=6)
    assert_same_topk(tv, tr, jv, jr)
    assert tids[0][0] == f"r{tr[0][0]}"


def test_adc_topk_tiles_and_rows_past_n_active(data):
    """Several tiles merged, rows >= n_active masked, against the JAX
    function (one-hot formulation)."""
    x, q, codecs = data
    jc = codecs["pq"]
    codes_t = np.asarray(jc.encode(x)).T.copy()
    luts = np.asarray(jc.luts(q))
    bias = np.where(np.arange(2048) % 5 == 0, NEG_INF, 0.0).astype(np.float32)
    for n_active, k in ((2048, 10), (1500, 12), (3, 5)):
        jv, ji = jpq.adc_topk(jnp.asarray(luts), jnp.asarray(codes_t),
                              jnp.asarray(bias), n_active, k=k, tile=512,
                              impl="onehot")
        tv, ti = tpq.adc_topk(torch.from_numpy(luts), torch.from_numpy(codes_t),
                              torch.from_numpy(bias), n_active, k=k, tile=512)
        assert ti.dtype == torch.int32
        assert_same_topk(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji))
    with pytest.raises(ValueError, match="does not divide"):
        tpq.adc_topk(torch.from_numpy(luts), torch.from_numpy(codes_t),
                     torch.from_numpy(bias), 2048, tile=1000)


def test_build_and_recall():
    """The port's build: trains, encodes, and finds each stored row among
    its own top-5 (a corpus of 512 clusters, about two rows each)."""
    rng = np.random.default_rng(9)
    x = _corpus(rng, 1024, clusters=512)
    tidx = tpq.PQFlatIndex.build(torch.from_numpy(x), m=8, ksub=32, iters=4,
                                 tile=1024)
    _ids, _v, rows = tidx.search(torch.from_numpy(x[:32]), k=5)
    hit = np.mean([i in rows[i] for i in range(32)])
    assert hit >= 0.9, hit
