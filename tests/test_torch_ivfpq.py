"""The port's ``IVFPQIndex`` against the JAX package's
``archi_tpu/engine/ivfpq_index.py`` on carried state.

Indexes are built and saved by the JAX package (8-bit codes with and
without a refinement stage; packed 4-bit codes with bf16 block centroids;
a spilled streaming build), loaded by the port, and searched by both:
cell probing, shared and per-query bias with tombstones, block probing with
``sub`` and ``cell_gate``, ``hier`` and explicit ``approx`` extraction, the
spill dedupe and the host exact rerank.  Tolerances are those of
``tests/unit/test_ivfpq.py`` (rtol 1e-4 / atol 1e-5); rows tie-aware.  On
the CPU the JAX package scores with ``adc_scores_xla`` and the port with
its plain versions: the same bf16-rounded tables, summed in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from archi_tpu.engine import host_store as jhs
from archi_tpu.engine.ivfpq_index import IVFPQIndex as JIndex
from archi_tpu_torch.engine import host_store as ths
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex as TIndex
from archi_tpu_torch.engine.topk import NEG_INF

RTOL, ATOL = 1e-4, 1e-5


def _corpus(rng, n, d=32, clusters=32, noise=0.15):
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + \
        noise * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_topk(got_v, got_r, want_v, want_r):
    """Scores within tolerance position by position; a row in one list only
    must tie with the last score kept."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_r, want_r = np.asarray(got_r), np.asarray(want_r)
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
    for b in range(got_v.shape[0]):
        g = dict(zip(got_r[b].tolist(), got_v[b].tolist()))
        w = dict(zip(want_r[b].tolist(), want_v[b].tolist()))
        for r in set(g) ^ set(w):
            s = g.get(r, w.get(r))
            assert abs(s - want_v[b, -1]) <= ATOL + RTOL * abs(s), \
                (b, r, s, want_v[b, -1])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """JAX-built indexes, saved; → (x, q, {kind: (jax index, npz path)})."""
    rng = np.random.default_rng(5)
    x = _corpus(rng, 4096)
    q = _corpus(rng, 6)
    root = tmp_path_factory.mktemp("ivfpq")
    out = {}
    idx = JIndex.build(x, nlist=16, block=256, m=8, seed=0)
    out["8bit"] = idx
    out["refined"] = JIndex.build(x, nlist=16, block=256, m=8, seed=0,
                                  refine_m=8)
    packed = JIndex.build(x, nlist=16, block=128, m=8, ksub=16, seed=0,
                          refine_m=8)
    packed.ensure_block_centroids(dtype=jnp.bfloat16, sub=4)
    out["packed"] = packed

    def block_fn(i):
        return jnp.asarray(x[i * 1024:(i + 1) * 1024])

    out["spill"] = JIndex.build_streaming(
        block_fn, 4, 1024, nlist=16, block=128, m=8, ksub=16, refine_m=8,
        spill_frac=0.2, pq_iters=4, coarse_iters=4)
    paths = {}
    for kind, j in out.items():
        paths[kind] = str(root / f"{kind}.npz")
        j.save(paths[kind])
    return x, q, {k: (out[k], paths[k]) for k in out}


def _pair(built, kind):
    """Fresh loads of one saved index in both packages (searches may
    rebuild an index's block centroids, so tests share no index object)."""
    path = built[2][kind][1]
    return JIndex.load(path), TIndex.load(path, device="cpu")


def _both(j, t, q, k, **kw):
    jv, jr = j.search_dispatch(q, k, **kw)
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    tv, tr = t.search_dispatch(torch.from_numpy(q), k, **tkw)
    assert tv.dtype == torch.float32 and tr.dtype == torch.int32
    assert_same_topk(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))
    return tv.numpy(), tr.numpy()


@pytest.mark.parametrize("kind", ["8bit", "refined"])
@pytest.mark.parametrize("nprobe", [3, 16])
def test_cell_probing(built, kind, nprobe):
    j, t = _pair(built, kind)
    assert t.packed is False and (t.refine_codec is None) == (kind == "8bit")
    assert len(t) == len(j) == 4096
    _both(j, t, built[1], 10, nprobe=nprobe)
    _both(j, t, built[1], 100, nprobe=nprobe, refine_overfetch=2)


@pytest.mark.parametrize("kind", ["refined", "packed"])
def test_shared_and_per_query_bias_with_tombstones(built, kind):
    j, t = _pair(built, kind)
    q = built[1]
    rng = np.random.default_rng(11)
    shared = np.where(rng.random(4096) < 0.2, NEG_INF, 0.0).astype(np.float32)
    shared[7] = 0.5
    per_q = (shared[None, :] + 0.3 * rng.random((6, 4096))).astype(np.float32)
    for bias in (shared, per_q):
        tv, tr = _both(j, t, q, 10, nprobe=4, bias=bias)
        dead = np.flatnonzero(shared < -1e29)
        assert not np.isin(tr[tv > -1e29], dead).any()
        # groups of 4 pad the batch of 6 (a per-query bias with it)
        _both(j, t, q, 10, nprobe=4, bias=bias, vmem_budget_rows=1 << 20)


@pytest.mark.parametrize("cell_gate", [None, 4])
@pytest.mark.parametrize("npb", [3, 10])
def test_packed_block_probing(built, cell_gate, npb):
    j, t = _pair(built, "packed")
    assert t.packed and t.code_blocks.shape[2] == 4
    assert t._bc_sub == 4 and t.block_centroids.dtype == torch.bfloat16
    saved = JIndex.load(built[2]["packed"][1]).block_centroids
    np.testing.assert_array_equal(t.block_centroids.float().numpy(),
                                  np.asarray(saved.astype(jnp.float32)))
    bias = np.zeros(4096, np.float32)
    bias[::9] = NEG_INF
    _both(j, t, built[1], 10, nprobe_blocks=npb, cell_gate=cell_gate,
          bias=bias)
    _both(j, t, built[1], 12, nprobe_blocks=npb, cell_gate=cell_gate,
          refine_overfetch=1)


def test_block_centroids_decoded_from_codes(built):
    """The port's decode of the codes into per-block mini-centroids (f32,
    another sub) equals the JAX package's."""
    j, t = _pair(built, "packed")
    jb = np.asarray(j.ensure_block_centroids(dtype=jnp.float32, sub=2))
    tb = t.ensure_block_centroids(dtype=torch.float32, sub=2)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=RTOL, atol=ATOL)
    assert t.block_rank_sub == 2 and t._bc_sub == 2
    with pytest.raises(ValueError, match="not divisible"):
        t.ensure_block_centroids(sub=3)


@pytest.mark.parametrize("extract", ["hier", "approx", "exact"])
def test_extraction_modes(built, extract):
    """hier: per-block top-hier_t then an exact merge; approx: the strided
    layout of the JAX package's ApproxTopK path (exact off a TPU) — the
    refined index over-fetches 80 candidates from 8192 slots, so it
    engages."""
    j, t = _pair(built, "refined")
    q = built[1]
    for hier_t in (4, 64):
        _both(j, t, q, 10, nprobe=16, extract=extract, hier_t=hier_t)
    jp, tp = _pair(built, "packed")
    _both(jp, tp, q, 10, nprobe_blocks=10, extract=extract, hier_t=8)


def test_spill_dedupe(built):
    j, t = _pair(built, "spill")
    assert t._n_slots > t._n_rows == len(j) == 4096
    q = built[1]
    jids, jv, jr = j.search(q, k=10, nprobe=4)
    tids, tv, tr = t.search(torch.from_numpy(q), k=10, nprobe=4)
    assert_same_topk(tv, tr, jv, jr)
    for rr in tr:
        live = rr[rr >= 0]
        assert len(set(live.tolist())) == len(live)


@pytest.mark.parametrize("kind", ["spill", "refined"])
def test_exact_rerank_through_search(built, kind):
    x = built[0]
    j, t = _pair(built, kind)
    q = built[1]
    jstore = jhs.HostVectorStore(32)
    jstore.add(x)
    tstore = ths.HostVectorStore(32)
    tstore.add(x)
    bias = np.zeros(4096, np.float32)
    bias[3::5] = 0.1
    jids, jv, jr = j.search(q, k=10, nprobe=4, rerank_store=jstore, bias=bias)
    tids, tv, tr = t.search(torch.from_numpy(q), k=10, nprobe=4,
                            rerank_store=tstore, bias=torch.from_numpy(bias))
    assert_same_topk(tv, tr, jv, jr)
    # exact f16 scores of the returned rows
    got = np.einsum("bkd,bd->bk", x.astype(np.float16).astype(np.float32)[tr],
                    q / np.linalg.norm(q, axis=1, keepdims=True)) + bias[tr]
    np.testing.assert_allclose(tv, got, rtol=RTOL, atol=ATOL)


def test_exact_rerank_function_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    rows = rng.integers(-1, 300, (4, 40))
    rows[:, 5] = rows[:, 2]                           # spilled duplicates
    vals = rng.standard_normal((4, 40)).astype(np.float32)
    vals[rows < 0] = NEG_INF
    bias2 = rng.standard_normal((4, 300)).astype(np.float32)
    js, ts = jhs.HostVectorStore(16), ths.HostVectorStore(16)
    js.add(x)
    ts.add(x)
    for bias in (None, bias2[0], bias2):
        for k in (5, 30):
            want = jhs.exact_rerank(js, q, vals, rows, k=k, bias=bias)
            got = ths.exact_rerank(ts, q, vals, rows, k=k, bias=bias)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ths.mark_duplicate_rows(rows),
                                  jhs.mark_duplicate_rows(rows))


@pytest.mark.parametrize("kind", ["refined", "packed", "spill"])
def test_save_load_both_ways(built, kind, tmp_path):
    """The port's npz loads in the JAX package (and back) and searches the
    same; the bf16 block centroids travel as a uint16 bit view."""
    j, t = _pair(built, kind)
    t.save(str(tmp_path / "t.npz"))
    back = JIndex.load(str(tmp_path / "t.npz"))
    assert back._n_rows == j._n_rows and back._n_slots == j._n_slots
    kw = {"nprobe_blocks": 6} if kind == "packed" else {"nprobe": 5}
    _both(back, t, built[1], 10, **kw)
    t2 = TIndex.load(str(tmp_path / "t.npz"), device="cpu",
                     drop_refine=True)
    assert t2.refine_codec is None and t2.refine_codes is None


def test_adc_impls_agree_on_the_cpu(built):
    _j, t = _pair(built, "packed")
    q = torch.from_numpy(built[1])
    a = t.search_dispatch(q, 10, nprobe=4, adc_impl="kernel")
    b = t.search_dispatch(q, 10, nprobe=4, adc_impl="plain")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="adc_impl"):
        t.search_dispatch(q, 10, adc_impl="pallas")


def test_port_builds_load_in_jax(built, tmp_path):
    """Indexes built by the port (device build with refine; streaming with
    packed codes and spill) are valid state for the JAX package, and find
    each probe's exact neighbours."""
    x, q = built[0], built[1]
    tx = torch.from_numpy(x)
    dev = TIndex.build(x, nlist=16, block=256, m=8, seed=0, refine_m=8,
                       device="cpu")
    stream = TIndex.build_streaming(
        lambda i: tx[i * 1024:(i + 1) * 1024], 4, 1024, nlist=16, block=128,
        m=8, ksub=16, refine_m=8, spill_frac=0.2, pq_iters=4, coarse_iters=4)
    assert stream.packed and stream._n_slots > stream._n_rows == 4096
    exact = np.argsort(-(q @ x.T), axis=1)[:, :10]
    for t in (dev, stream):
        t.save(str(tmp_path / "p.npz"))
        back = JIndex.load(str(tmp_path / "p.npz"))
        _both(back, t, q, 10, nprobe=16)
        _ids, _v, rows = t.search(torch.from_numpy(q), k=100, nprobe=16)
        recall = np.mean([len(set(rows[b]) & set(exact[b])) / 10
                          for b in range(len(q))])
        assert recall >= 0.9, recall
