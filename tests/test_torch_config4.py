"""BASELINE config 4 on the port: the IVF-PQ build it runs, against the JAX
package's, and the four config-4 scripts (``scripts/torch_fill_host_store.py``,
``torch_run_config4.py``, ``torch_run_config4_sharded.py``,
``torch_bench_shard_scaling.py``) on the CPU at a small size.

The index part builds with ``IVFPQIndex.build_streaming`` in JAX at config
4's parameter set, cut to size (packed 4-bit codes, a refinement stage,
spill, OPQ; nlist 32, m 8, four blocks of 4,096 rows), saves it, loads it in
the port with and without ``drop_refine`` and searches both through every
rerank spec kind of the config-4 sweep (``npb:C:rfo:gate``,
``cell:nprobe:C:rfo``), ``block_rank_sub`` and both extractions: rows
tie-aware equal, scores within 1e-4.  The scripts run on four blocks of
4,096 rows of the synthetic corpus (the QPS timings cut to one batch) and
keep the JAX scripts' payload keys; the headline rule is held against the
JAX script's own lines.
"""

import ast
import pathlib
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from archi_tpu.engine import host_store as jhs
from archi_tpu.engine.ivfpq_index import IVFPQIndex as JIndex
from archi_tpu_torch.engine import host_store as ths
from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex as TIndex
from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex, _merge

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
BLOCK_ROWS, N_BLOCKS = 4096, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_topk(got_v, got_r, want_v, want_r, tol=TOL):
    """Scores within tol position by position; a row in one list only must
    tie with the last score kept."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_r, want_r = np.asarray(got_r), np.asarray(want_r)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=tol)
    for b in range(got_v.shape[0]):
        g = dict(zip(got_r[b].tolist(), got_v[b].tolist()))
        w = dict(zip(want_r[b].tolist(), want_v[b].tolist()))
        for r in set(g) ^ set(w):
            s = g.get(r, w.get(r))
            assert abs(s - want_v[b, -1]) <= tol, (b, r, s, want_v[b, -1])


# ------------------------------------------------------------ the index
def _corpus(rng, n, d=32, clusters=64, noise=0.15):
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + \
        noise * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A JAX streaming build at config 4's parameter set, saved; → (x, q,
    path, JAX store, port store)."""
    rng = np.random.default_rng(12)
    x = _corpus(rng, N_BLOCKS * BLOCK_ROWS)
    q = x[rng.choice(len(x), 8, replace=False)] + \
        0.03 * rng.standard_normal((8, 32)).astype(np.float32)

    def block_fn(i):
        return jnp.asarray(x[i * BLOCK_ROWS:(i + 1) * BLOCK_ROWS])

    idx = JIndex.build_streaming(
        block_fn, N_BLOCKS, BLOCK_ROWS, nlist=32, block=128, m=8, ksub=16,
        refine_m=8, train_blocks=2, train_sample=1 << 21, coarse_iters=8,
        pq_iters=10, seed=0, spill_frac=0.15, opq_iters=2)
    idx.ensure_block_centroids(dtype=jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("config4") / "ivfpq.npz")
    idx.save(path)
    jstore = jhs.HostVectorStore(32, dtype=ml_dtypes.bfloat16)
    jstore.add(x)
    tstore = ths.HostVectorStore(32, dtype=ths.BF16)
    tstore.add(x)
    return x, q, path, jstore, tstore


def _pair(built, drop_refine=False):
    path = built[2]
    return (JIndex.load(path, drop_refine=drop_refine),
            TIndex.load(path, drop_refine=drop_refine, device="cpu"))


def _spec_kwargs(spec):
    """A config-4 rerank spec → ``search`` keyword arguments."""
    from scripts.torch_run_config4 import K, parse_rerank_sweep

    (mode, probe, c, rfo, gate), = parse_rerank_sweep(spec)
    kw = {"rerank_overfetch": max(1, c // K), "refine_overfetch": rfo,
          **({"nprobe_blocks": probe} if mode == "npb" else
             {"nprobe": probe})}
    if gate:
        kw["cell_gate"] = gate
    return kw


def test_the_build_is_config4s(built):
    _j, t = _pair(built)
    assert t.packed and t.refine_codec is not None
    assert t.codec.ksub == 16 and t.codec.rotation is not None
    assert t.refine_codec.rotation is not None
    assert t._n_slots > t._n_rows == N_BLOCKS * BLOCK_ROWS   # spilled
    assert t.block_centroids.dtype == torch.bfloat16
    _, t_drop = _pair(built, drop_refine=True)
    assert t_drop.refine_codec is None and t_drop.refine_codes is None


@pytest.mark.parametrize("drop_refine", [False, True])
@pytest.mark.parametrize("extract", ["exact", "hier"])
@pytest.mark.parametrize("spec", ["24:40:1:0", "24:40:1:4", "48:80:1:0",
                                  "cell:4:40:8", "cell:8:40:1"])
def test_rerank_specs_match_jax(built, spec, extract, drop_refine):
    x, q, _path, jstore, tstore = built
    j, t = _pair(built, drop_refine)
    kw = _spec_kwargs(spec)
    _jids, jv, jr = j.search(q, k=10, rerank_store=jstore, extract=extract,
                             hier_t=16, **kw)
    _tids, tv, tr = t.search(torch.from_numpy(q), k=10, rerank_store=tstore,
                             extract=extract, hier_t=16, **kw)
    assert_same_topk(tv, tr, jv, jr)
    # exact products with the host rows (bf16)
    rows = ths.bf16_bits_to_f32(ths.f32_to_bf16_bits(x))[tr]
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(tv, np.einsum("bkd,bd->bk", rows, qn),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("sub", [2, 4])
def test_block_rank_sub_matches_jax(built, sub):
    _x, q, _path, jstore, tstore = built
    j, t = _pair(built)
    j.block_rank_sub = t.block_rank_sub = sub
    kw = _spec_kwargs("24:40:1:0")
    _i, jv, jr = j.search(q, k=10, rerank_store=jstore, **kw)
    _i, tv, tr = t.search(torch.from_numpy(q), k=10, rerank_store=tstore,
                          **kw)
    assert t.block_centroids.shape[0] == sub * t.code_blocks.shape[0]
    assert_same_topk(tv, tr, jv, jr)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("nprobe", [4, 8])
def test_adc_only_sweep_matches_jax(built, nprobe, k):
    """The ADC-only sweep's searches (refine over-fetch 16, no rerank)."""
    q = built[1]
    j, t = _pair(built)
    jv, jr = j.search_dispatch(q, k, nprobe=nprobe, refine_overfetch=16)
    tv, tr = t.search_dispatch(torch.from_numpy(q), k, nprobe=nprobe,
                               refine_overfetch=16)
    assert_same_topk(tv.numpy(), tr.numpy(), np.asarray(jv), np.asarray(jr))


# ------------------------------------------------------------ the scripts
def _payload_keys(script, function="main", target="payload"):
    """The string keys of the dict literals ``function`` of a JAX script
    assigns to ``target``, appends to the list ``target``, or (``target``
    None) returns."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    dicts = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) \
                and [getattr(t, "id", None) for t in n.targets] == [target]:
            dicts.append(n.value)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "append" \
                and getattr(n.func.value, "id", None) == target \
                and n.args and isinstance(n.args[0], ast.Dict):
            dicts.append(n.args[0])
        elif target is None and isinstance(n, ast.Return) \
                and isinstance(n.value, ast.Dict):
            dicts.append(n.value)
    keys = [k.value for d in dicts for k in d.keys
            if isinstance(k, ast.Constant)]
    assert keys, (script, function, target)
    return keys


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Four blocks of 4,096 synthetic rows filled by the fill script."""
    from scripts import torch_fill_host_store as fill

    path = str(tmp_path_factory.mktemp("plane") / "config4.bf16")
    out = fill.fill(path, blocks=N_BLOCKS, block_rows=BLOCK_ROWS,
                    device="cpu", log=lambda _m: None)
    return path, out


@pytest.fixture
def one_batch(monkeypatch):
    """The QPS timings cut to one batch of one trial."""
    from scripts import torch_run_config4 as cfg4
    from scripts import torch_run_config4_sharded as cfg4s

    for mod in (cfg4, cfg4s):
        monkeypatch.setattr(mod, "REPS", 1)
        monkeypatch.setattr(mod, "TRIALS", 1)


def test_fill_writes_the_generator_rows(plane):
    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn

    path, out = plane
    assert out["rows"] == N_BLOCKS * BLOCK_ROWS
    assert out["blocks_filled"] == N_BLOCKS and out["gb_per_s"] > 0
    store = ths.HostVectorStore(384, path=path, dtype=ths.BF16)
    block_fn = make_block_fn(0, N_BLOCKS, block_rows=BLOCK_ROWS,
                             device="cpu")
    want = torch.cat([block_fn(i) for i in range(N_BLOCKS)])
    np.testing.assert_array_equal(
        np.asarray(store._buf[:len(store)]),
        want.view(torch.int16).numpy().view(np.uint16))
    # the plane reads back as the generator's values
    np.testing.assert_array_equal(store.get(np.arange(8)),
                                  want[:8].float().numpy())


def test_fill_resumes_from_the_store_count(tmp_path):
    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn
    from scripts import torch_fill_host_store as fill

    path = str(tmp_path / "plane.bf16")
    block_fn = make_block_fn(0, 3, block_rows=BLOCK_ROWS, device="cpu")
    store = fill.open_store(path, 3 * BLOCK_ROWS, 384)
    for part in fill.block_bits(block_fn(0), 1000):
        store.add(part)
    store.flush()
    del store
    out = fill.fill(path, blocks=3, block_rows=BLOCK_ROWS, sub_rows=1024,
                    device="cpu", log=lambda _m: None)
    assert out["blocks_filled"] == 2 and out["rows"] == 3 * BLOCK_ROWS
    store = fill.open_store(path, 3 * BLOCK_ROWS, 384)
    want = torch.cat([block_fn(i) for i in range(3)])
    np.testing.assert_array_equal(
        np.asarray(store._buf[:len(store)]),
        want.view(torch.int16).numpy().view(np.uint16))
    # a count that is not block-aligned is refused
    store.add(np.zeros((5, 384), np.uint16))
    store.flush()
    with pytest.raises(ValueError, match="block-aligned"):
        fill.fill(path, blocks=4, block_rows=BLOCK_ROWS, device="cpu",
                  log=lambda _m: None)


def test_bf16_store_takes_raw_bits():
    store = ths.HostVectorStore(4, dtype=ths.BF16)
    x = np.array([[1.0, -2.5, 3.0e-3, 7.0]], np.float32)
    store.add(ths.f32_to_bf16_bits(x))
    store.add(x)
    np.testing.assert_array_equal(store._buf[0], store._buf[1])


def test_config4_run_has_the_jax_payload(plane, one_batch, tmp_path):
    import json

    from scripts import torch_run_config4 as cfg4

    path, _out = plane
    out = tmp_path / "config4.json"
    payload, state = cfg4.measure(
        out, rows=N_BLOCKS * BLOCK_ROWS, block_rows=BLOCK_ROWS,
        store_path=path, nlist=32, block=128, spill=0.15, opq=2,
        dev_sweep="2:40,4:80:2",
        rerank_sweep="8:40,16:80:1:2,cell:8:160", device="cpu",
        log=lambda _m: None)
    assert json.loads(out.read_text()) == payload
    assert list(payload) == _payload_keys("run_config4.py")
    for target, entries in (("sweep", payload["nprobe_sweep"]),
                            ("dev_sweep", payload["dev_sweep"]),
                            ("rerank_sweep", payload["rerank_sweep"])):
        assert len(entries) in (2, 3, 4)
        for e in entries:
            assert set(_payload_keys("run_config4.py", target=target)) \
                <= set(e), target
    assert payload["rows"] == N_BLOCKS * BLOCK_ROWS
    assert payload["host_store"]["rows"] == payload["rows"]
    assert payload["build"] == {"nlist": 32, "block": 128,
                                "spill_frac": 0.15, "opq_iters": 2}
    assert payload["headline"] == cfg4.headline_of(payload["nprobe_sweep"],
                                                   payload["rerank_sweep"])
    assert payload["headline"]["recall_score_at_10"] >= 0.99
    # the ground truth is the exact f32 scan of the plane's rows
    store, q = state["store"], state["q"]
    scores = store.get(np.arange(len(store))) @ q.T
    order = np.argsort(-scores, axis=0, kind="stable")[:10].T
    assert_same_topk(state["exact_vals"], state["exact"],
                     np.take_along_axis(scores.T, order, axis=1), order)
    # the host rerank's scores are exact products with the host rows
    for vals, rows in state["rerank_out"]:
        got = np.einsum("bkd,bd->bk", store.get(rows.reshape(-1))
                        .reshape(*rows.shape, -1), q)
        np.testing.assert_allclose(vals, got, rtol=0, atol=TOL)


def _jax_headline(sweep, rerank_sweep):
    """The JAX script's headline rule, run from its own lines."""
    src = (ROOT / "scripts" / "run_config4.py").read_text().splitlines()
    start = next(i for i, line in enumerate(src)
                 if line.strip().startswith("good = [s for s in rerank_sweep"))
    end = next(i for i in range(start, len(src))
               if src[i].strip().startswith("payload = {"))
    ns = {"sweep": sweep, "rerank_sweep": rerank_sweep}
    exec(textwrap.dedent("\n".join(src[start:end])), ns)
    return ns["headline"]


def _rr(probe, qps, strict, score, mode="npb"):
    key = "nprobe_blocks" if mode == "npb" else "nprobe"
    return {"probe_mode": mode, key: probe, "rerank_c": 320,
            "recall_strict_at_10": strict, "recall_score_at_10": score,
            "query_qps": qps, "self_top1": 1.0}


def _adc(nprobe, qps, top1):
    return {"nprobe": nprobe, "recall_strict_at_10": 0.2,
            "self_top1": top1, "query_qps": qps}


@pytest.mark.parametrize("case", [
    # score recall >= 0.99: the fastest such entry, not the fastest overall
    ([_adc(4, 900.0, 0.9)], [_rr(128, 400.0, 0.97, 0.985),
                             _rr(256, 300.0, 0.99, 0.991),
                             _rr(512, 200.0, 0.995, 0.996),
                             _rr(8, 350.0, 0.992, 0.993, mode="cell")]),
    # none at 0.99: strict >= 0.95
    ([], [_rr(128, 400.0, 0.94, 0.95), _rr(256, 300.0, 0.96, 0.97),
          _rr(512, 200.0, 0.97, None)]),
    # no rerank entry qualifies: the ADC sweep's fastest self_top1 >= 0.7
    ([_adc(4, 900.0, 0.6), _adc(8, 700.0, 0.75), _adc(16, 500.0, 0.9)],
     [_rr(128, 400.0, 0.5, 0.5)]),
    # none at 0.7: the best self_top1
    ([_adc(4, 900.0, 0.3), _adc(8, 700.0, 0.5)], []),
    ([], []),
], ids=["score", "strict", "adc", "adc-best-top1", "empty"])
def test_headline_rule_matches_jax(case):
    from scripts.torch_run_config4 import headline_of

    sweep, rerank = case
    assert headline_of(sweep, rerank) == _jax_headline(sweep, rerank)


def test_sharded_run_recall_and_host_scores(plane, one_batch):
    from scripts import torch_run_config4_sharded as cfg4s

    path, _out = plane
    payload, state = cfg4s.measure(
        shards=2, store_path=path, budgets=(16, 64), nlist=128,
        block_rows=BLOCK_ROWS, device="cpu", log=lambda _m: None)
    assert list(payload) == _payload_keys("run_config4_sharded.py")
    for e in payload["sweep"]:
        assert set(_payload_keys("run_config4_sharded.py",
                                 target="sweep")) <= set(e)
    assert payload["rows"] == N_BLOCKS * BLOCK_ROWS and payload["shards"] == 2
    assert payload["sweep"][-1]["recall_score_at_10"] >= 0.9
    assert payload["sweep"][-1]["total_rerank_c"] == 320
    parent, q = state["parent"], state["q"]
    for vals, rows in state["searches"]:
        assert (rows >= 0).all()
        got = np.einsum("bkd,bd->bk", parent.get(rows.reshape(-1))
                        .reshape(*rows.shape, -1), q)
        np.testing.assert_allclose(vals, got, rtol=0, atol=TOL)


def test_shard_scan_only_merged_equals_the_full_search():
    from scripts.torch_bench_shard_scaling import scan_only

    rng = np.random.default_rng(3)
    x = rng.standard_normal((20_000, 384)).astype(np.float32)
    idx = ShardedFlatIndex(384, devices=["cpu"] * 4, normalize=False)
    idx.add(x / np.linalg.norm(x, axis=1, keepdims=True),
            list(range(len(x))))
    idx.delete(list(range(0, 20_000, 7)))
    q = rng.standard_normal((32, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    parts = scan_only(idx, q)
    assert len(parts) == 4
    vals, rows = _merge(torch.cat([v for v, _r in parts], 1),
                        torch.cat([r for _v, r in parts], 1), 10)
    want_v, want_r = idx.search_dispatch(q, k=10)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0)
    assert torch.equal(rows, want_r)
    assert not np.isin(rows.numpy(), np.arange(0, 20_000, 7)).any()


def test_shard_scaling_has_the_jax_payload(tmp_path, monkeypatch):
    import json

    from scripts import torch_bench_shard_scaling as scaling

    monkeypatch.setattr(scaling, "SHARD_COUNTS", (1, 2))
    seen = []
    out = tmp_path / "scaling.json"
    payload = scaling.measure(out, rows=1 << 13, device="cpu",
                              log=lambda _m: None,
                              keep=lambda kind, s, idx: seen.append(
                                  (kind, s, len(idx))))
    assert json.loads(out.read_text()) == payload
    assert list(payload) == _payload_keys("bench_shard_scaling.py")
    assert seen == [("flat", 1, 1 << 13), ("flat", 2, 1 << 13),
                    ("xl", 1, 1 << 13), ("xl", 2, 1 << 13)]
    flat_keys = _payload_keys("bench_shard_scaling.py", "bench_flat",
                              target=None)
    xl_keys = _payload_keys("bench_shard_scaling.py", "bench_xl",
                            target=None)
    assert [list(r) for r in payload["sharded_flat"]] == [flat_keys] * 2
    assert [list(r) for r in payload["sharded_xl"]] == [xl_keys] * 2
    assert [r["collective_bytes_per_batch"] for r in
            payload["sharded_flat"]] == [1 * 32 * 10 * 8, 2 * 32 * 10 * 8]
    assert all(r["snapshot_rows"] == 1 << 13 for r in payload["sharded_xl"])
