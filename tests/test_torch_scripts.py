"""The port's counterparts of the JAX package's measurement and tooling
scripts (``scripts/torch_<name>.py`` beside ``scripts/<name>.py``) and of
its three shell scripts, on the CPU at small sizes, held against the JAX
package on the same inputs.

- Each torch script reads the JAX script's flags (their names, read from its
  source with ``ast``) and keeps its payload keys.
- ``bench_ingest``: ``synth_texts`` bit-equal; the store it builds, over the
  JAX embedder's parameters in f32, gives the JAX store's count, BM25 docs
  and hybrid top-5 (tie-aware, 1e-4).
- ``bench_encoder``: ``model_flops`` equal for the three configs; the port's
  ``encode(attention_impl="plain" | "kernel")`` equals JAX ``encode(
  attention_impl="xla")`` (1e-4 relative).
- ``run_quality --encoder hash`` and ``exp_encoder --hash-only``: the JAX
  functions' totals and ablations exactly (the clocks aside), over the whole
  fixture; the trained paths run at a few steps.
- ``bench_serving``: its batch function equals JAX ``topk_scores(
  impl="xla")`` on one numpy corpus (tie-aware, 1e-4); both modes' sampled
  answers equal a direct single-query scan.
- ``bench_serving_http``: its answers equal the JAX data store's on the same
  chunks (tie-aware, 1e-4).
- ``ann_builder`` in a subprocess on the CPU, then adopt and search (after
  ``tests/integration/test_services.py``'s out-of-process test, with the
  refusal after a compaction), and a JAX export built by the port's builder
  and adopted by the JAX index.
- ``diag_cfg4_misses`` on a 4-block plane: strict recall and miss labels
  equal the JAX script's rule (its own lines) applied to the same
  candidates.
- ``bench_attention_refold``: each form against an f64 layer.
- Every flag in the three ``.sh`` scripts is one its target script reads.
"""

import ast
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
#: (JAX script, port script)
PAIRS = [("diag_cfg4_misses.py", "torch_diag_cfg4_misses.py"),
         ("bench_serving.py", "torch_bench_serving.py"),
         ("bench_serving_http.py", "torch_bench_serving_http.py"),
         ("bench_ingest.py", "torch_bench_ingest.py"),
         ("bench_encoder.py", "torch_bench_encoder.py"),
         ("run_quality.py", "torch_run_quality.py"),
         ("ann_builder.py", "torch_ann_builder.py"),
         ("exp_encoder.py", "torch_exp_encoder.py"),
         ("bench_attention_refold.py", "torch_bench_attention_refold.py")]


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


def assert_same_hits(got, want, tol=TOL):
    """Two hybrid answers, [(text or id, score)]: scores within tol, a hit
    in one answer only tied with the last score."""
    got_v = np.array([[s for _t, s in got]])
    want_v = np.array([[s for _t, s in want]])
    keys = {t: i for i, t in enumerate(sorted({t for t, _s in got + want}))}
    assert_same_topk(got_v, [[keys[t] for t, _s in got]], want_v,
                     [[keys[t] for t, _s in want]], tol)


def _source(script):
    return (ROOT / "scripts" / script).read_text()


def _flags(source) -> set:
    """Every ``--flag`` string constant of a script."""
    return {n.value for n in ast.walk(ast.parse(source))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and re.fullmatch(r"--[a-z][a-z0-9-]*", n.value)}


def _payload_keys(script, function="main", target="payload"):
    """The string keys of the dict literals ``function`` of a JAX script
    assigns to ``target``, appends to the list ``target``, or (``target``
    None) returns."""
    tree = ast.parse(_source(script))
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    dicts = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) \
                and [getattr(t, "id", None) for t in n.targets] == [target]:
            dicts.append(n.value)
        elif target is None and isinstance(n, ast.Return) \
                and isinstance(n.value, ast.Dict):
            dicts.append(n.value)
    keys = [k.value for d in dicts for k in d.keys
            if isinstance(k, ast.Constant)]
    assert keys, (script, function, target)
    return keys


def _jax_function(script, name, ns=None):
    """A top-level function of a JAX script, taken from its source (for
    scripts that parse ``sys.argv`` when imported)."""
    tree = ast.parse(_source(script))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(ns or {})
    exec(compile(ast.Module(body=[fn], type_ignores=[]), script, "exec"), ns)
    return ns[name]


# ---------------------------------------------------------- flags and keys
@pytest.mark.parametrize("jax_script,port_script", PAIRS,
                         ids=[p for p, _ in PAIRS])
def test_port_script_reads_the_jax_flags(jax_script, port_script):
    port_flags = _flags(_source(port_script))
    if port_script == "torch_exp_encoder.py":
        # its training flags are torch_run_quality.train_kwargs's
        port_flags |= _flags(_source("torch_run_quality.py"))
    jax_flags = _flags(_source(jax_script))
    assert jax_flags <= port_flags, jax_flags - port_flags
    # and a run() (or measure()) that takes device=
    tree = ast.parse(_source(port_script))
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    entry = fns.get("measure") or fns["run"]
    assert "device" in [a.arg for a in entry.args.kwonlyargs]


def test_diag_flag_defaults_are_the_jax_scripts():
    from scripts import torch_diag_cfg4_misses as diag

    src = _source("diag_cfg4_misses.py")
    for flag, value in (("--rows", 12582912), ("--probe", 1024),
                        ("--rerank-c", 320)):
        assert f'opt("{flag}", {value}, int)' in src
    assert (diag.B, diag.K) == (32, 10)
    assert os.path.basename(diag.DEFAULT_OUT) == "cfg4_12_miss_diag.json"
    assert "benchmark_results" not in diag.DEFAULT_OUT


# ------------------------------------------------------------ bench_ingest
def test_ingest_texts_are_the_jax_scripts():
    from scripts.bench_ingest import synth_texts as jax_texts
    from scripts.torch_bench_ingest import synth_texts

    assert synth_texts(300) == jax_texts(300)
    assert synth_texts(50, seed=4) == jax_texts(50, seed=4)


def test_ingest_store_matches_jax():
    from archi_tpu.engine.flat_index import FlatIndex as JFlat
    from archi_tpu.engine.vectorstore import TpuVectorStore
    from archi_tpu.models.embedder import JaxEmbedder
    from archi_tpu_torch.models import hf_loader as thf
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from scripts import torch_bench_ingest as ingest
    from scripts.bench_ingest import synth_texts

    n, batch = 24, 8
    jemb = JaxEmbedder(max_length=256, compute_dtype=jnp.float32)
    temb = TorchEmbedder(max_length=256, device="cpu")
    # the JAX embedder's parameters, carried across
    state = thf.params_from_jax(jax_tree(jemb.params))
    for name, value in temb.model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[name].numpy())
    payload, st = ingest.measure(n, batch, embedder=temb, device="cpu",
                                 log=lambda _m: None)
    texts = synth_texts(n)
    jstore = TpuVectorStore(jemb, index=JFlat(jemb.dim, dtype=jnp.bfloat16))
    jstore.index._grow_to(n)
    jstore.add_texts(texts[:batch], ids=[f"w{i}" for i in range(batch)])
    for s in range(batch, n, batch):
        jstore.add_texts(texts[s:s + batch],
                         ids=[f"c{i}" for i in range(s, s + batch)])
    want = jstore.hybrid_search("term1 term2", k=5)
    assert payload["index_rows"] == jstore.count() == n
    assert payload["bm25_docs"] == jstore.bm25.n_docs == n
    assert payload["ingested"] == n - batch
    assert_same_hits([(d.page_content, s) for d, s in st["hits"]],
                     [(d.page_content, s) for d, s in want])


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


# ----------------------------------------------------------- bench_encoder
def test_model_flops_are_the_jax_scripts():
    from archi_tpu.models.bert import BertConfig as JConfig
    from scripts.torch_bench_encoder import config_of, model_flops

    jax_flops = _jax_function("bench_encoder.py", "model_flops",
                              {"BertConfig": JConfig})
    for model, jcfg in (("minilm", JConfig.minilm_l6()),
                        ("bge-small", JConfig.bge_small()),
                        ("bge-base", JConfig.bge_base())):
        for b, s in ((256, 256), (8, 64)):
            assert model_flops(config_of(model), b, s) == \
                jax_flops(jcfg, b, s)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_attention_impl_matches_jax_xla(impl):
    from archi_tpu.models import bert as jbert
    from archi_tpu_torch.models import bert as tbert
    from archi_tpu_torch.models import hf_loader as thf

    kw = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position_embeddings=128)
    jcfg, tcfg = jbert.BertConfig(**kw), tbert.BertConfig(**kw)
    tree = jax_tree(jbert.init_params(jcfg, seed=4))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (3, 24)).astype(np.int32)
    mask = np.ones((3, 24), np.int32)
    mask[1, 10:] = 0
    want = np.asarray(jbert.encode(tree, ids, mask, jcfg,
                                   attention_impl="xla"))
    want_tok = np.asarray(jbert.encode_tokens(tree, ids, mask, jcfg,
                                              attention_impl="xla"))
    model = tbert.BertEncoder.from_state(tcfg, thf.params_from_jax(tree),
                                         device="cpu")
    ti, tm = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    got = tbert.encode(model, ti, tm, attention_impl=impl).numpy()
    got_tok = tbert.encode_tokens(model, ti, tm, attention_impl=impl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_tok, want_tok, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="attention_impl"):
        tbert.encode(model, ti, tm, attention_impl="pallas")


def test_bench_encoder_runs_both_routes():
    from scripts import torch_bench_encoder as enc

    payload, st = enc.measure(2, 16, 1, "minilm", device="cpu",
                              log=lambda _m: None)
    assert list(payload["routes"]) == ["plain", "kernel"]
    assert payload["matmul_flops"] == enc.model_flops(enc.config_of(
        "minilm"), 2, 16)
    for route in payload["routes"].values():
        assert route["ms_per_batch"] > 0 and route["matmul_tflops"] > 0
    # on the CPU both routes are the plain attention: one output
    np.testing.assert_array_equal(st["outputs"]["plain"].numpy(),
                                  st["outputs"]["kernel"].numpy())
    assert st["outputs"]["plain"].shape == (2, 384)


# ------------------------------------------- run_quality and exp_encoder
def _timeless(section):
    return {k: v for k, v in section.items()
            if k not in ("query_qps", "avg_time_per_question_s", "wall_s",
                         "embedder")}


def test_run_quality_hash_section_matches_jax(tmp_path, monkeypatch):
    from archi_tpu.models.hashed_embedder import \
        HashedNgramEmbedder as JaxHashed
    from scripts import run_quality as jq
    from scripts import torch_run_quality as tq

    out = tmp_path / "quality.json"
    payload = tq.run(str(out), encoder="hash", out_dir=str(tmp_path / "res"),
                     device="cpu", log=lambda _m: None)
    assert json.loads(out.read_text()) == payload
    assert (tmp_path / "res" / "results.json").exists()
    assert set(_payload_keys("run_quality.py")) <= set(payload)
    assert list(payload["hash"]) == _payload_keys("run_quality.py",
                                                  "run_section", None)
    monkeypatch.chdir(tmp_path)         # the JAX harness writes ./benchmark_results
    want = jq.run_section(JaxHashed(), "hash")
    assert _timeless(payload["hash"]) == _timeless(want)
    assert payload["source_accuracy"] == want["source_accuracy"]
    assert payload["recall_at_10"] == want["recall_at_10"]


def test_exp_encoder_hash_only_matches_jax(tmp_path):
    from archi_tpu.engine.vectorstore import TpuVectorStore
    from archi_tpu.models.hashed_embedder import \
        HashedNgramEmbedder as JaxHashed
    from scripts import exp_encoder as je
    from scripts import torch_exp_encoder as te

    log_path = tmp_path / "experiments.jsonl"
    res = te.run(hash_only=True, log_path=str(log_path), device="cpu",
                 log=lambda _m: None)
    assert json.loads(log_path.read_text()) == res
    texts, metas, ids = je.fixture_chunks()
    store = TpuVectorStore(JaxHashed())
    store.add_texts(texts, metas, ids=ids)
    from archi_tpu.benchmarking.fixture import (fixture_corpus,
                                                fixture_hard_queries,
                                                fixture_synonym_queries)
    want = {"tag": "hash", "main": je.ablate(store, fixture_corpus()[1]),
            "hard": je.ablate(store, fixture_hard_queries()),
            "synonym": je.ablate(store, fixture_synonym_queries())}
    assert {k: v for k, v in res.items() if k != "device"} == want


def test_exp_encoder_trains_and_scores(tmp_path):
    from scripts import torch_exp_encoder as te

    losses = []
    res = te.run("tiny", train_kw={"batch": 8, "seq_len": 32, "seed": 0,
                                   "steps": 3, "hidden": 32, "layers": 1},
                 log_path=None, model_dir=str(tmp_path / "enc"),
                 device="cpu", log=lambda _m: None, losses=losses)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert {"tag", "train_kw", "train_s", "main", "hard", "synonym"} \
        <= set(res)
    assert (tmp_path / "enc" / "config.json").exists()
    for family in ("main", "hard", "synonym"):
        assert set(res[family]) == {"hybrid", "semantic_only"}


def test_run_quality_trained_section(tmp_path):
    from scripts import torch_run_quality as tq

    losses = []
    payload = tq.run(None, encoder="trained", model_dir=str(tmp_path / "m"),
                     steps=3, train_kw={"batch": 8, "seq_len": 32,
                                        "seed": 0, "hidden": 32,
                                        "layers": 1},
                     out_dir=str(tmp_path / "res"), device="cpu",
                     log=lambda _m: None, losses=losses)
    assert len(losses) == 3
    assert list(payload["trained"]) == _payload_keys("run_quality.py",
                                                     "run_section", None)
    assert payload["source_accuracy"] == \
        payload["trained"]["source_accuracy"]
    assert payload["trained"]["chunks"] == 490


# ----------------------------------------------------------- bench_serving
def test_serving_batch_fn_matches_jax_topk():
    from archi_tpu.engine.topk import topk_scores as jax_topk
    from scripts.torch_bench_serving import make_run_batch

    rng = np.random.default_rng(7)
    n, d = 4096, 384
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus_t = torch.from_numpy(corpus).to(torch.bfloat16)
    corpus_j = jnp.asarray(corpus_t.float().numpy()).astype(jnp.bfloat16)
    q = rng.standard_normal((5, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sizes = []
    got = make_run_batch(corpus_t, batch_sizes=sizes)(None, list(q))
    assert sizes == [5] and len(got) == 5
    qp = np.concatenate([q, np.zeros((3, d), np.float32)])   # pow2 bucket
    wv, wr = jax_topk(jnp.asarray(qp), corpus_j, jnp.zeros((n,), jnp.float32),
                      jnp.asarray(n, jnp.int32), k=10, impl="xla")
    assert_same_topk(np.stack([v for v, _r in got]),
                     np.stack([r for _v, r in got]),
                     np.asarray(wv)[:5], np.asarray(wr)[:5])


@pytest.mark.parametrize("in_process", [False, True])
def test_serving_answers_equal_a_direct_scan(in_process):
    from archi_tpu_torch.engine.topk import topk_scores
    from scripts import torch_bench_serving as serving

    results, st = serving.measure(clients=8, per_client=4, batches=(4, 8),
                                  in_process=in_process, rows=4096,
                                  sample=8, device="cpu",
                                  log=lambda _m: None)
    mode = "in_process" if in_process else "dispatch"
    assert set(_payload_keys("bench_serving.py", target="results")) \
        <= set(results)
    entry_fn = "run_in_process" if in_process else "run_once"
    for e in results["sweep"]:
        if e.get("mode") == "scheduler_only_noop":
            assert set(e) == set(_payload_keys(
                "bench_serving.py", "run_scheduler_only", "entry"))
        else:
            assert set(_payload_keys("bench_serving.py", entry_fn,
                                     "entry")) <= set(e)
            assert e["n_batches"] >= 32 // e["max_batch"]
    assert ("relay_rtt_ms" if in_process else "unbatched_qps") in results
    corpus, queries = st["corpus"], st["queries"]
    bias = torch.zeros((corpus.shape[0],))
    for mbs in (4, 8):
        got = st["answers"][(mode, mbs)]
        assert len(got) == 8
        for gi, (vals, rows) in got.items():
            wv, wr = topk_scores(torch.from_numpy(queries[gi][None]), corpus,
                                 bias, corpus.shape[0], k=10)
            assert_same_topk(np.asarray(vals)[None], np.asarray(rows)[None],
                             wv.numpy(), wr.numpy())


def test_serving_http_answers_match_jax(tmp_path):
    from archi_tpu.engine.vectorstore import TpuVectorStore
    from archi_tpu.models.hashed_embedder import \
        HashedNgramEmbedder as JaxHashed
    from scripts import torch_bench_serving_http as http_bench
    from scripts.bench_serving_http import synth_chunks

    out = tmp_path / "serving_http.json"
    result, st = http_bench.measure(str(out), clients=4, per_client=4,
                                    n_chunks=300, sample=8, device="cpu",
                                    data_path=str(tmp_path / "data"),
                                    log=lambda _m: None)
    assert json.loads(out.read_text()) == result
    assert set(_payload_keys("bench_serving_http.py", target="result")) \
        <= set(result)
    wave_keys = _payload_keys("bench_serving_http.py", "run_wave", None)
    for wave in ("noop_http", "hybrid_end_to_end", "hybrid_micro_batched"):
        assert list(result[wave]) == wave_keys
        assert result[wave]["requests"] == 16
    assert http_bench.synth_chunks(300) == synth_chunks(300)
    texts = synth_chunks(300)
    jstore = TpuVectorStore(JaxHashed())
    jstore.add_texts(texts, [{"source": f"doc{j}"} for j in range(300)],
                     ids=[f"c{j}" for j in range(300)])
    for wave in ("hybrid_end_to_end", "hybrid_micro_batched"):
        assert len(st["answers"][wave]) == 8
        for qi, body in st["answers"][wave].items():
            want = jstore.hybrid_search(st["queries"][qi], k=5)
            assert_same_hits(
                [(h["metadata"]["source"], h["score"]) for h in body],
                [(d.metadata["source"], s) for d, s in want])


# ------------------------------------------------------------- ann_builder
def _builder(corpus, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_ann_builder.py"),
         "--corpus", corpus, *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out


def _unit_rows(seed=0, n=500, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return rng, x / np.linalg.norm(x, axis=1, keepdims=True)


def test_ann_builder_out_of_process_adopt(tmp_path):
    """The port's serving index exports, the builder builds in another
    process on the CPU, the index adopts, searches, and refuses the export
    after a compaction."""
    from archi_tpu_torch.engine.ann_index import AnnFlatIndex

    idx = AnnFlatIndex(32, nlist=8, nprobe=8, min_snapshot_rows=16,
                       async_refresh=False, dtype=torch.float32,
                       device="cpu")
    rng, x = _unit_rows()
    idx.add(x, ids=list(range(500)))
    assert idx._ivf is None
    corpus = str(tmp_path / "corpus.npz")
    idx.export_corpus(corpus)
    out = _builder(corpus, "--nlist", "8", "--device", "cpu")
    assert "on cpu" in out.stdout
    assert json.loads(pathlib.Path(corpus + ".ann.json").read_text()) == \
        {"n_snap": 500, "kind": "ivf"}
    assert idx.adopt_snapshot(corpus)
    assert idx._ivf is not None and idx._n_snap == 500
    q = x[:4] + 0.01 * rng.standard_normal((4, 32)).astype(np.float32)
    _ids, _vals, rows = idx.search(q, k=5)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :5]
    assert np.array_equal(np.asarray(rows)[:, 0], exact[:, 0])
    idx.delete([0, 1])
    idx.compact()
    assert not idx.adopt_snapshot(corpus)


def test_ann_builder_builds_a_jax_export_for_the_jax_index(tmp_path):
    """The npz layout is shared: a JAX export, the port's IVF-PQ builder
    (``--platform`` as the alias of ``--device``), the JAX index adopts."""
    from archi_tpu.engine.ann_index import AnnFlatIndex as JAnn

    idx = JAnn(32, nlist=8, nprobe=8, min_snapshot_rows=16,
               async_refresh=False, dtype=np.float32, snapshot_kind="ivfpq",
               pq_m=8, pq_refine_m=8)
    rng, x = _unit_rows(1)
    idx.add(x, ids=list(range(500)))
    corpus = str(tmp_path / "jax_corpus.npz")
    idx.export_corpus(corpus)
    _builder(corpus, "--nlist", "8", "--pq-m", "8", "--pq-refine-m", "8",
             "--platform", "cpu")
    assert json.loads(pathlib.Path(corpus + ".ann.json").read_text())[
        "kind"] == "ivfpq"
    assert idx.adopt_snapshot(corpus)
    assert idx._ivf is not None and idx._n_snap == 500
    q = x[:4] + 0.01 * rng.standard_normal((4, 32)).astype(np.float32)
    _ids, _vals, rows = idx.search(q, k=5)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :5]
    assert np.array_equal(np.asarray(rows)[:, 0], exact[:, 0])


# -------------------------------------------------------- diag_cfg4_misses
BLOCK_ROWS, N_BLOCKS = 4096, 4


@pytest.fixture(scope="module")
def plane_and_index(tmp_path_factory):
    """Four blocks of 4,096 synthetic rows filled by the fill script, and
    config 4's index over them (cut to nlist 32, block 128), saved."""
    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from scripts import torch_fill_host_store as fill

    d = tmp_path_factory.mktemp("diag")
    path = str(d / "config4.bf16")
    fill.fill(path, blocks=N_BLOCKS, block_rows=BLOCK_ROWS, device="cpu",
              log=lambda _m: None)
    block_fn = make_block_fn(0, N_BLOCKS, block_rows=BLOCK_ROWS,
                             device="cpu")
    idx = IVFPQIndex.build_streaming(
        block_fn, N_BLOCKS, BLOCK_ROWS, nlist=32, block=128, m=96, ksub=16,
        refine_m=96, train_blocks=2, train_sample=1 << 21, coarse_iters=8,
        pq_iters=10, seed=0, spill_frac=0.15, opq_iters=2, device="cpu")
    idx.ensure_block_centroids(dtype=torch.bfloat16)
    idx.save(str(d / "index"))
    return path, str(d / "index")


def _jax_miss_rule(state):
    """The JAX script's classification, run from its own lines over the
    port's ground truth, candidates and rerank."""
    from archi_tpu.engine.host_store import mark_duplicate_rows

    src = _source("diag_cfg4_misses.py").splitlines()
    start = next(i for i, line in enumerate(src)
                 if line.strip() == "per_query = []")
    end = next(i for i in range(start, len(src))
               if src[i].strip().startswith("strict = 1.0"))
    store, q = state["store"], state["q"]

    def host_score(b, row):
        vec = np.asarray(store.get(np.array([row]))[0], np.float32)
        return float(vec @ q[b])

    ns = {"np": np, "B": 32, "K": 10, "gt_rows": state["gt_rows"],
          "gt_vals": state["gt_vals"], "fr": state["fr"], "fv": state["fv"],
          "cand_rows": state["cand_rows"], "host_score": host_score,
          "mark_duplicate_rows": mark_duplicate_rows}
    exec(textwrap.dedent("\n".join(src[start:end + 1])), ns)
    return ns


@pytest.mark.parametrize("held", [False, True], ids=["loaded", "held"])
@pytest.mark.parametrize("probe,rerank_c", [(8, 20), (24, 40)])
def test_diag_classifies_misses_as_the_jax_rule(plane_and_index, tmp_path,
                                                probe, rerank_c, held):
    """From the saved index, or from one the caller holds (``index=``)."""
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from scripts import torch_diag_cfg4_misses as diag

    plane, index = plane_and_index
    out = tmp_path / "diag.json"
    kw = ({"index": IVFPQIndex.load(index, device="cpu")} if held
          else {"index_path": index})
    payload, state = diag.measure(
        str(out), rows=N_BLOCKS * BLOCK_ROWS, block_rows=BLOCK_ROWS,
        store_path=plane, probe=probe, rerank_c=rerank_c, device="cpu",
        log=lambda _m: None, **kw)
    assert json.loads(out.read_text()) == payload
    assert list(payload)[:-1] == _payload_keys("diag_cfg4_misses.py")
    want = _jax_miss_rule(state)
    assert payload["strict_at_10"] == round(want["strict"], 4)
    assert payload["n_missed"] == want["n_miss"]
    assert payload["n_missed_in_candidate_set"] == want["n_in_cand"]
    assert payload["misses"] == want["per_query"]
    assert payload["n_missed"] == payload["n_missed_in_candidate_set"] + \
        payload["n_missed_geometry"]
    # the ground truth is the exact scan of the plane's rows at k + 1, the
    # queries rounded to bf16 as the top-k kernel rounds them
    store = state["store"]
    qb = torch.from_numpy(state["q"]).bfloat16().float().numpy()
    scores = store.get(np.arange(len(store))) @ qb.T
    order = np.argsort(-scores, axis=0, kind="stable")[:11].T
    assert_same_topk(state["gt_vals"], state["gt_rows"],
                     np.take_along_axis(scores.T, order, axis=1), order)


def test_diag_refuses_a_plane_of_another_size(plane_and_index):
    from scripts import torch_diag_cfg4_misses as diag

    plane, index = plane_and_index
    with pytest.raises(ValueError, match="holds"):
        diag.measure(None, rows=8 * BLOCK_ROWS, block_rows=BLOCK_ROWS,
                     index_path=index, store_path=plane, device="cpu",
                     log=lambda _m: None)


# --------------------------------------------------- bench_attention_refold
def _f64_layer(x, w, nh):
    """One attention layer in f64 (numpy), no rounding anywhere."""
    x = x.astype(np.float64)
    b, s, h = x.shape
    hd = h // nh

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(0, 2, 1, 3)

    q, k, v = (heads(x @ w[n].astype(np.float64)) for n in ("wq", "wk",
                                                            "wv"))
    lg = q @ k.transpose(0, 1, 3, 2) / math.sqrt(hd)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ctx = (p @ v).transpose(0, 2, 1, 3).reshape(b, s, h)
    return ctx @ w["wo"].astype(np.float64)


def test_refold_forms_match_an_f64_layer():
    from scripts import torch_bench_attention_refold as refold

    payload, st = refold.measure(2, 64, 384, 12, steps=1, trials=1,
                                 k_scan=2, device="cpu", log=lambda _m: None)
    assert list(payload) == ["shape", "variants", "device"]
    assert set(payload["variants"]) == {
        "baseline_xla", "folded_bigK", "int8_dots", "qk_dots_smallK",
        "qk_dots_foldedK384"}
    assert payload["shape"] == "B2 S64 H384 nh12 hd32"
    w = {k: v.float().numpy() for k, v in st["w"].items()}
    want = torch.from_numpy(_f64_layer(st["x"].float().numpy(), w, 12))
    out = st["outputs"]
    # bf16 forms: within a bf16 step of the f64 layer (relative, all
    # elements); int8: within the script's int8 bar
    assert refold.rel_err(out["baseline_xla"], want) <= 2.0 ** -7
    assert refold.rel_err(out["folded_bigK"], want) <= 2.0 ** -7
    assert refold.rel_err(out["int8_dots"], want) <= refold.INT8_TOL
    assert refold.rel_err(out["folded_bigK"], out["baseline_xla"]) <= \
        refold.BF16_TOL
    assert refold.rel_err(out["int8_dots"], out["baseline_xla"]) <= \
        refold.INT8_TOL


def test_refold_int8_dots_are_exact_integer_products():
    from scripts.torch_bench_attention_refold import int8_dots, quantize

    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((3, 32, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 24, 16)).astype(np.float32))
    ai, sa = quantize(a)
    bi, sb = quantize(b)
    assert ai.dtype == torch.int8 and int(ai.abs().max()) == 127
    np.testing.assert_allclose(sa.numpy().ravel(),
                               np.abs(a.numpy()).max(axis=(1, 2)) / 127.0,
                               rtol=1e-6)
    got = int8_dots(ai, bi)
    want = ai.numpy().astype(np.int64) @ bi.numpy().astype(
        np.int64).transpose(0, 2, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_refold_scans_are_serially_dependent():
    """Each step's product reads the carry the step before wrote: the scans
    equal a float64 numpy recurrence (rtol 1e-5) at 1 and 3 steps, and 3
    steps end elsewhere than 1.  Positive inputs keep tanh of the logits
    near its mean, so each step's 1e-6 increment shows in the f32 sum."""
    from scripts.torch_bench_attention_refold import scan_big, scan_small

    rng = np.random.default_rng(3)
    q = 1.0 + np.abs(rng.standard_normal((1, 2, 8, 16)))
    k = 0.01 + 0.01 * np.abs(rng.standard_normal((1, 2, 8, 16)))
    y = 1.0 + np.abs(rng.standard_normal((1, 2, 8, 16)))
    x = 0.01 + 0.01 * np.abs(rng.standard_normal((1, 8, 16)))

    def ref_small(q, k, steps):
        for _ in range(steps):
            k = k + np.tanh(q @ k.transpose(0, 1, 3, 2)).mean(
                axis=2)[..., None] * 1e-6
        return k[0, 0, 0].sum()

    def ref_big(y, x, steps):
        for _ in range(steps):
            x = x + np.tanh(y @ x[:, None].transpose(0, 1, 3, 2)).mean(
                axis=(1, 2))[..., None] * 1e-6
        return x[0, 0].sum()

    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    for scan, ref, args in ((scan_small, ref_small, (q, k)),
                            (scan_big, ref_big, (y, x))):
        got = {n: float(scan(*map(t, args), n)) for n in (1, 3)}
        want = {n: ref(*args, n) for n in (1, 3)}
        for n in (1, 3):
            np.testing.assert_allclose(got[n], want[n], rtol=1e-5)
        assert want[3] - want[1] > 1e-5
        np.testing.assert_allclose(got[3] - got[1], want[3] - want[1],
                                   rtol=1e-2)


# ----------------------------------------------------------- shell scripts
def _sh_runs(shell_script):
    """(script, [--flags]) of every python run in a shell script."""
    text = (ROOT / "scripts" / shell_script).read_text().replace("\\\n", " ")
    runs = []
    for line in text.splitlines():
        m = re.search(r"scripts/(\w+\.py)(.*)", line)
        if m and not line.lstrip().startswith("#"):
            runs.append((m.group(1), re.findall(r"(?<!\S)--[a-z][a-z0-9-]*",
                                                m.group(2))))
    return runs


@pytest.mark.parametrize("jax_sh,port_sh", [
    ("ablation_cfg4_probe.sh", "torch_ablation_cfg4_probe.sh"),
    ("ablation_cfg4_probe2.sh", "torch_ablation_cfg4_probe2.sh")])
def test_ablation_scripts_run_the_jax_runs_on_the_torch_scripts(
        jax_sh, port_sh):
    jax_runs, port_runs = _sh_runs(jax_sh), _sh_runs(port_sh)
    assert len(port_runs) == len(jax_runs) > 0
    for (jscript, jflags), (pscript, pflags) in zip(jax_runs, port_runs):
        assert pscript == "torch_" + jscript
        assert pflags == jflags
        assert set(pflags) <= _flags(_source(pscript)), pscript
    text = (ROOT / "scripts" / port_sh).read_text()
    code = "\n".join(line for line in text.splitlines()
                     if not line.startswith("#"))
    assert "benchmark_results" not in code
    assert not re.search(r"^cd /", code, flags=re.M)   # its own checkout
    # the sweeps the JAX script runs, spec for spec
    specs = re.findall(r"--rerank-sweep (\S+)",
                       (ROOT / "scripts" / jax_sh).read_text())
    assert specs == re.findall(r"--rerank-sweep (\S+)", text)


def test_smoke_script_uses_the_ports_cli():
    from archi_tpu_torch.cli.cli_main import cli

    text = (ROOT / "scripts" / "torch_smoke.sh").read_text()
    jax_text = (ROOT / "scripts" / "smoke.sh").read_text()
    calls = re.findall(r"-m (\S+) (create|delete)((?: -[a-z] \S+)+)", text)
    assert {(m, c) for m, c, _a in calls} == {
        ("archi_tpu_torch.cli.cli_main", "create"),
        ("archi_tpu_torch.cli.cli_main", "delete")}
    for _m, command, args in calls:
        opts = {o for p in cli.commands[command].params for o in p.opts}
        assert set(re.findall(r"-[a-z]", args)) <= opts, command
    # the same requests as the JAX script, through urllib instead of curl
    for path in ("/api/ingestion/status", "/healthz",
                 "/api/get_chat_response", "/api/stats"):
        assert path in text and path in jax_text
    assert "curl" not in "\n".join(line for line in text.splitlines()
                                   if not line.lstrip().startswith("#"))
    assert "SMOKE PASSED" in text
